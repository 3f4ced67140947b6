"""The benchmark's files, found by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; each lives in a file of
its own (``configs/<config>.json``, ``traffic/<mix>.json``), and so does
every piece of code that belongs to one configuration or one metric
(``drivers/<entry>.py``, ``clients/<client>.py``,
``reference/<config>.py``, ``metrics/<metric>.py``).  Adding a cell,
configuration or metric adds files and entries; it edits none.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

#: the benchmark's folder and the checkout's root
HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                   + ", ".join(w["name"] for w in bench["workloads"]))


def config(bench: dict, name: str) -> dict:
    """The configuration's file, with its program's source read in
    (``program`` inline, or ``program_file`` beside the file) and its
    parameters (``params``: a list, or ``"in_order"``: every ``$name`` of
    the source in order of first appearance)."""
    for c in bench["configs"]:
        if c["name"] == name:
            cfg = load_json(ROOT / c["file"])
            break
    else:
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")
    if "program_file" in cfg:
        cfg["program"] = (HERE / "configs" / cfg["program_file"]).read_text()
    if cfg.get("params") == "in_order":
        cfg["params"] = list(dict.fromkeys(
            re.findall(r"\$([A-Za-z_][A-Za-z0-9_]*)", cfg["program"])))
    return cfg


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def module(kind: str, name: str):
    """``<kind>/<name>.py`` of the benchmark's folder, imported under a
    private name (a metric's name may hold dots)."""
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"{path} (the {kind[:-1]} {name!r})")
    mod_name = "_bench_%s_%s" % (kind, re.sub(r"\W", "_", name))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _covers(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def cell_metrics(bench: dict, cell_name: str) -> tuple[list, list]:
    """The end-to-end metrics this cell reports and the per-layer ones (a
    metric with no ``workloads`` is reported in every cell)."""
    return ([m for m in bench["end_to_end"] if _covers(m, cell_name)],
            [m for m in bench["per_layer"] if _covers(m, cell_name)])

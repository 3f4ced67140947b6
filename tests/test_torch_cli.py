"""The port's CLI end to end on the CPU against genfer_tpu's.

The two-population model (genfer_tpu.tools.generators, seed 0, size 200)
runs with PALLAS_OFFLOAD_FLOPS at 1e4, so that its larger 2-axis products
take the f32 route: through the port's ``run(..., device="cpu")`` and
through genfer_tpu's ``PallasBackend`` in Pallas interpret mode.  The JAX
run calls ``genfer_tpu.cli.run`` on the test's own thread: ``cli.main``
runs on a thread of its own, which the interpret-mode context does not
reach.  Z, the moments and every normalized p(k)/Z >= 1e-6 must agree at
rel 1e-5 (f32 products, ~1e-7 each); the "p(n) <= ..." tail bounds are
left out, being differences of nearly equal sums.
"""

import contextlib
import io
import subprocess
import sys
from pathlib import Path

import pytest
from jax.experimental.pallas import tpu as pltpu

import genfer_tpu.cli as jcli
import genfer_tpu.tools.generators as jgen
from chip_smoke import read_results
from genfer_tpu.lang.parser import parse_program
from genfer_tpu.taylor import backend as J
from genfer_tpu.tools.generators import generate_two_populations
from genfer_tpu_torch import cli
from genfer_tpu_torch.taylor import backend as T
from genfer_tpu_torch.tools import generators as tgen

REPO = Path(__file__).resolve().parent.parent
SIZE = 200
RTOL = 1e-5
P_MIN = 1e-6


@pytest.fixture
def program():
    return parse_program(generate_two_populations(None, SIZE, seed=0))


def _args(backend, *extra):
    return cli.build_arg_parser().parse_args(
        ["model.sgcl", "--no-timing", "--backend", backend, *extra]
    )


def _printed(fn, *args, **kwargs):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(*args, **kwargs)
    return buf.getvalue(), ret


def _assert_agree(got_text, want_text):
    got, want = read_results(got_text), read_results(want_text)
    assert set(got) == set(want)
    assert {"Z", "E", "σ"} <= set(got)
    compared = 0
    for key, w in want.items():
        if key.endswith("/ Z") and w < P_MIN:
            continue
        assert got[key] == pytest.approx(w, rel=RTOL), key
        compared += 1
    assert compared > 3


@pytest.fixture
def low_threshold(monkeypatch):
    monkeypatch.setattr(J.PallasBackend, "PALLAS_OFFLOAD_FLOPS", 10_000)
    monkeypatch.setattr(T.PallasBackend, "PALLAS_OFFLOAD_FLOPS", 10_000)


def test_pallas_run_matches_jax_pallas(program, low_threshold):
    port, backend = _printed(cli.run, program, _args("pallas"), device="cpu")
    assert isinstance(backend, T.PallasBackend)
    assert backend.device_ops > 0
    with pltpu.force_tpu_interpret_mode():
        ref, _ = _printed(jcli.run, program, _args("pallas"))
    _assert_agree(port, ref)


def test_pallas_run_matches_host_f64(program, low_threshold):
    port, backend = _printed(cli.run, program, _args("pallas"), device="cpu")
    assert backend.device_ops > 0
    ref, _ = _printed(jcli.run, program, _args("numpy"))
    _assert_agree(port, ref)


@pytest.mark.parametrize("backend", ["numpy", "object"])
def test_host_backends_print_what_genfer_tpu_prints(program, backend):
    port, _ = _printed(cli.run, program, _args(backend))
    ref, _ = _printed(jcli.run, program, _args(backend))
    assert port == ref


def test_main_reads_the_file(tmp_path):
    path = tmp_path / "two_populations.sgcl"
    generate_two_populations(path, 20, seed=0)
    argv = [str(path), "--no-timing", "--backend", "numpy"]
    port, _ = _printed(cli.main, argv)
    ref, _ = _printed(jcli.main, argv)
    assert port == ref and "Total measure" in port


@pytest.mark.parametrize("extra,what", [
    (["--backend", "jax"], "--backend jax"),
    (["--backend", "sharded"], "--backend sharded"),
    (["--compile-scan"], "--compile-scan"),
    (["--debug-nans"], "--debug-nans"),
    (["--profile", "trace_dir"], "--profile"),
])
def test_unported_options_raise(program, extra, what):
    args = cli.build_arg_parser().parse_args(["model.sgcl", *extra])
    with pytest.raises(NotImplementedError, match=what):
        cli.run(program, args, device="cpu")


def test_read_results_keeps_points_and_drops_bounds():
    text = (
        "Total measure:             Z = 0.5\n"
        "Standard deviation:        σ = 2.0\n"
        "Unnormalized: p(0)     = 0.25\n"
        "Normalized:   p(0) / Z = 0.5\n"
        "p(1) = 0.125\n"
        "Unnormalized: p(n)     <= 0.1 for all n >= 2\n"
        "Normalized:   p(n) / Z <= 0.2 for all n >= 2\n"
        "Time to compute moments: 0.1s\n"
    )
    assert read_results(text) == {
        "Z": 0.5, "σ": 2.0, "p(0) / Z": 0.5, "p(1)": 0.125,
    }


@pytest.mark.parametrize("make", [
    lambda g: g.generate_two_populations(None, 50, seed=3),
    lambda g: g.generate_population(None, 50, 2, modified=True, seed=3),
    lambda g: g.generate_hmm(None, 5, seed=3),
])
def test_generators_are_genfer_tpus(make):
    assert make(tgen) == make(jgen)


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import genfer_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) >= 7, mods\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr

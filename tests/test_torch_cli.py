"""The port's CLI end to end on the CPU against genfer_tpu's.

The two-population model (genfer_tpu.tools.generators, seed 0, size 200)
runs with PALLAS_OFFLOAD_FLOPS at 1e4, so that its larger 2-axis products
take the f32 route: through the port's ``run(..., device="cpu")`` and
through genfer_tpu's ``PallasBackend`` in Pallas interpret mode.  Each
package parses the program text with its own parser.  The JAX run calls
``genfer_tpu.cli.run`` on the test's own thread: ``cli.main`` runs on a
thread of its own, which the interpret-mode context does not reach.  Z,
the moments and every normalized p(k)/Z >= 1e-6 must agree at rel 1e-5
(f32 products, ~1e-7 each); the "p(n) <= ..." tail bounds are left out,
being differences of nearly equal sums.

The host backends (``numpy``, ``object``) print byte for byte what
genfer_tpu prints.  The port owns its copies of every layer it runs and of
the native C++ extensions; the subprocess tests check that importing all
of it and running an inference loads neither jax nor genfer_tpu.
"""

import ast
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
from genfer_tpu.lang.parser import parse_program as jparse
from genfer_tpu.taylor import backend as J
from genfer_tpu.tools.generators import generate_two_populations
from genfer_tpu_torch import cli
from genfer_tpu_torch.gf import nativeeval
from genfer_tpu_torch.lang.parser import parse_program as tparse
from genfer_tpu_torch.taylor import backend as T
from genfer_tpu_torch.taylor.host import NumpyF64Backend
from genfer_tpu_torch.tools import generators as tgen

REPO = Path(__file__).resolve().parent.parent
SIZE = 200
RTOL = 1e-5
P_MIN = 1e-6


@pytest.fixture
def program():
    """The program text; each package parses it with its own parser."""
    return generate_two_populations(None, SIZE, seed=0)


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
    port, backend = _printed(cli.run, tparse(program), _args("pallas"),
                             device="cpu")
    assert isinstance(backend, T.PallasBackend)
    assert backend.device_ops > 0
    with pltpu.force_tpu_interpret_mode():
        ref, _ = _printed(jcli.run, jparse(program), _args("pallas"))
    _assert_agree(port, ref)


def test_pallas_run_matches_host_f64(program, low_threshold):
    port, backend = _printed(cli.run, tparse(program), _args("pallas"),
                             device="cpu")
    assert backend.device_ops > 0
    ref, _ = _printed(jcli.run, jparse(program), _args("numpy"))
    _assert_agree(port, ref)


@pytest.mark.parametrize("backend", ["numpy", "object"])
def test_host_backends_print_what_genfer_tpu_prints(program, backend):
    port, _ = _printed(cli.run, tparse(program), _args(backend))
    ref, _ = _printed(jcli.run, jparse(program), _args(backend))
    assert port == ref


def test_main_reads_the_file(tmp_path):
    path = tmp_path / "two_populations.sgcl"
    generate_two_populations(path, 20, seed=0)
    argv = [str(path), "--no-timing", "--backend", "numpy"]
    port, _ = _printed(cli.main, argv)
    ref, _ = _printed(jcli.main, argv)
    assert port == ref and "Total measure" in port


@pytest.mark.parametrize("extra,what", [
    (["--backend", "sharded"], "--backend sharded"),
])
def test_unported_options_raise(program, extra, what):
    """Once unported, ``--backend sharded`` now runs: outside a process
    group the CLI forms a group of one rank (gloo on the CPU), where no
    route shards (tp = 1), and prints what ``--backend jax`` prints."""
    from genfer_tpu_torch.parallel.mesh import ShardedF64Backend, close_group

    args = cli.build_arg_parser().parse_args(
        ["model.sgcl", "--no-timing", *extra])
    try:
        port, backend = _printed(cli.run, tparse(program), args,
                                 device="cpu")
    finally:
        close_group()
    assert isinstance(backend, ShardedF64Backend), what
    assert backend.mesh.shape == {"dp": 1, "tp": 1}
    assert not any(backend.routes.values())
    jax_text, _ = _printed(cli.run, tparse(program), _args("jax"),
                           device="cpu")
    assert port == jax_text


def test_compile_scan_runs_the_scan_compiler(program):
    """``--compile-scan`` runs the scan compiler (on the CPU here) and
    prints what genfer_tpu's ``--compile-scan`` prints, at is_close."""
    from genfer_tpu_torch.scanc import ScanCompiled

    args = cli.build_arg_parser().parse_args(
        ["model.sgcl", "--no-timing", "--compile-scan"])
    port, obj = _printed(cli.run, tparse(program), args, device="cpu")
    assert isinstance(obj, ScanCompiled) and obj.device.type == "cpu"
    ref, _ = _printed(jcli.run, jparse(program), args)
    got, want = read_results(port), read_results(ref)
    assert set(got) == set(want) and {"Z", "E", "σ"} <= set(got)
    for key, w in want.items():
        assert got[key] == pytest.approx(w, rel=1e-9, abs=1e-8), key


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


GENERATED = [
    lambda g: g.generate_two_populations(None, 50, seed=3),
    lambda g: g.generate_population(None, 50, 2, modified=True, seed=3),
    lambda g: g.generate_hmm(None, 5, seed=3),
]
EXAMPLES = sorted((REPO / "examples").glob("*.sgcl"))


@pytest.mark.parametrize("make", GENERATED)
def test_generators_are_genfer_tpus(make):
    """The port's copy of the generators writes what genfer_tpu's writes."""
    assert tgen.generate_two_populations is not jgen.generate_two_populations
    assert make(tgen) == make(jgen)


@pytest.mark.parametrize("backend", ["numpy", "object"])
@pytest.mark.parametrize("source", [p.name for p in EXAMPLES]
                         + [f"generated{i}" for i in range(len(GENERATED))])
def test_cli_prints_what_genfer_tpu_prints(tmp_path, source, backend):
    """Byte for byte, through ``main`` on a file: ``examples/*.sgcl`` and
    the generated programs above.  The port's native extensions are built
    here from its copies of genfer_tpu's sources with genfer_tpu's flags;
    these programs print the same bytes with them as genfer_tpu's
    committed builds do."""
    if source.startswith("generated"):
        path = tmp_path / "model.sgcl"
        path.write_text(GENERATED[int(source[len("generated"):])](jgen))
    else:
        path = REPO / "examples" / source
    argv = [str(path), "--no-timing", "--backend", backend]
    port, _ = _printed(cli.main, argv)
    ref, _ = _printed(jcli.main, argv)
    assert port == ref and "Total measure" in port


def test_host_kernels_match_genfer_tpus_at_is_close():
    """The port's host kernels against genfer_tpu's.  They agree to the
    last bit where both were built alike; genfer_tpu's committed
    ``_seriesops`` was built with ``-march=native`` on another CPU (it uses
    AVX-512 registers throughout), and its ``exp_1d`` differs from the
    same source built here by up to 4e-16 relative.  So the kernels are
    held at the reference's is_close (rel 1e-9 / abs 1e-8, BASELINE.md)."""
    import numpy as np

    rng = np.random.default_rng(11)
    x, y = rng.random((40, 30)), rng.random((35, 25))
    y[0, 0] = 1.5
    v = rng.random((1, 50))
    v[0, 0] = 1.0
    tb, jb = NumpyF64Backend(), J.NumpyF64Backend()
    assert tb.native is not None
    for op, args, out in [
        ("conv_trunc", (x, y), (60, 50)),
        ("poly_div", (x, y), (40, 30)),
        ("poly_exp", (v,), (1, 50)),
        ("poly_log", (v,), (1, 50)),
    ]:
        np.testing.assert_allclose(getattr(tb, op)(*args, out),
                                   getattr(jb, op)(*args, out),
                                   rtol=1e-9, atol=1e-8, err_msg=op)


@pytest.mark.parametrize("name", ["numpy", "hybrid", "pallas"])
def test_offload_backends_take_the_tape(monkeypatch, program, name):
    """``native_eval_enabled`` names the port's own classes, so its
    offload backends run the C++ eval tape under genfer_tpu's rule; with
    ``GENFER_NATIVE_EVAL=check`` every tape result is cross-checked
    against the Python engine, and the printed output equals a run with
    the tape off."""
    checked = []
    cross_check = nativeeval._cross_check
    monkeypatch.setattr(nativeeval, "_cross_check",
                        lambda a, b: checked.append(1) or cross_check(a, b))
    monkeypatch.setenv("GENFER_NATIVE_EVAL", "check")
    args = _args(name)
    out, backend = _printed(cli.run, tparse(program), args, device="cpu")
    assert nativeeval.native_eval_enabled(backend)
    assert checked
    monkeypatch.setenv("GENFER_NATIVE_EVAL", "0")
    off, _ = _printed(cli.run, tparse(program), args, device="cpu")
    assert out == off


def test_native_eval_gate_names_the_ports_classes():
    assert nativeeval._evaltape is not None
    for backend in (NumpyF64Backend(), T.HybridBackend(device="cpu"),
                    T.PallasBackend(device="cpu")):
        assert nativeeval.native_eval_enabled(backend)
    assert not nativeeval.native_eval_enabled(J.NumpyF64Backend())


def test_port_never_imports_jax(tmp_path):
    """Every module of the port imported (the f64 device path's namespace,
    K1's wrapper, the ``entry()`` twin, compiled serving, ``api``, the
    models, the scan compiler, the ozaki route, the tools and the golden
    comparison among them), one K5
    product's plain version, one compiled program, one
    model, one scan compile and one ``api.compile_serving`` run on the
    CPU, then one CLI inference run on the host path, one with
    ``--backend jax`` and one with ``--backend sharded`` (the mesh layer,
    on a group of one gloo rank), in a fresh interpreter: neither jax nor
    genfer_tpu (nor any module of it) is loaded."""
    path = tmp_path / "model.sgcl"
    generate_two_populations(path, 20, seed=0)
    code = (
        "import importlib, pkgutil, sys\n"
        "import genfer_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "assert len(mods) >= 28, mods\n"
        "for m in ('taylor.xp', 'ops.conv2d_f64', 'entry', 'compile', "
        "'api', 'models', 'models.population', 'models.hmm', 'scanc', "
        "'ops.ozaki_conv', 'ops.blocked_conv', 'tools.stats', "
        "'tools.translate', 'tools.baselines', 'golden', 'parallel', "
        "'parallel.mesh'):\n"
        "    assert 'genfer_tpu_torch.' + m in mods, m\n"
        "import torch\n"
        "from genfer_tpu_torch.ops.ozaki_conv import ozaki_conv2d\n"
        "x = torch.rand(8, 8, dtype=torch.float64)\n"
        "assert ozaki_conv2d(x, x, (8, 8)).shape == (8, 8)\n"
        "from genfer_tpu_torch.compile import compile_program\n"
        "from genfer_tpu_torch.models import CompiledPopulation\n"
        "c = compile_program('x ~ Binomial(4, $p);\\nreturn x', ['p'], 5, "
        "device='cpu')\n"
        "assert c.probs_batch([[0.5], [0.25]]).shape == (2, 5)\n"
        "CompiledPopulation(0.3, 0.2, 8, 2, device='cpu').probs([1.0], [0])\n"
        "from genfer_tpu_torch import api\n"
        "from genfer_tpu_torch.lang.parser import parse_program\n"
        "from genfer_tpu_torch.scanc import ScanCompiled, compile_scan\n"
        "src = 'x ~ Poisson(2);\\nobserve 1 ~ Binomial(x, 0.5);\\n"
        "observe 2 ~ Binomial(x, 0.5);\\nobserve 0 ~ Binomial(x, 0.5);\\n"
        "observe 1 ~ Binomial(x, 0.5);\\nreturn x'\n"
        "m, z, obj = compile_scan(parse_program(src), order=32, "
        "device='cpu')\n"
        "assert isinstance(obj, ScanCompiled) and z > 0\n"
        "served = api.compile_serving(src, order=32, device='cpu')\n"
        "assert served.run_batch([[[1, 2, 0, 1], [0, 0, 1, 1]]])[0].shape "
        "== (2, len(m))\n"
        "from genfer_tpu_torch import cli\n"
        "from genfer_tpu_torch.lang.parser import parse_program\n"
        f"cli.main([{str(path)!r}, '--no-timing'])\n"
        "args = cli.build_arg_parser().parse_args("
        f"[{str(path)!r}, '--no-timing', '--backend', 'jax'])\n"
        f"text = open({str(path)!r}).read()\n"
        "cli.run(parse_program(text), args, device='cpu')\n"
        "args = cli.build_arg_parser().parse_args("
        f"[{str(path)!r}, '--no-timing', '--backend', 'sharded'])\n"
        "cli.run(parse_program(text), args, device='cpu')\n"
        "bad = [m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'genfer_tpu.')) or m == 'genfer_tpu']\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Total measure" in proc.stdout


def test_tune_port_tree_imports_that_trees_package(tmp_path):
    """``tune_port.py --tree DIR`` times DIR's package: nothing imports
    the checkout's ``genfer_tpu_torch`` before the option is read (a
    stand-in package in DIR that exits on import shows whose runs)."""
    pkg = tmp_path / "genfer_tpu_torch"
    pkg.mkdir()
    (pkg / "__init__.py").write_text("raise SystemExit('the tree package')\n")
    proc = subprocess.run([sys.executable, "tune_port.py", "20", "--tree",
                           str(tmp_path)], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert "the tree package" in proc.stderr, proc.stderr


@pytest.mark.parametrize("script", ["chip_smoke.py", "profile_port.py",
                                    "tune_port.py",
                                    "examples/digit_serving_torch.py",
                                    "examples/switchpoint_serving_torch.py"])
def test_scripts_import_neither_jax_nor_genfer_tpu(script):
    tree = ast.parse((REPO / script).read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    roots = {n.split(".")[0] for n in names}
    assert "genfer_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "genfer_tpu"}, names

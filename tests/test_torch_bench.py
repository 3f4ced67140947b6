"""The bench twin ``python -m genfer_tpu_torch.bench``: its options on the
CPU (every section needs a card), the bound arithmetic it reports, the
scan compiler's sections, ``--scaling``'s end-to-end table and ``--suite``
(on a fake corpus against genfer_tpu's root ``bench.py``, and its in-repo
stand-in) on the CPU at small sizes, and, on the card, its sections."""

import contextlib
import importlib.util
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from genfer_tpu_torch import bench

REPO = Path(__file__).resolve().parent.parent


def test_pallas_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.main(["--pallas", "--seed", "3"])


@pytest.mark.parametrize("argv", [
    ["--serving"], ["--scan"], ["--serving", "--scan"], ["--nested"],
    ["--ozaki"], ["--highorder"],
    # every section raises before it runs, --scaling, --suite and --all
    # among them
    ["--suite", "--seed", "1"], ["--suite"], ["--scaling"],
    ["--serving", "--suite"], ["--scan", "--scaling"], ["--ozaki", "--suite"],
    ["--highorder", "--scaling"], ["--nested", "--suite"], ["--all"],
    ["--pallas", "--scan", "--suite"],
])
def test_serving_and_scan_without_a_card_raise(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.main(argv)


def test_serving_scan_and_nested_are_ported():
    """``--serving``, ``--scan`` and ``--nested`` are ported, with the JAX
    bench's sizes."""
    options = bench.build_arg_parser().parse_args(
        ["--serving", "--scan", "--nested"])
    assert options.serving and options.scan and options.nested
    assert bench.SERVING_BATCH == 4096
    assert (bench.GENERIC_BATCH, bench.GENERIC_STEPS) == (256, 109)
    assert bench.NESTED_K == 63


def test_ozaki_and_highorder_are_ported():
    """``--ozaki`` and ``--highorder`` are ported at the JAX bench's orders;
    the ozaki section keeps its variants, K1 in place of the two XLA f64
    rows."""
    options = bench.build_arg_parser().parse_args(["--ozaki", "--highorder"])
    assert options.ozaki and options.highorder
    assert bench.OZAKI_ORDERS == (256, 384, 512)
    assert bench.HIGHORDER_ORDERS == (1024, 2048)
    assert [name for name, _ in bench.OZAKI_VARIANTS] == [
        "k1", "ozaki_int8_pb7", "ozaki_int8_pb6", "ozaki_bf16_pb7"]


def test_bound_of_the_ozaki_passes():
    """K5's bound: its pair passes times the useful multiply-adds over the
    int8 (1,979 TOPS) or bf16 (989 TFLOP/s) rate, or its f64 bytes."""
    shape = (512, 512)
    macs = 512 * 513 // 2 * 512 * 513 // 2
    ms, by = bench.product_bound(shape, shape, shape, passes=36,
                                 rate=bench.INT8_MMA)
    assert by == "tensor operations"
    assert ms == pytest.approx(36 * macs / (1979e12 / 2) * 1e3)
    ms, _ = bench.product_bound(shape, shape, shape, passes=36,
                                rate=bench.BF16_MMA)
    assert ms == pytest.approx(36 * macs / (989e12 / 2) * 1e3)
    thin, by = bench.product_bound((255, 268), (2, 2), (255, 268),
                                   passes=36, rate=bench.INT8_MMA)
    assert by == "bytes"
    assert thin == pytest.approx(8 * (2 * 255 * 268 + 4) / 3.35e12 * 1e3)


def test_generic_serving_on_the_cpu():
    """``generic_serving`` at batch 4 on the CPU: the mixture converges at
    order 128 and its batch rows equal ``run_with_data``."""
    row = bench.bench_generic_serving("cpu", batch=4, device="cpu")
    assert row["grid_order"] == 128 and row["steps"] == 109
    assert row["inferences_per_s"] > 0
    assert "generate_mixture" in row["_meta"]["source"]


def test_cascade_switchpoint_rows():
    """Both switchpoint models compile as cascades of 109 units; the
    continuous one is within 1e-12 of its exact Gamma-Poisson value."""
    out = bench.bench_cascade_switchpoint("cpu")
    assert out["discrete"]["units"] == out["continuous"]["units"] == 109
    assert out["continuous"]["rel_err_vs_exact"] <= 1e-12
    assert "generate_switchpoint" in out["_meta"]["source"]


def test_nested_on_the_cpu():
    """``--nested``'s section at k = 7: the scan runs print the
    interpreter's values at is_close (it raises otherwise)."""
    row = bench.bench_nested("cpu", k=7, device="cpu")
    assert row["given_range"] == 8
    assert row["mass_compiled_steady"] > 0


def test_headline_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.main(["--seed", "3"])


def test_unknown_option_is_refused():
    with pytest.raises(SystemExit):
        bench.main(["--pallas", "--order", "256"])


def test_bound_of_the_order_512_product():
    """1.72e10 useful multiply-adds at 33.5e12 IEEE-f32 FMAs a second."""
    ms, by = bench.product_bound((512, 512), (512, 512), (512, 512))
    macs = (512 * 513 // 2) ** 2
    assert macs == pytest.approx(1.72e10, rel=5e-3)
    assert by == "operations"
    assert ms == pytest.approx(macs / 33.5e12 * 1e3)
    batched, _ = bench.product_bound((512, 512), (512, 512), (512, 512),
                                     batch=8)
    assert batched == pytest.approx(8 * ms)


def test_bound_of_a_thin_product_is_its_bytes():
    # (1, 87) x (95, 87) -> (95, 87): 8265 MACs, 16.6 kB moved
    ms, by = bench.product_bound((1, 87), (95, 87), (95, 87))
    assert by == "bytes"
    assert ms == pytest.approx(4 * (87 + 2 * 95 * 87) / 3.35e12 * 1e3)
    one_d, by_1d = bench.product_bound((4096,), (4096,), (4096,))
    assert by_1d == "operations"
    assert one_d == pytest.approx(4096 * 4097 / 2 / 33.5e12 * 1e3)


@pytest.mark.cuda
def test_bench_headline_on_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(bench, "RESULTS", tmp_path / "results.json")
    results = bench.main([])
    row = results["f64_kernel"]["512"]
    assert row["max_err_vs_plain"] <= 1e-12
    assert 0 < row["bound_share"] <= 1 and row["gflops"] > 0
    assert results["host_kernel"]["512"]["gflops"] > 0
    assert results["vs_host"] == pytest.approx(
        row["gflops"] / results["host_kernel"]["512"]["gflops"])


@pytest.mark.cuda
def test_bench_sections_on_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(bench, "RESULTS", tmp_path / "results.json")
    results = bench.main(["--pallas"])
    assert (tmp_path / "results.json").exists()
    assert set(results["pallas_kernel"]) == {"256", "512"}
    assert set(results["pallas_batched"]) == {"256x32", "512x8"}
    assert set(results["pallas_rowstrip"]) == {"256", "384", "512"}
    for row in results["pallas_kernel"].values():
        assert row["max_rel_err_vs_f64"] < 1e-4
        assert 0 < row["bound_share"] <= 1
    for row in results["pallas_rowstrip"].values():
        # against the tensor cores' rate, three TF32 passes
        assert 0 < row["tile_bound_share"] <= 1
        assert 0 < row["grouped_bound_share"] <= 1
    assert results["_meta"]["card"] == bench.card()
    assert np.isfinite(results["pallas_rowstrip"]["512"]["grouped_ms"])


@pytest.mark.cuda
def test_bench_serving_and_scan_on_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(bench, "RESULTS", tmp_path / "results.json")
    results = bench.main(["--serving", "--scan"])
    row = results["serving"]
    assert row["batch"] == bench.SERVING_BATCH
    assert row["device_inferences_per_s"] > 0
    assert row["speedup"] == pytest.approx(
        row["device_inferences_per_s"] / row["host_inferences_per_s"])
    generic = results["generic_serving"]
    assert generic["grid_order"] == 128 and generic["inferences_per_s"] > 0
    scan = results["population_scan"]
    assert scan["limit"] == 256 and scan["steps"] == 20
    assert scan["datasets_per_s"] > 0 and "skipped" in scan["hmm"]
    assert results["cascade_switchpoint"]["discrete"]["units"] == 109


@pytest.mark.cuda
def test_bench_ozaki_and_highorder_on_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(bench, "RESULTS", tmp_path / "results.json")
    results = bench.main(["--ozaki"])
    rows = results["ozaki"]
    assert set(rows) == {"256", "384", "512", "_meta"}
    for order in ("256", "384", "512"):
        k1, k5 = rows[order]["k1"], rows[order]["ozaki_int8_pb7"]
        assert k1["launches"]["k5"] == 0 and k1["launches"]["k1"] >= 1
        assert k5["launches"]["k5"] >= 1 and k5["spot_rel_err"] < 1e-12
        assert 0 < k5["bound_share"] <= 1


# ------------------------------------------------- --scaling, --suite, --all

@pytest.mark.parametrize("size,nvars,limit", [(20, 2, 16), (12, 2, 24),
                                              (30, 1, 40)])
def test_scaling_end_to_end_on_the_cpu(size, nvars, limit):
    """``--scaling``'s end-to-end table at a tiny population and limit:
    every backend's row, ``numpy``, ``hybrid`` and ``jax`` at is_close of
    the numpy run, and no product large enough to leave the host."""
    table = bench.scaling_end_to_end((limit,), size, nvars, device="cpu")
    row = table[str(limit)]
    assert tuple(row) == bench.SCALING_BACKENDS
    for backend in ("numpy", "hybrid", "jax"):
        assert row[backend]["is_close"], (backend, row[backend])
        assert row[backend]["max_rel_dev"] <= 1e-9
        assert row[backend]["s"] > 0 and row[backend]["first_s"] > 0
    assert row["hybrid"]["device_ops"] == row["pallas"]["device_ops"] == 0
    finding = bench._scaling_finding(table)
    assert finding.startswith(f"limit {limit}: fastest ")


def test_scaling_finding_reads_its_rows():
    table = {"256": {"numpy": {"s": 2.0}, "jax": {"s": 4.0},
                     "pallas": "FAILED RuntimeError: x"},
             "512": {"hybrid": {"s": 1.0}}}
    assert bench._scaling_finding(table) == (
        "limit 256: fastest numpy; wall over numpy's jax 2; "
        "limit 512: no numpy row")


def _root_bench():
    """genfer_tpu's root ``bench.py``, loaded by path (its name is the
    port's bench module's)."""
    spec = importlib.util.spec_from_file_location("root_bench",
                                                  REPO / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_printed(path, *flags) -> str:
    import genfer_tpu.cli as jcli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jcli.main([str(path), "--no-timing", *flags])
    return buf.getvalue()


def _z_line(text: str) -> str:
    return next(line for line in text.splitlines()
                if line.startswith("Total measure"))


def _model(root: Path, name: str, source: str, rational: bool = False):
    d = root / name
    d.mkdir(parents=True)
    (d / f"{name}.sgcl").write_text(source)
    if rational:
        (d / f"{name}.rational.sgcl").write_text(source)
    return d / f"{name}.sgcl"


@pytest.fixture
def fake_corpus(tmp_path):
    """A corpus in the reference's layout: betaBernoulli's ``.expected``
    holds a line of genfer_tpu's fp output and one of its ``--rational``
    output; nested's (with a ``.rational.sgcl`` twin) holds only a wrong
    line; clinicalTrial does not parse (the expected fp failure, and a
    crash in ``--rational``); and one ``approx/`` model whose ``.expect``
    is genfer_tpu's output."""
    exact = tmp_path / "benchmarks" / "neurips2023" / "exact"
    path = _model(exact, "betaBernoulli",
                  (REPO / "examples" / "beta_bernoulli.sgcl").read_text())
    (path.parent / "betaBernoulli.expected").write_text(
        _z_line(_jax_printed(path)) + "\n\n"
        + _z_line(_jax_printed(path, "--rational")) + "\n")
    path = _model(exact, "nested",
                  (REPO / "examples" / "nested_inference.sgcl").read_text(),
                  rational=True)
    (path.parent / "nested.expected").write_text(
        "Total measure:             Z = 0.123456789\n")
    path = _model(exact, "clinicalTrial", "this is not a program\n")
    (path.parent / "clinicalTrial.rational.sgcl").write_text(
        (REPO / "examples" / "beta_bernoulli.sgcl").read_text())
    approx = tmp_path / "benchmarks" / "neurips2023" / "approx"
    path = _model(approx, "scamCalls",
                  (REPO / "examples" / "scam_calls.sgcl").read_text())
    (path.parent / "scamCalls.expect").write_text(_jax_printed(path))
    return tmp_path


def _status(cell) -> str:
    if isinstance(cell, float):
        return "time"
    if "wrong result" in cell:
        return "wrong result"
    if cell.startswith("expected failure"):
        return "expected failure"
    return cell.split(":")[0]


def test_suite_on_a_fake_corpus(fake_corpus, monkeypatch):
    """``--suite`` with the corpus runs the reference's protocol: the same
    models and modes as genfer_tpu's root ``bench_suite``, each with the
    same status (a time, ``wrong result``, the expected failure, a
    crash)."""
    monkeypatch.setenv("GENFER_REFERENCE", str(fake_corpus))
    want = _root_bench().bench_suite()
    got = bench.bench_suite("cpu", device="cpu")
    assert "neurips2023" in got.pop("_meta")["source"]
    assert set(got) == set(want) == {"betaBernoulli", "nested",
                                     "clinicalTrial", "approx/scamCalls"}
    for model, row in want.items():
        assert set(got[model]) == set(row), model
        for mode, cell in row.items():
            assert _status(got[model][mode]) == _status(cell), (
                model, mode, got[model][mode], cell)
    assert [_status(c) for c in got["betaBernoulli"].values()] == [
        "time", "time"]
    assert [_status(c) for c in got["nested"].values()] == [
        "wrong result", "wrong result"]
    assert [_status(c) for c in got["clinicalTrial"].values()] == [
        "expected failure", "time"]
    assert _status(got["approx/scamCalls"]["fp"]) == "time"


def test_suite_records_a_crash(fake_corpus, monkeypatch):
    """A mode that crashes outside the expected failure is recorded as a
    crash and the suite goes on (genfer_tpu's root ``bench_suite`` raises
    TypeError there: it formats the missing time)."""
    exact = fake_corpus / "benchmarks" / "neurips2023" / "exact"
    (exact / "clinicalTrial" / "clinicalTrial.rational.sgcl").unlink()
    monkeypatch.setenv("GENFER_REFERENCE", str(fake_corpus))
    with pytest.raises(TypeError):
        _root_bench().bench_suite()
    got = bench.bench_suite("cpu", device="cpu")
    assert got["clinicalTrial"]["fp"].startswith("expected failure")
    assert got["clinicalTrial"]["rational"].startswith("crashed: ")
    assert _status(got["betaBernoulli"]["fp"]) == "time"


def test_suite_stand_in_without_the_corpus(monkeypatch, tmp_path):
    """Without the corpus (where genfer_tpu's bench returns None) the
    stand-in runs ``examples/*.sgcl`` in fp, ``--rational`` and
    ``--backend jax`` and a generator family in fp and ``--backend jax``,
    every row held to the host f64 run, and its ``_meta`` names the
    substitution."""
    monkeypatch.setenv("GENFER_REFERENCE", str(tmp_path))
    assert _root_bench().bench_suite() is None
    family = ("population(20, 2)", "generate_population",
              {"size": 20, "num_vars": 2})
    got = bench.bench_suite("cpu", device="cpu", families=(family,))
    assert got.pop("_meta")["source"] == bench.SUITE_SOURCE
    examples = {p.name for p in (REPO / "examples").glob("*.sgcl")}
    assert set(got) == examples | {family[0]}
    for label, row in got.items():
        modes = ("fp", "jax") if label == family[0] else (
            "fp", "rational", "jax")
        assert tuple(row) == modes, label
        for mode, cell in row.items():
            assert isinstance(cell, dict), (label, mode, cell)
            assert cell["s"] > 0
        assert row["jax"]["held"] == row["fp"]["held"] > 0, label
    assert got["beta_bernoulli.sgcl"]["rational"]["held"] > 0


def test_all_runs_the_reference_sections_and_records_a_failure(
        tmp_path, monkeypatch):
    """``--all`` runs the headline and the JAX bench's ``--all`` sections
    in its order (not ``--nested``); a section that raises is recorded as
    ``FAILED ...``, the rest run, the results are written, and then
    ``main`` raises."""
    monkeypatch.setattr(bench, "RESULTS", tmp_path / "results.json")
    monkeypatch.setattr(bench, "_card", lambda: "a card")
    ran = []

    def section(name):
        def run(*args, **kwargs):
            ran.append(name)
            if name == "scaling":
                raise ValueError("no card here")
            return {name: {"ok": True}}
        return run

    for name in ("headline", *bench.ALL_SECTIONS, "nested"):
        monkeypatch.setattr(bench, f"run_{name}", section(name))
    with pytest.raises(RuntimeError, match="sections failed: scaling"):
        bench.main(["--all"])
    assert ran == ["headline", "ozaki", "pallas", "scaling", "highorder",
                   "serving", "scan", "suite"]
    written = json.loads((tmp_path / "results.json").read_text())
    assert written["scaling"] == "FAILED ValueError: no card here"
    assert written["suite"] == {"ok": True}


@pytest.mark.cuda
def test_bench_scaling_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = bench.bench_order_scaling(bench.card(), limits=(64,), orders=(256,))
    row = out["kernel"]["256"]
    assert row["pallas_rel_err"] < 1e-4
    assert row["f64_max_err_vs_plain"] <= 1e-12 and row["f64_vs_host"] > 1
    for backend in ("numpy", "hybrid", "jax"):
        assert out["end_to_end"]["64"][backend]["is_close"], backend
    assert out["_meta"]["card"] == bench.card()

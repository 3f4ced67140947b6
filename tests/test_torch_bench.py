"""The bench twin ``python -m genfer_tpu_torch.bench``: its options on the
CPU (what is not ported raises, the f64 headline and ``--pallas`` need a
card), the bound arithmetic it reports, and, on the card, its sections."""

import numpy as np
import pytest
import torch

from genfer_tpu_torch import bench


@pytest.mark.parametrize("argv,item", [
    # an unported section raises before the headline runs
    (["--nested", "--seed", "1"], "Queue 1 item 3"),
    (["--suite"], "Queue 1 item 3"),
    (["--scaling"], "Queue 1 item 1"),
    (["--serving", "--highorder"], "Queue 1 item 11"),
    (["--scan", "--ozaki"], "Queue 2 K5"),
    (["--highorder"], "Queue 1 item 11"),
    (["--ozaki"], "Queue 2 K5"),
    (["--nested"], "Queue 1 item 3"),
    (["--all"], "Queue 1 item 3"),
    # an unported section raises before the ported ones run
    (["--pallas", "--scan", "--suite"], "Queue 1 item 3"),
])
def test_unported_options_name_their_roadmap_item(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        bench.main(argv)


def test_pallas_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.main(["--pallas", "--seed", "3"])


@pytest.mark.parametrize("argv", [["--serving"], ["--scan"],
                                  ["--serving", "--scan"]])
def test_serving_and_scan_without_a_card_raise(monkeypatch, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        bench.main(argv)


def test_serving_and_scan_are_ported_and_name_scanc():
    """``--serving`` / ``--scan`` are ported; their scan-compiler sections
    (generic_serving, cascade_switchpoint) name ROADMAP item 10."""
    for name in ("serving", "scan"):
        assert name not in bench.UNPORTED
    assert "item 10" in bench.SCANC
    assert bench.SERVING_BATCH == 4096


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
    assert "item 10" in results["generic_serving"]["not_ported"]
    scan = results["population_scan"]
    assert scan["limit"] == 256 and scan["steps"] == 20
    assert scan["datasets_per_s"] > 0 and "skipped" in scan["hmm"]
    assert "item 10" in results["cascade_switchpoint"]["not_ported"]

"""``--backend sharded`` (``parallel.mesh.ShardedF64Backend``), the scan
compiler's ``run_batch(mesh=...)`` and the ``dryrun_multichip`` twin, on
gloo ranks on the CPU (spawned with ``torch.multiprocessing``, a
``file://`` store under ``tmp_path``, a bounded join).

population(12, 3) through the CLI on a 2-rank group prints host f64's
lines at genfer_tpu's ``test_sharded_backend_full_inference`` bar (rel
1e-9, abs 1e-8); with lowered thresholds every route of the backend runs
and the posterior stays at that bar; the automatic choice takes
``sharded`` on a group of more than one rank only; ``run_batch`` on a dp
mesh equals the unsharded call at rtol 1e-12; the dryrun prints its stage
lines at 4 ranks.  No jax at module level: the spawned ranks import this
module.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from genfer_tpu_torch import cli
from genfer_tpu_torch.lang.parser import parse_program
from genfer_tpu_torch.parallel import mesh as M
from genfer_tpu_torch.tools.generators import generate_population

SPAWN_TIMEOUT_S = 120.0
#: thresholds low enough that population(12, 3)'s products take the
#: 2-axis, n-axis and halo routes at tp = 2
LOW = dict(min_rows_per_device=2, conv_shard_flops=1000,
           min_lanes_per_device=2, halo_min_rows=10)
#: the Poisson chain of genfer_tpu's test_scanc_run_batch_dp_sharded
CHAIN = "X ~ Poisson(4);\n" + "".join(
    f"observe {c} ~ Poisson(1/2 * X);\n" for c in [1, 2, 0, 3, 1, 2]
) + "return X"


def _posterior(backend, program):
    from genfer_tpu_torch.gf.extract import moments_taylor, probs_taylor
    from genfer_tpu_torch.numbers.scalar import F64
    from genfer_tpu_torch.semantics.gf_transformer import GfTransformer

    translation = GfTransformer(F64).semantics(program)
    gf = translation.gf.simplify(backend)
    total, moments = moments_taylor(gf, backend, program.result,
                                    translation.var_info, 5)
    probs = probs_taylor(gf, backend, program.result, translation.var_info,
                         12)
    return [float(x.display()) for x in (total, *moments, *probs)]


def _two_ranks(path):
    """One rank of the 2-rank group: the CLI, the lowered thresholds, the
    automatic choice and ``run_batch`` on a dp mesh."""
    from genfer_tpu_torch.scanc import compile_scan_program

    out = {}
    args = cli.build_arg_parser().parse_args(
        [path, "--no-timing", "--backend", "sharded"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        backend = cli.run(parse_program(open(path).read()), args,
                          device="cpu")
    out["cli"] = buf.getvalue()
    out["cli_backend"] = type(backend).__name__
    out["cli_mesh"] = dict(backend.mesh.shape)

    program = parse_program(generate_population(None, 12, 3))
    low = M.ShardedF64Backend(device="cpu", **LOW)
    out["low"] = _posterior(low, program)
    # population calls no 1-axis product and no division: those routes
    # run on seeded operands (genfer_tpu's test_sharded_conv_1d and
    # test_sharded_div_lanes shapes)
    rng = np.random.default_rng(0)
    a1, b1 = rng.random(100), rng.random(80)
    out["conv_1d"] = low.conv_trunc(torch.from_numpy(a1),
                                    torch.from_numpy(b1), (100,))
    xs = rng.random((24, 17, 3))
    ys = np.zeros((24, 1, 1))
    ys[:, 0, 0] = rng.random(24) + 0.5
    out["div"] = low.poly_div(torch.from_numpy(xs), torch.from_numpy(ys),
                              (24, 17, 3))
    # a 2-axis product whose second effective axis is axis 2
    a3, b3 = rng.random((40, 1, 7)), rng.random((33, 1, 7))
    out["axis2"] = low.conv_trunc(torch.from_numpy(a3), torch.from_numpy(b3),
                                  (40, 1, 13))
    out["routes"] = dict(low.routes)

    auto = cli.build_arg_parser().parse_args([path, "--limit", "2000"])
    cli._accelerator_present = lambda: True
    out["auto"] = type(cli.select_mode(auto, program, "cpu")[1]).__name__

    obj, _ = compile_scan_program(parse_program(CHAIN), order=64,
                                  max_steps=6, device="cpu")
    mesh = M.make_mesh(2, dp=2, device="cpu")
    bc = np.random.default_rng(3).integers(0, 5, size=(8, 6)).astype(float)
    out["batch"] = obj.run_batch([bc])
    out["batch_mesh"] = obj.run_batch([bc], mesh=mesh)
    try:
        obj.run_batch([bc[:3]], mesh=mesh)
        out["odd"] = None
    except ValueError as e:
        out["odd"] = str(e)
    return out


@pytest.fixture(scope="module")
def pop12(tmp_path_factory):
    path = tmp_path_factory.mktemp("sgcl") / "population_12_3.sgcl"
    generate_population(path, 12, 3)
    return str(path)


@pytest.fixture(scope="module")
def two_ranks(pop12, tmp_path_factory):
    return M.spawn(_two_ranks, 2, (pop12,), device="cpu",
                   store_dir=tmp_path_factory.mktemp("group_2"),
                   timeout_s=SPAWN_TIMEOUT_S)


def _host_lines(path):
    args = cli.build_arg_parser().parse_args(
        [path, "--no-timing", "--backend", "numpy"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.run(parse_program(open(path).read()), args, device="cpu")
    return buf.getvalue()


def _agree(a, b):
    """genfer_tpu's test_sharded_backend_full_inference bar."""
    return abs(a - b) <= max(1e-9 * max(abs(a), abs(b)), 1e-8)


def test_cli_backend_sharded_prints_host_lines(two_ranks, pop12):
    """``--backend sharded`` on 2 ranks: rank 0 prints host f64's lines
    at is_close, rank 1 prints nothing; the backend is the sharded one,
    its mesh (1, 2)."""
    rank0, rank1 = two_ranks
    assert rank1["cli"] == ""
    assert rank0["cli_backend"] == "ShardedF64Backend"
    assert rank0["cli_mesh"] == {"dp": 1, "tp": 2}
    sh = [line for line in rank0["cli"].splitlines() if "=" in line]
    host = [line for line in _host_lines(pop12).splitlines() if "=" in line]
    assert len(sh) == len(host) and len(sh) > 5
    for a, b in zip(sh, host):
        ta, tb = a.split("=")[-1].strip(), b.split("=")[-1].strip()
        try:
            fa, fb = float(ta), float(tb)
        except ValueError:
            assert a == b
        else:
            assert _agree(fa, fb), (a, b)


def test_lowered_thresholds_take_every_route(two_ranks):
    """With the thresholds lowered every route ran on both ranks, and the
    posterior of population(12, 3) is host f64's at is_close."""
    from genfer_tpu_torch.taylor.host import NumpyF64Backend

    want = _posterior(NumpyF64Backend(),
                      parse_program(generate_population(None, 12, 3)))
    for out in two_ranks:
        assert all(n > 0 for n in out["routes"].values()), out["routes"]
        assert set(out["routes"]) == set(M.ShardedF64Backend.ROUTES)
        assert all(_agree(a, b) for a, b in zip(out["low"], want)), (
            out["low"], want)


def test_one_axis_routes_match_genfer_tpu(two_ranks):
    """The 1-axis product and the lane-sharded division of the lowered
    backend equal genfer_tpu's ``ShardedF64Backend`` at tp = 2 (rtol
    1e-12), on every rank."""
    import jax.numpy as jnp

    from genfer_tpu.parallel.mesh import ShardedF64Backend, make_mesh

    rng = np.random.default_rng(0)
    a1, b1 = rng.random(100), rng.random(80)
    xs = rng.random((24, 17, 3))
    ys = np.zeros((24, 1, 1))
    ys[:, 0, 0] = rng.random(24) + 0.5
    jb = ShardedF64Backend(make_mesh(2), min_rows_per_device=2,
                           conv_shard_flops=1000, min_lanes_per_device=2)
    want_1d = np.asarray(jb.conv_trunc(jnp.asarray(a1), jnp.asarray(b1),
                                       (100,)))
    want_div = np.asarray(jb.poly_div(jnp.asarray(xs), jnp.asarray(ys),
                                      (24, 17, 3)))
    for out in two_ranks:
        np.testing.assert_allclose(out["conv_1d"].numpy(), want_1d,
                                   rtol=1e-12, atol=0)
        np.testing.assert_allclose(out["div"].numpy(), want_div,
                                   rtol=1e-12, atol=0)


def test_auto_choice_is_sharded_only_on_several_ranks(pop12):
    """At offload scale on a card the automatic choice is ``sharded`` on
    a group of 2 ranks (in the spawned group) and ``hybrid`` here, in a
    process outside any group."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    args = cli.build_arg_parser().parse_args([pop12, "--limit", "2000"])
    program = parse_program(generate_population(None, 12, 3))
    saved = cli._accelerator_present
    cli._accelerator_present = lambda: True
    try:
        backend = cli.select_mode(args, program, "cpu")[1]
    finally:
        cli._accelerator_present = saved
    assert type(backend).__name__ == "HybridBackend"


def test_auto_choice_in_the_group(two_ranks):
    assert [out["auto"] for out in two_ranks] == ["ShardedF64Backend"] * 2


def test_run_batch_on_a_dp_mesh_matches_the_unsharded_call(two_ranks):
    """Each rank serves half the batch through its own entry; the
    all-gathered masses and totals equal the unsharded call's at rtol
    1e-12 on every rank."""
    for out in two_ranks:
        (m, t), (ms, ts) = out["batch"], out["batch_mesh"]
        assert m.shape == ms.shape == (8, len(m[0])) and ts.shape == (8,)
        np.testing.assert_allclose(ms, m, rtol=1e-12, atol=0)
        np.testing.assert_allclose(ts, t, rtol=1e-12, atol=0)


def test_run_batch_matches_genfer_tpus_sharded_run_batch(two_ranks):
    """The port's sharded ``run_batch`` against genfer_tpu's on its
    2-device dp mesh, at rtol 1e-12."""
    import jax
    from jax.sharding import Mesh

    from genfer_tpu.lang.parser import parse_program as jparse
    from genfer_tpu.scanc import compile_scan_program

    obj, _ = compile_scan_program(jparse(CHAIN), order=64, max_steps=6,
                                  device="cpu")
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    bc = np.random.default_rng(3).integers(0, 5, size=(8, 6)).astype(float)
    jm, jt = obj.run_batch([bc], mesh=mesh)
    for out in two_ranks:
        ms, ts = out["batch_mesh"]
        np.testing.assert_allclose(ms, jm, rtol=1e-12, atol=0)
        np.testing.assert_allclose(ts, jt, rtol=1e-12, atol=0)


def test_run_batch_refuses_a_batch_that_does_not_divide(two_ranks):
    for out in two_ranks:
        assert "not divisible" in out["odd"]


def test_dryrun_multichip_twin_at_four_ranks(capfd):
    """The twin of ``__graft_entry__.dryrun_multichip`` on 4 gloo ranks
    (mesh dp = 2, tp = 2; stage 1c's halo product at 1024 rows, not
    18432: on CPU ranks the plain version's Toeplitz einsum makes the
    full order take a minute): rank 0 prints every stage line and the
    final OK."""
    from genfer_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(4, device="cpu", big_rows=1024,
                     timeout_s=SPAWN_TIMEOUT_S)
    printed = capfd.readouterr().out
    for stage in ("1", "1b", "1c", "2", "3"):
        assert f"dryrun_multichip stage {stage} OK" in printed, printed
    assert "dryrun_multichip OK on mesh dp=2 tp=2" in printed
    assert printed.count("stage 1 OK") == 1  # rank 0 only


@pytest.mark.parametrize("n_devices,device,err,what", [
    (None, None, RuntimeError, "no CUDA device"),
    (2, "cuda", RuntimeError, "no CUDA device"),
    (0, "cpu", ValueError, "a rank or more"),
])
def test_dryrun_multichip_refuses_to_run_nothing(monkeypatch, n_devices,
                                                 device, err, what):
    """Where no card exists, the default call (a rank a card: no rank at
    all) and a call for a card raise, as the mesh does, instead of
    spawning no rank and returning; so does a call for no rank."""
    from genfer_tpu_torch.entry import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(err, match=what):
        dryrun_multichip(n_devices, device=device)


def test_second_effective_axis_past_axis_1(two_ranks):
    """A 2-axis product on axes (0, 2), (40, 1, 7) x (33, 1, 7) -> (40, 1,
    13), takes the halo route and equals host f64 (rtol 1e-12) on every
    rank.  genfer_tpu's backend raises on it: its 2-axis routes take the
    output's columns from axis 1 (``cols = out_shape[1]``), 1 here, and
    reshape 40 values into (40, 1, 13) (a divergence of the reference,
    ROADMAP Queue 3)."""
    import jax.numpy as jnp

    from genfer_tpu.parallel.mesh import ShardedF64Backend, make_mesh
    from genfer_tpu_torch.taylor.host import NumpyF64Backend

    rng = np.random.default_rng(0)
    rng.random(100), rng.random(80), rng.random((24, 17, 3)), rng.random(24)
    a3, b3 = rng.random((40, 1, 7)), rng.random((33, 1, 7))
    want = NumpyF64Backend().conv_trunc(a3, b3, (40, 1, 13))
    for out in two_ranks:
        np.testing.assert_allclose(out["axis2"].numpy(), want, rtol=1e-12,
                                   atol=0)
    jb = ShardedF64Backend(make_mesh(2), halo_min_rows=10)
    with pytest.raises(TypeError, match="reshape"):
        jb.conv_trunc(jnp.asarray(a3), jnp.asarray(b3), (40, 1, 13))

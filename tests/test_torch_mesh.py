"""The port's mesh layer (``genfer_tpu_torch.parallel.mesh``) against
genfer_tpu's, and K1's output-row window.

Each routine runs on a 4-rank gloo group on the CPU (ranks spawned with
``torch.multiprocessing``, a ``file://`` store under ``tmp_path``, a
bounded join) at (dp, tp) = (2, 2) and (1, 4), and genfer_tpu's runs in
this process on 4 of the 8 virtual CPU devices ``tests/conftest.py``
provisions, at the same mesh shape, on the same ``np.random.default_rng``
inputs: every rank's result within rtol 1e-12 of genfer_tpu's.  K1's
window (``rows=(r0, r1)``) is held against the plain version's rows.  No
jax at module level: the spawned ranks import this module.
"""

import numpy as np
import pytest
import torch

from genfer_tpu_torch.ops import conv2d_f64 as K
from genfer_tpu_torch.ops.conv2d import TILE, window_plan
from genfer_tpu_torch.parallel import mesh as M

MESHES = [(2, 2), (1, 4)]
#: seconds a spawned group may take (the work is a few seconds)
SPAWN_TIMEOUT_S = 120.0


def _rand(seed, *shape):
    return np.random.default_rng(seed).random(shape)


def _div_inputs():
    xs = _rand(7, 24, 17, 3)
    ys = np.zeros((24, 1, 1))
    ys[:, 0, 0] = _rand(8, 24) + 0.5
    return xs, ys


# name -> (routine, its operands, its other arguments): the calls made
# on both sides
CASES = {
    "conv_1d": ("sharded_conv_1d", lambda: (_rand(1, 100), _rand(2, 80)),
                (128,), {}),
    "conv_2d": ("sharded_conv_2d",
                lambda: (_rand(3, 30, 20), _rand(4, 35, 20)), ((64, 39),),
                {}),
    # rows cut on K1's tile grid into unequal windows (200 = 64 + 64 + 64
    # + 8 at tp = 4; 128 + 72 at tp = 2)
    "conv_2d_tiles": ("sharded_conv_2d",
                      lambda: (_rand(5, 150, 40), _rand(6, 140, 30)),
                      ((200, 60),), {}),
    "conv_nd": ("sharded_conv_nd",
                lambda: (_rand(9, 16, 6, 5), _rand(10, 12, 7, 4)),
                ((20, 9, 6),), {}),
    "halo_2d": ("halo_conv_2d",
                lambda: (_rand(11, 64, 24), _rand(12, 64, 20)), ((64, 30),),
                {}),
    "halo_nd": ("halo_conv_nd",
                lambda: (_rand(13, 32, 10, 6), _rand(14, 32, 8, 5)),
                ((32, 12, 8),), {}),
    "halo_col_chunk": ("halo_conv_nd",
                       lambda: (_rand(15, 64, 64), _rand(16, 64, 64)),
                       ((64, 64),), {"col_chunk": 16}),
    "div_lanes": ("sharded_div_lanes", _div_inputs, ((24, 17, 3), 0), {}),
    "inference_step": ("sharded_inference_step",
                       lambda: (_rand(17, 4, 8, 8), _rand(18, 4, 8, 8)),
                       ((16, 15),), {}),
}


def _port_cases(dp):
    """One rank: every case on a (dp, 4 / dp) mesh; the results (tuples
    as lists), the shapes the halo schedule held (``halo_blocks``), the mesh's coordinates
    and ``Mesh.shift`` of the rank number both ways."""
    mesh = M.make_mesh(4, dp=dp, device="cpu")
    out = {}
    for name, (fn, inputs, args, kw) in CASES.items():
        ops = [torch.from_numpy(x) for x in inputs()]
        res = getattr(M, fn)(mesh, *ops, *args, **kw)
        out[name] = list(res) if isinstance(res, tuple) else res
        if name == "halo_nd":
            out["held"] = {}
            M.halo_blocks(mesh, *ops, *args, held=out["held"])
    me = torch.tensor([float(torch.distributed.get_rank())])
    out["coords"] = dict(mesh.coords)
    out["shift"] = [float(mesh.shift("tp", me, 1)),
                    float(mesh.shift("tp", me, -1))]
    return out


@pytest.fixture(scope="module", params=MESHES, ids=["dp2tp2", "dp1tp4"])
def port(request, tmp_path_factory):
    dp, tp = request.param
    store = tmp_path_factory.mktemp(f"group_{dp}x{tp}")
    ranks = M.spawn(_port_cases, 4, (dp,), device="cpu", store_dir=store,
                    timeout_s=SPAWN_TIMEOUT_S)
    return (dp, tp), ranks


def _jax_case(dp, name):
    import jax.numpy as jnp

    from genfer_tpu.parallel import mesh as JM

    fn, inputs, args, kw = CASES[name]
    mesh = JM.make_mesh(4, dp=dp)
    res = getattr(JM, fn)(mesh, *(jnp.asarray(x) for x in inputs()),
                          *args, **kw)
    return ([np.asarray(r) for r in res] if isinstance(res, tuple)
            else np.asarray(res))


@pytest.mark.parametrize("name", list(CASES))
def test_routine_matches_genfer_tpu(port, name):
    """Every rank returns the whole result, within rtol 1e-12 of
    genfer_tpu's routine at the same (dp, tp)."""
    (dp, _), ranks = port
    want = _jax_case(dp, name)
    for rank, out in enumerate(ranks):
        got = out[name]
        pairs = zip(got, want) if isinstance(got, list) else [(got, want)]
        for g, w in pairs:
            assert tuple(g.shape) == w.shape, (rank, name)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=0,
                                       err_msg=f"rank {rank} {name}")


def test_halo_holds_row_blocks(port):
    """The halo schedule holds this rank's rows / tp of each operand and
    of the output (and the spill: one block less a row; the local
    product: two blocks less a row), not the whole tensors."""
    (_, tp), ranks = port
    rows = 32 // tp
    for out in ranks:
        held = out["held"]
        assert held["a"] == (rows, 10, 6) and held["b"] == (rows, 8, 5)
        assert held["a_vis"] == (rows, 10, 6)
        assert held["acc"] == (rows, 12, 8)
        assert held["spill"] == (rows - 1, 12, 8)
        assert held["full"] == (2 * rows - 1, 12, 8)


def test_mesh_coordinates_and_ring(port):
    """Rank d * tp + t sits at (d, t), as genfer_tpu's mesh places its
    devices; ``shift`` by +1 returns the tp rank below's value, by -1 the
    one above's, around the ring."""
    (dp, tp), ranks = port
    for rank, out in enumerate(ranks):
        d, t = divmod(rank, tp)
        assert out["coords"] == {"dp": d, "tp": t}
        assert out["shift"] == [float(d * tp + (t - 1) % tp),
                                float(d * tp + (t + 1) % tp)]


def test_make_mesh_follows_genfer_tpus_dp_rule():
    """dp = 2 on an even group of >= 4 ranks, else 1 (on the jax side,
    ``make_mesh(n)``'s shapes)."""
    from genfer_tpu.parallel import mesh as JM

    for n in (4, 8, 2, 1):
        jm = JM.make_mesh(n)
        dp = 2 if (n >= 4 and n % 2 == 0) else 1
        assert (jm.shape["dp"], jm.shape["tp"]) == (dp, n // dp)


# ------------------------------------------------------------ row windows


@pytest.mark.parametrize("c0,tp", [(64, 2), (200, 4), (256, 8), (308, 8),
                                   (100, 4), (12, 4), (1024, 8)])
def test_row_windows_cover_the_rows_on_the_tile_grid(c0, tp):
    """The windows cover [0, c0) in order, every rank gets rows, and the
    cuts lie on K1's tile grid where there are at least tp tiles."""
    windows = M.row_windows(c0, tp)
    assert len(windows) == tp and windows[0][0] == 0
    assert windows[-1][1] == c0
    assert all(r0 < r1 for r0, r1 in windows)
    assert all(a[1] == b[0] for a, b in zip(windows, windows[1:]))
    if -(-c0 // TILE) >= tp:
        assert all(r0 % TILE == 0 for r0, _ in windows)


# ------------------------------------------------------------- K1 window

WINDOW_SHAPES = [
    ((30, 20), (35, 20), (64, 39)),
    ((150, 40), (140, 30), (200, 60)),
    ((308, 1), (308, 27), (308, 27)),  # dense_t on the card
    ((70, 60), (2, 2), (71, 61)),  # the small body on the card
]


@pytest.mark.parametrize("rows", [(0, 1), (13, 40), (0, 64), (17, 18)])
@pytest.mark.parametrize("sa,sb,out", WINDOW_SHAPES)
def test_k1_window_is_the_plain_versions_rows(sa, sb, out, rows):
    """On the CPU the window runs the plain version from its first row:
    the whole product's rows, single pair and batched, at rtol 1e-13
    (the einsum's blocking may differ with the number of rows); nothing
    is launched."""
    K.reset_launches()
    a, b = torch.from_numpy(_rand(20, *sa)), torch.from_numpy(_rand(21, *sb))
    whole = K.conv2d_trunc_f64_reference(a, b, out)
    got = K.conv2d_trunc_f64(a, b, out, rows=rows)
    assert tuple(got.shape) == (rows[1] - rows[0], out[1])
    np.testing.assert_allclose(got.numpy(), whole[rows[0]:rows[1]].numpy(),
                               rtol=1e-13, atol=0)
    batched = K.conv2d_trunc_f64_batched(torch.stack([a, 2 * a]),
                                         torch.stack([b, b]), out, rows=rows)
    np.testing.assert_allclose(batched[1].numpy(), 2 * got.numpy(),
                               rtol=1e-13, atol=0)
    assert K.conv2d_trunc_f64.launches == 0


@pytest.mark.parametrize("rows", [(5, 5), (-1, 3), (0, 65), (9, 3)])
def test_k1_window_must_lie_in_the_output(rows):
    a = torch.rand(10, 10, dtype=torch.float64)
    with pytest.raises(ValueError, match="window"):
        K.conv2d_trunc_f64(a, a, (64, 10), rows=rows)


@pytest.mark.parametrize("sa,sb,out", WINDOW_SHAPES[:3])
def test_window_plans_partition_the_whole_plan(sa, sb, out):
    """The window plans of a tp = 4 split of the rows hold the whole
    plan's units of their tiles, in its order, and each tile's slots in
    slot order; their union is the whole plan's tiles."""
    from genfer_tpu_torch.ops.conv2d import unit_plan

    whole = unit_plan(sa, sb, out, False)
    seen = set()
    for r0, r1 in M.row_windows(out[0], 4):
        plan = window_plan(sa, sb, out, 0, r0, r1)
        tiles = {(int(u[0]), int(u[1])) for u in plan.units}
        seen |= tiles
        mine = [u for u in whole.units if (int(u[0]), int(u[1])) in tiles]
        assert [tuple(u[:6]) for u in plan.units] == [tuple(u[:6])
                                                      for u in mine]
        assert plan.slots == int(plan.sums[:, 3].sum()) if len(
            plan.sums) else plan.slots == 0
        for K0, K1_, first, n in plan.sums.tolist():
            (wrow,) = [r for r in whole.sums.tolist()
                       if (r[0], r[1]) == (K0, K1_)]
            slot = {tuple(u[2:6]): u[6] - first for u in plan.units
                    if (u[0], u[1]) == (K0, K1_)}
            wslot = {tuple(u[2:6]): u[6] - wrow[2] for u in whole.units
                     if (u[0], u[1]) == (K0, K1_)}
            assert slot == wslot and n == wrow[3]
    assert seen == {(int(u[0]), int(u[1])) for u in whole.units}

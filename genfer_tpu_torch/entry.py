"""The port's twins of the entry points in genfer_tpu's
``__graft_entry__.py``: ``entry()``, the one-step form of the f64 device
path, and ``dryrun_multichip(n)``, a real inference through the mesh.

    from genfer_tpu_torch.entry import entry
    forward, (a, b, y) = entry()          # on the CUDA card
    quot, total = forward(a, b, y)

``forward`` is one truncated-Taylor inference step at order 64: the
truncated 2-D Cauchy product of ``a`` and ``b`` (``_conv_impl``: K1 on the
card), the power-series division of the product by ``y`` along the
leading axis (a lower-triangular Toeplitz solve), and the total mass of
the quotient.  The operands come from a ``torch.Generator`` on the device,
seeded 0 (uniform in [0, 1)), and ``y = [2, 1, 1, ...]``: jax's random
bits cannot be drawn here, so a comparison with genfer_tpu runs the same
operands through both ``forward``s.

    from genfer_tpu_torch.entry import dryrun_multichip
    dryrun_multichip(4, device="cpu")     # 4 ranks over gloo on the CPU
    dryrun_multichip()                    # a rank a card, over NCCL

It prints genfer_tpu's ``dryrun_multichip stage ... OK`` lines (rank 0
only): see its docstring.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .taylor.backend import _conv_impl, _resolve_device, _toeplitz

ORDER = 64


def forward(a, b, y):
    """(quotient, total) of one step on the operands' device."""
    prod = _conv_impl(a, b, (ORDER, ORDER))
    T = _toeplitz(y, ORDER, ORDER)
    quot = torch.linalg.solve_triangular(T, prod, upper=False)
    return quot, quot.sum()


def entry(device=None):
    """``forward`` and its operands on ``device`` (``None``: the CUDA
    card, which must exist)."""
    device = _resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.rand((ORDER, ORDER), generator=gen, dtype=torch.float64,
                   device=device)
    b = torch.rand((ORDER, ORDER), generator=gen, dtype=torch.float64,
                   device=device)
    y = torch.ones(ORDER, dtype=torch.float64, device=device)
    y[0] = 2.0
    return forward, (a, b, y)


#: rows of stage 1c's halo product (genfer_tpu's "breaking order")
BIG_ROWS = 18432


def dryrun_multichip(n_devices: int | None = None, device=None,
                     big_rows: int = BIG_ROWS,
                     timeout_s: float = 900.0) -> None:
    """Run a real program inference through the mesh-sharded backend on
    ``n_devices`` ranks: gloo ranks on the CPU where ``device`` is
    ``"cpu"``, else a rank a card over NCCL (default: every card).  In a
    process of an initialized group it runs on that group; otherwise it
    forms a group of one rank in this process, or spawns the ranks
    (``parallel.mesh.spawn``).  The stages follow genfer_tpu's:

    1.  ``sharded_inference_step`` (dp-sharded batch, tp-sharded product,
        all-reduced totals) against ``_conv_impl`` at rtol 1e-12;
    1b. ``halo_conv_2d`` / ``halo_conv_nd`` and the col-chunked halo
        against ``_conv_impl``;
    1c. the halo product at (``big_rows``, 8) with a two-hot ``b``
        against the shift semantics, with each rank's peak device bytes
        beside K1's single-device peak on a card (genfer_tpu's stage
        asserts XLA's compiled temp of the dense product exceeds one TPU
        chip's memory: K1 builds no Toeplitz temp, so that fact does not
        carry over; the twin asserts only that the halo runs);
    2.  population(8, 3) through ``ShardedF64Backend`` with lowered
        thresholds against the host f64 backend at is_close; where tp > 1
        every route of the backend must have run;
    3.  the Poisson-chain scan model served through ``run_batch`` with
        the batch sharded over all ranks (``mesh=`` a dp mesh) against
        the unsharded call at rtol 1e-12.
    """
    import torch.distributed as dist

    from .parallel.mesh import close_group, init_group, rank_device, spawn

    if dist.is_initialized():
        return _dryrun(n_devices, device, big_rows)
    rank_device(device)  # raises where a card is asked for and none exists
    if n_devices is None:
        n_devices = 1 if device is not None else torch.cuda.device_count()
    if n_devices < 1:
        raise ValueError(f"dryrun_multichip needs a rank or more, "
                         f"not {n_devices}")
    if n_devices == 1:
        init_group(device)
        try:
            return _dryrun(1, device, big_rows)
        finally:
            close_group()
    spawn(_dryrun, n_devices, (n_devices, device, big_rows), device=device,
          timeout_s=timeout_s)


def _say(text: str) -> None:
    import torch.distributed as dist

    if dist.get_rank() == 0:
        print(text, flush=True)


def _close(got, want, what: str, rtol: float = 1e-12,
           atol: float = 0.0) -> None:
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, msg=what)


#: stage 2's thresholds: low enough that population(8, 3)'s tensors take
#: every sharded route at tp = 2 (genfer_tpu's dryrun lowers the first
#: four; its halo routes start at 1024 rows, which this model never
#: reaches)
DRYRUN_THRESHOLDS = dict(min_rows_per_device=2, conv_shard_flops=1000,
                         min_lanes_per_device=2, halo_min_rows=9)


def _dryrun(n_devices, device, big_rows):
    """The stages of ``dryrun_multichip`` on this rank."""
    from .gf.extract import moments_taylor, probs_taylor
    from .lang.parser import parse_program
    from .numbers.scalar import F64
    from .parallel.mesh import (
        ShardedF64Backend,
        halo_conv_2d,
        halo_conv_nd,
        make_mesh,
        sharded_inference_step,
    )
    from .semantics.gf_transformer import GfTransformer
    from .taylor.host import NumpyF64Backend
    from .tools.generators import generate_population

    mesh = make_mesh(n_devices, device=device)
    dev = mesh.device
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    gen = torch.Generator(device=dev).manual_seed(0)

    def uniform(*shape):
        # the same draws on every rank: the operands are replicated
        return torch.rand(shape, generator=gen, dtype=torch.float64,
                          device=dev)

    # -- stage 1: the batched inference step ----------------------------
    batch, out0, out1 = 2 * dp, 8 * tp, 15
    batch_a, batch_b = uniform(batch, 8, 8), uniform(batch, 8, 8)
    prod, totals = sharded_inference_step(mesh, batch_a, batch_b,
                                          (out0, out1))
    assert tuple(prod.shape) == (batch, out0, out1)
    assert tuple(totals.shape) == (batch,)
    for z in range(batch):
        ref = _conv_impl(batch_a[z], batch_b[z], (out0, out1))
        _close(prod[z], ref, f"stage 1 product {z}")
        _close(totals[z], ref.sum(), f"stage 1 total {z}")
    _say(f"dryrun_multichip stage 1 OK on mesh dp={dp} tp={tp}: prod "
         f"{tuple(prod.shape)}, totals {tuple(totals.shape)}")

    # -- stage 1b: the halo kernels (operand storage sharded) -----------
    n_halo = 16 * tp
    ha, hb = uniform(n_halo, 12), uniform(n_halo, 12)
    halo = halo_conv_2d(mesh, ha, hb, (n_halo, 12))
    ref_h = _conv_impl(ha, hb, (n_halo, 12))
    _close(halo, ref_h, "stage 1b halo_conv_2d")
    ha3, hb3 = uniform(n_halo, 6, 5), uniform(n_halo, 5, 4)
    halo3 = halo_conv_nd(mesh, ha3, hb3, (n_halo, 8, 6))
    _close(halo3, _conv_impl(ha3, hb3, (n_halo, 8, 6)),
           "stage 1b halo_conv_nd")
    _close(halo_conv_nd(mesh, ha, hb, (n_halo, 12), col_chunk=8), ref_h,
           "stage 1b col-chunked halo")
    _say(f"dryrun_multichip stage 1b OK: halo_conv_2d/nd (operand-sharded, "
         f"incl. col-chunked P-pair) {tuple(halo.shape)}/"
         f"{tuple(halo3.shape)} match single-device")

    # -- stage 1c: the halo product at a large order --------------------
    R, C = big_rows, 8
    a_big = uniform(R, C)
    b_hot = torch.zeros((R, C), dtype=torch.float64, device=dev)
    b_hot[0, 0], b_hot[R // 2, 3] = 1.0, 0.5
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    got = halo_conv_nd(mesh, a_big, b_hot, (R, C))
    if on_card:
        torch.cuda.synchronize(dev)
    halo_s = time.perf_counter() - t0
    want = a_big.clone()
    want[R // 2:, 3:] += 0.5 * a_big[:R - R // 2, :C - 3]
    _close(got, want, "stage 1c halo against the shift semantics")
    if on_card:
        halo_peak = torch.cuda.max_memory_allocated(dev) - base
        del got
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        from .ops.conv2d_f64 import conv2d_trunc_f64

        one = conv2d_trunc_f64(a_big, b_hot, (R, C))
        torch.cuda.synchronize(dev)
        k1_peak = torch.cuda.max_memory_allocated(dev) - base
        _close(one, want, "stage 1c K1 against the shift semantics")
        peaks = torch.tensor([halo_peak], dtype=torch.float64, device=dev)
        peaks = mesh.gather("tp", mesh.gather("dp", peaks))
        memory = (f"peak device bytes a rank above its inputs: halo "
                  f"{[int(x) for x in peaks.tolist()]}, K1 on one device "
                  f"{k1_peak}")
    else:
        memory = "peak device bytes: not measured (CPU ranks)"
    _say(f"dryrun_multichip stage 1c OK: order ({R}, {C}) halo conv, "
         f"shift-verified on the {dp * tp}-rank mesh in {halo_s:.3f} s, no "
         f"OOM; {memory}")

    # -- stage 2: a real SGCL inference through the sharded backend -----
    program = parse_program(generate_population(None, 8, 3))

    def run(backend):
        translation = GfTransformer(F64).semantics(program)
        gf = translation.gf.simplify(backend)
        total, moments = moments_taylor(
            gf, backend, program.result, translation.var_info, 5)
        probs = probs_taylor(gf, backend, program.result,
                             translation.var_info, 8)
        return total, moments, probs

    sharded = ShardedF64Backend(mesh, **DRYRUN_THRESHOLDS)
    z_sh, m_sh, p_sh = run(sharded)
    z_np, m_np, p_np = run(NumpyF64Backend())
    for a, b in zip([z_sh, *m_sh, *p_sh], [z_np, *m_np, *p_np]):
        assert a.is_close(b), f"sharded {a} != host {b}"
    if tp > 1:
        # population calls no 1-axis product and no division: those two
        # routes run on seeded operands, against the host backend
        host = NumpyF64Backend()
        x1, y1 = uniform(64), uniform(48)
        _close(sharded.conv_trunc(x1, y1, (64,)), torch.from_numpy(
            host.conv_trunc(x1.cpu().numpy(), y1.cpu().numpy(), (64,))
        ).to(dev), "stage 2 1-axis product", rtol=1e-11)
        xs = uniform(24, 17, 3)
        ys = torch.zeros((24, 1, 1), dtype=torch.float64, device=dev)
        ys[:, 0, 0] = uniform(24) + 0.5
        _close(sharded.poly_div(xs, ys, (24, 17, 3)), torch.from_numpy(
            host.poly_div(xs.cpu().numpy(), ys.cpu().numpy(), (24, 17, 3))
        ).to(dev), "stage 2 lane-sharded division", rtol=1e-10, atol=1e-12)
        missed = [r for r, n in sharded.routes.items() if n == 0]
        assert not missed, f"routes never taken: {missed}"
    _say(f"dryrun_multichip stage 2 OK: population(8, 3vars) through "
         f"ShardedF64Backend at is_close of host f64, routes "
         f"{sharded.routes}")

    # -- stage 3: dp-sharded scan-compiled serving over every rank ------
    from .scanc import compile_scan_program

    n = dp * tp
    n_obs = 12
    counts = [1, 3, 0, 2, 4, 1, 0, 2, 3, 1, 2, 0]
    src = "X ~ Poisson(5);\n" + "".join(
        f"observe {c} ~ Poisson(1/2 * X);\n" for c in counts[:n_obs]
    ) + "return X"
    obj, _ = compile_scan_program(parse_program(src), order=64,
                                  max_steps=n_obs, device=dev)
    assert obj.rep is not None and obj.rep.n_iters == n_obs, (
        "repetition detection must fold the observe blocks into a scan")
    B = 4 * n
    bc = np.random.default_rng(0).integers(0, 6, size=(B, n_obs)).astype(
        np.float64)
    dp_mesh = make_mesh(n, dp=n, device=dev)
    masses_ref, totals_ref = obj.run_batch([bc])
    t0 = time.perf_counter()
    masses_sh, totals_sh = obj.run_batch([bc], mesh=dp_mesh)
    dt_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    masses_sh, totals_sh = obj.run_batch([bc], mesh=dp_mesh)
    dt = time.perf_counter() - t0
    np.testing.assert_allclose(masses_sh, masses_ref, rtol=1e-12)
    np.testing.assert_allclose(totals_sh, totals_ref, rtol=1e-12)
    _say(f"dryrun_multichip stage 3 OK: scan-compiled Poisson-chain "
         f"serving, batch {B} dp-sharded over {n} ranks ({B // n}/rank), "
         f"parity with unsharded dispatch at rtol 1e-12; steady "
         f"{dt * 1e3:.1f} ms = {B / dt:.0f} inferences/s (warm "
         f"{dt_warm * 1e3:.0f} ms)")

    mean = m_sh[0]
    _say(f"dryrun_multichip OK on mesh dp={dp} tp={tp}: population(8, "
         f"3vars) posterior through --backend sharded matches host: Z = "
         f"{z_sh.display()}, E = {mean.display()}, p(0..4) = "
         f"[{', '.join(p.display() for p in p_sh[:5])}]")


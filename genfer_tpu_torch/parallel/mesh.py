"""Device-mesh sharding of the Taylor engine on ``torch.distributed``: the
twin of ``genfer_tpu.parallel.mesh``.

Coefficient tensors of ``O(order^num_vars)`` elements are sharded over
mesh axes and the truncated Cauchy products split into blocks:

* ``dp``: data parallel over independent evaluation points / programs,
* ``tp``: tensor parallel over blocks of the *output* coefficient axis
  (operands replicated), or over operand rows (``sharded_conv_nd``, the
  halo kernels).

JAX drives a ``jax.sharding.Mesh`` from one process through
``shard_map``; here every device is one process, one rank of the default
process group (gloo on the CPU, NCCL on cards), and:

* every rank runs the whole program (parse, GF translation, evaluation),
  so the operands of a sharded op are the same on every rank, and each op
  returns the whole result on every rank (what ``out_specs=P("tp")`` hands
  the single controller);
* each routine is a per-rank *local body*, a plain function of the rank's
  coordinates and tensors (``conv_1d_block``, ``conv_2d_block``,
  ``conv_nd_block``, ``halo_local_conv`` with ``halo_keep`` /
  ``halo_take``, ``div_lanes_block``, ``inference_block``), and the
  collectives around it (``all_gather``, ``all_reduce``, ``broadcast``
  and ``batch_isend_irecv`` rings; ``halo_blocks`` is the halo's
  schedule before its all-gather);
* the 2-axis local bodies run K1 (``ops.conv2d_f64``) with its output-row
  window on a card, each rank its own rows (``row_windows``: on K1's tile
  grid where every rank gets rows); the JAX bodies are XLA einsums over a
  Toeplitz tensor, dense in the row block.

``ShardedF64Backend`` keeps the JAX backend's routes, gates and
constructor arguments but one, and counts the calls of each route
(``routes``).  JAX's shape bucketing (``shape_bucket``) bounds
``shard_map`` compiles; eager torch compiles nothing, so nothing is
bucketed and there is no such argument: rows are padded to a multiple
of tp only.
"""

from __future__ import annotations

import atexit
import datetime
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..ops.conv2d import TILE, _even_cuts
from ..ops.conv2d_f64 import conv2d_trunc_f64, conv2d_trunc_f64_batched
from ..taylor.backend import TorchF64Backend, _conv_impl, _div1d, _toeplitz
from ..taylor.host import _conv_pair_flops, _effective_axes, _norm_shape

#: seconds the forming of a group, and each collective, may take before
#: it raises (``init_process_group(timeout=...)``)
TIMEOUT_S = 300.0


# ===================================================================
# the process group and the mesh
# ===================================================================

def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` by default, else ``device``
    as given (``"cpu"`` for gloo); a CUDA device must exist."""
    dev = (torch.device(device) if device is not None
           else torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))))
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the mesh needs one a rank (pass device='cpu' "
            "to run the ranks on the CPU over gloo)"
        )
    return dev


def _backend(device: torch.device) -> str:
    return "gloo" if device.type == "cpu" else "nccl"


def init_group(device=None) -> torch.device:
    """Form the default process group unless it exists, and return this
    rank's device (``rank_device``).  Under ``torchrun`` the group comes
    from its environment (``env://``: RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT); without it, this process is a group of one rank, met
    through a ``FileStore`` in a fresh temporary directory (no network),
    destroyed at exit.  Gloo serves the CPU, NCCL a card."""
    dev = rank_device(device)
    if dist.is_initialized():
        return dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(_backend(dev), init_method="env://",
                                timeout=timeout)
    else:
        _STORE.append(tempfile.mkdtemp(prefix="genfer_group_"))
        dist.init_process_group(
            _backend(dev), init_method=f"file://{_STORE[-1]}/store", rank=0,
            world_size=1, timeout=timeout)
    atexit.register(close_group)
    return dev


#: the store directory of a group ``init_group`` formed alone
_STORE: list = []


def close_group() -> None:
    """Destroy the default process group, if any, and remove the store
    directory ``init_group`` made for it."""
    import shutil

    if dist.is_initialized():
        dist.destroy_process_group()
    while _STORE:
        shutil.rmtree(_STORE.pop(), ignore_errors=True)


def launched_ranks() -> int:
    """Ranks of the group this process belongs to or was launched into
    (``torchrun`` sets WORLD_SIZE); 1 outside any."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


class Mesh:
    """A (dp, tp) mesh over the default process group: rank ``d * tp +
    t`` sits at (d, t), as ``np.array(devices).reshape(dp, tp)`` places
    the devices of genfer_tpu's mesh.  ``shape[axis]``, this rank's
    ``coords[axis]``, the group along each axis (``groups[axis]``, its
    global ranks ``ranks[axis]`` in coordinate order) and ``device``."""

    def __init__(self, dp: int, tp: int, device: torch.device):
        rank = dist.get_rank()
        self.shape = {"dp": dp, "tp": tp}
        self.coords = {"dp": rank // tp, "tp": rank % tp}
        self.device = device
        # every rank makes every group, in the same order (new_group's
        # rule)
        rows = [list(range(d * tp, (d + 1) * tp)) for d in range(dp)]
        cols = [list(range(t, dp * tp, tp)) for t in range(tp)]
        row_groups = [dist.new_group(r) for r in rows]
        col_groups = [dist.new_group(c) for c in cols]
        d, t = self.coords["dp"], self.coords["tp"]
        self.groups = {"tp": row_groups[d], "dp": col_groups[t]}
        self.ranks = {"tp": rows[d], "dp": cols[t]}

    # -- collectives (each a no-op along an axis of one rank) -----------
    def gather(self, axis: str, x, dim: int = 0):
        """``x`` of every rank along ``axis``, concatenated along ``dim``
        in coordinate order (the same shape on every rank)."""
        if self.shape[axis] == 1:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(parts, x, group=self.groups[axis])
        return torch.cat(parts, dim)

    def gather_rows(self, axis: str, x, lengths, dim: int = 0):
        """``gather`` of blocks whose lengths along ``dim`` are
        ``lengths[coordinate]``: each padded to the longest, then cut."""
        n = max(lengths)
        pad = [0, 0] * (x.ndim - 1 - dim) + [0, n - x.shape[dim]]
        out = self.gather(axis, F.pad(x, pad), dim)
        return torch.cat([out.narrow(dim, i * n, m)
                          for i, m in enumerate(lengths)], dim)

    def all_reduce(self, axis: str, x):
        """The sum of ``x`` over the ranks along ``axis`` (psum), in
        place."""
        if self.shape[axis] > 1:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.groups[axis])
        return x

    def broadcast(self, axis: str, x, src: int):
        """``x`` of the rank at coordinate ``src`` along ``axis``, into
        ``x`` of every rank."""
        if self.shape[axis] > 1:
            dist.broadcast(x, src=self.ranks[axis][src],
                           group=self.groups[axis])
        return x

    def shift(self, axis: str, x, step: int):
        """The ring permutation along ``axis``: each rank sends ``x`` to
        the coordinate ``step`` above its own and returns what the rank
        ``step`` below sent (``ppermute`` over ``(i, i + step)``)."""
        n = self.shape[axis]
        if n == 1:
            return x
        me, ranks, group = self.coords[axis], self.ranks[axis], \
            self.groups[axis]
        out = torch.empty_like(x)
        reqs = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, x.contiguous(), ranks[(me + step) % n],
                       group),
            dist.P2POp(dist.irecv, out, ranks[(me - step) % n], group),
        ])
        for req in reqs:
            req.wait()
        return out


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              device=None) -> Mesh:
    """A (dp, tp) mesh over the default process group (formed by
    ``init_group`` where it does not exist): ``n_devices`` must be its
    size where given; dp defaults to 2 on an even group of >= 4 ranks,
    else 1, as in genfer_tpu.  ``device``: as ``rank_device``."""
    dev = init_group(device)
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh of {n_devices} devices on a group of {n} "
                         "ranks: every rank is one device")
    if dp is None:
        dp = 2 if (n >= 4 and n % 2 == 0) else 1
    tp = n // dp
    if dp * tp != n:
        raise ValueError(f"mesh {dp}x{tp} does not cover {n} devices")
    return Mesh(dp, tp, dev)


# ===================================================================
# the sharded routines and their local bodies
# ===================================================================

def row_windows(c0: int, tp: int) -> list[tuple[int, int]]:
    """The output rows [r0, r1) of each of ``tp`` ranks: cut on K1's tile
    grid (``TILE`` rows) where every rank then gets rows, else into
    near-equal blocks (``c0 / tp`` rows where tp divides c0)."""
    step = TILE if -(-c0 // TILE) >= tp else 1
    return _even_cuts(0, c0, tp, step)


def conv_1d_block(a, b, out_len: int, tp: int, r: int):
    """Rank ``r``'s local body of ``sharded_conv_1d``: output rows [r B,
    (r + 1) B), B = out_len / tp, as the Toeplitz block of ``a`` times
    ``b`` (one ``torch.matmul``, as JAX computes it in XLA)."""
    block = out_len // tp
    return _toeplitz(a, block, b.shape[0], start=r * block) @ b


def sharded_conv_1d(mesh: Mesh, a, b, out_len: int):
    """Truncated 1-D Cauchy product with the output rows sharded over the
    ``tp`` mesh axis; inputs replicated (they are O(n) vs O(n^2)
    compute)."""
    tp = mesh.shape["tp"]
    assert out_len % tp == 0, "out_len must divide the tp axis"
    return mesh.gather("tp", conv_1d_block(a, b, out_len, tp,
                                           mesh.coords["tp"]))


def conv_2d_block(a, b, out_shape, tp: int, r: int):
    """Rank ``r``'s local body of ``sharded_conv_2d``: its rows
    ``row_windows(c0, tp)[r]`` of the truncated product, K1 with that row
    window (on the CPU its plain version)."""
    rows = row_windows(int(out_shape[0]), tp)[r]
    return conv2d_trunc_f64(a.contiguous(), b.contiguous(), out_shape,
                            rows=rows)


def sharded_conv_2d(mesh: Mesh, a, b, out_shape):
    """Truncated 2-D Cauchy product, output rows (axis 0) sharded over
    ``tp``: each rank computes its row window (``conv_2d_block``), then
    an all-gather over tp."""
    c0, c1 = (int(s) for s in out_shape)
    tp = mesh.shape["tp"]
    assert c0 % tp == 0
    block = conv_2d_block(a, b, (c0, c1), tp, mesh.coords["tp"])
    return mesh.gather_rows("tp", block,
                            [r1 - r0 for r0, r1 in row_windows(c0, tp)])


def conv_nd_block(a_blk, b, out_shape, r: int):
    """Rank ``r``'s local body of ``sharded_conv_nd``: the product of
    ``a``'s leading-axis block ``a_blk`` (rows [r blk, (r + 1) blk) of
    the padded operand) with ``b``, at its rows of the ``out_shape``
    output and zero elsewhere: ``_conv_impl`` (K1 where it has two
    effective axes), truncated at the output's last row."""
    out = a_blk.new_zeros(tuple(out_shape))
    lo = r * a_blk.shape[0]
    n = min(a_blk.shape[0] + b.shape[0] - 1, int(out_shape[0]) - lo)
    if n > 0:
        out[lo:lo + n] = _conv_impl(a_blk.contiguous(), b,
                                    (n,) + tuple(out_shape[1:]))
    return out


def sharded_conv_nd(mesh: Mesh, a, b, out_shape):
    """Truncated n-D Cauchy product with the *first operand's* leading
    axis sharded over ``tp``: each rank convolves its row block of ``a``
    with the replicated ``b`` and the partial outputs are summed
    (``all_reduce``, the psum).  Works for any ndim; compute splits
    1/tp per rank while communication is one reduction of the output."""
    tp, r = mesh.shape["tp"], mesh.coords["tp"]
    out_shape = tuple(int(s) for s in out_shape)
    blk = -(-a.shape[0] // tp)
    return mesh.all_reduce("tp", conv_nd_block(_pad_rows(a[r * blk:], blk),
                                               b, out_shape, r))


def halo_local_conv(a_vis, b_loc, out_shape, tp: int, col_chunk=None):
    """The local product of one step of the halo schedule: the visiting
    block ``a_vis`` (B rows) times this rank's ``b_loc`` (B rows), to 2B
    - 1 output rows, trailing axes truncated to ``out_shape[1:]``.  As in
    genfer_tpu: a's axis 1 in tp chunks of ``ceil(a1 / tp)`` columns,
    each one ``_conv_impl``; or, with ``col_chunk``, both operands' axis 1
    in chunks of at most ``col_chunk`` columns, one product a pair of
    chunks whose output starts below c1 (the P-pair decomposition of
    ``ops.blocked_conv``)."""
    B = a_vis.shape[0]
    c1, tail = int(out_shape[1]), tuple(out_shape[2:])
    a1, b1 = a_vis.shape[1], b_loc.shape[1]
    W = -(-a1 // tp)
    if not col_chunk:
        full = a_vis.new_zeros((2 * B - 1, c1) + tail)
        for t in range(tp):
            lo = t * W
            if lo >= a1 or lo >= c1:
                break
            hi = min(a1, lo + W)
            wlen = min(hi - lo + b1 - 1, c1 - lo)
            full[:, lo:lo + wlen] += _conv_impl(
                a_vis[:, lo:hi].contiguous(), b_loc, (2 * B - 1, wlen) + tail)
        return full
    Wa, Wb = min(max(W, 1), col_chunk), min(b1, col_chunk)
    na, nb = -(-min(a1, c1) // Wa), -(-b1 // Wb)
    ap = F.pad(a_vis[:, :min(a1, c1)], [0, 0] * len(tail)
               + [0, na * Wa - min(a1, c1)])
    bp = F.pad(b_loc, [0, 0] * len(tail) + [0, nb * Wb - b1])
    wpart = Wa + Wb - 1
    fullp = a_vis.new_zeros((2 * B - 1, c1 + wpart) + tail)
    for ia in range(na):
        for ib in range(nb):
            oa, ob = ia * Wa, ib * Wb
            if oa + ob >= c1:
                continue
            fullp[:, oa + ob:oa + ob + wpart] += _conv_impl(
                ap[:, oa:oa + Wa].contiguous(),
                bp[:, ob:ob + Wb].contiguous(), (2 * B - 1, wpart) + tail)
    return fullp[:, :c1]


def halo_keep(acc, full, r: int, s: int, tp: int):
    """Step ``s`` of rank ``r`` after its local product ``full`` (2B - 1
    rows, spanning output blocks r + s and r + s + 1): the first B rows
    added to the resident accumulator, and the spill, the rest, to send
    one rank up; both only where block r + s exists (r + s < tp)."""
    B = acc.shape[0]
    if r + s < tp:
        return acc + full[:B], full[B:]
    return acc, torch.zeros_like(full[B:])


def halo_take(acc, spill, r: int, s: int, tp: int):
    """The spill rank ``r`` received at step ``s`` (from rank r - 1: part
    of its block r + s) added to the first B - 1 rows of its accumulator;
    rank 0's wrapped from tp - 1 (block tp + s: always truncated)."""
    if r > 0 and r + s < tp:
        return acc + F.pad(spill, [0, 0] * (spill.ndim - 1) + [0, 1])
    return acc


def halo_conv_nd(mesh: Mesh, a, b, out_shape, col_chunk=None):
    """Truncated n-D Cauchy product with *operand storage* sharded: the
    schedule holds only this rank's row blocks of ``a``, ``b`` and the
    output (B = rows / tp rows each).

    Systolic schedule over ``tp`` steps; at step ``s`` rank ``r`` holds
    the accumulator block ``K = r + s`` (blocks rotate one rank down a
    step) and the visiting operand block ``a_s`` (broadcast from rank s):

        P = a_s (*) b_r          spans output blocks K, K+1
        acc_K   += P[:B]         resident (masked when K >= tp)
        acc_K+1 += P[B:]         one-neighbour halo spill (ring r -> r+1)
        acc      rotates r -> r-1

    After ``tp`` steps every accumulator is back home (``halo_blocks``);
    an all-gather over tp returns the whole product on every rank.  Per
    step three O(block) transfers: the broadcast, the spill and the
    rotation (both ``batch_isend_irecv`` rings)."""
    return mesh.gather("tp", halo_blocks(mesh, a, b, out_shape, col_chunk))


def halo_blocks(mesh: Mesh, a, b, out_shape, col_chunk=None, held=None):
    """The schedule of ``halo_conv_nd`` on this rank: its output row
    block.  A dict ``held`` receives the shapes of the tensors the
    schedule held here (``a``, ``b``, ``acc``, ``a_vis``, ``full``,
    ``spill``)."""
    out_shape = tuple(int(x) for x in out_shape)
    c0, rest = out_shape[0], out_shape[1:]
    tp, r = mesh.shape["tp"], mesh.coords["tp"]
    assert c0 % tp == 0, "out rows must divide the tp axis"
    B = c0 // tp
    a_loc = _pad_rows(a[r * B:], B).contiguous()
    b_loc = _pad_rows(b[r * B:], B).contiguous()
    acc = a_loc.new_zeros((B,) + rest)
    for s in range(tp):
        a_vis = mesh.broadcast("tp", a_loc.clone() if r == s
                               else torch.empty_like(a_loc), s)
        full = halo_local_conv(a_vis, b_loc, out_shape, tp, col_chunk)
        acc, spill = halo_keep(acc, full, r, s, tp)
        spill = mesh.shift("tp", spill, 1)
        acc = mesh.shift("tp", halo_take(acc, spill, r, s, tp), -1)
    if held is not None:
        held.update({k: tuple(v.shape) for k, v in dict(
            a=a_loc, b=b_loc, acc=acc, a_vis=a_vis, full=full,
            spill=spill).items()})
    return acc


#: 2-D entry point kept for existing callers (tests, dryrun stage 1b)
halo_conv_2d = halo_conv_nd


def div_lanes_block(x_blk, y, n: int):
    """A rank's local body of ``sharded_div_lanes``: the lower-triangular
    Toeplitz solve of its lanes (columns of ``x_blk``, n rows) by the
    series ``y`` (``_div1d``)."""
    return _div1d(x_blk, y, (n, x_blk.shape[1]), 0)


def sharded_div_lanes(mesh: Mesh, xs, ys, out_shape, axis: int):
    """Power-series division along one effective axis, with the *other*
    lanes sharded over ``tp``: the triangular solve is sequential only
    along ``axis``; every other lane is independent.  All-gathered over
    tp."""
    tp, r = mesh.shape["tp"], mesh.coords["tp"]
    n = int(out_shape[axis])
    yvec = ys.movedim(axis, 0).reshape(ys.shape[axis])
    xmat = xs.movedim(axis, 0).reshape(xs.shape[axis], -1)
    pad = n - xmat.shape[0]
    xmat = F.pad(xmat, (0, 0, 0, pad)) if pad > 0 else xmat[:n]
    lanes = xmat.shape[1]
    per = -(-lanes // tp)
    xmat = F.pad(xmat, (0, per * tp - lanes))
    sol = mesh.gather("tp", div_lanes_block(
        xmat[:, r * per:(r + 1) * per].contiguous(), yvec, n), dim=1)
    inter_sq = [s for i, s in enumerate(out_shape) if i != axis]
    return sol[:, :lanes].reshape([n] + inter_sq).movedim(0, axis)


def inference_block(a_blk, b_blk, out_shape, tp: int, r: int):
    """A rank's local body of ``sharded_inference_step``: its row window
    (``row_windows``) of every product of its batch slice, one batched
    K1 launch with the window, and the window's partial total masses."""
    rows = row_windows(int(out_shape[0]), tp)[r]
    prod = conv2d_trunc_f64_batched(a_blk.contiguous(), b_blk.contiguous(),
                                    out_shape, rows=rows)
    return prod, prod.sum(dim=(1, 2))


def sharded_inference_step(mesh: Mesh, batch_a, batch_b, out_shape):
    """One full sharded inference step on a batch of 2-D coefficient
    tensors: dp-sharded batch, tp-sharded Cauchy product, followed by the
    marginalization reduction ``evaluate_all_one`` (sum of all
    coefficients) as an all-reduce over tp.

    Returns (products, totals): the batched truncated products and their
    total masses, all-gathered over tp and dp."""
    c0, c1 = (int(s) for s in out_shape)
    tp, dp = mesh.shape["tp"], mesh.shape["dp"]
    assert c0 % tp == 0 and batch_a.shape[0] % dp == 0
    per = batch_a.shape[0] // dp
    d = mesh.coords["dp"]
    prod, part = inference_block(batch_a[d * per:(d + 1) * per],
                                 batch_b[d * per:(d + 1) * per], (c0, c1),
                                 tp, mesh.coords["tp"])
    totals = mesh.all_reduce("tp", part)
    prod = mesh.gather_rows("tp", prod,
                            [r1 - r0 for r0, r1 in row_windows(c0, tp)],
                            dim=1)
    return mesh.gather("dp", prod), mesh.gather("dp", totals)


# ===================================================================
# the backend
# ===================================================================

def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def _pad_rows(x, rows: int):
    """``x`` cut or zero-padded to ``rows`` leading rows (operand rows at
    or past the output's never reach the truncated product)."""
    x = x[:rows]
    return F.pad(x, [0, 0] * (x.ndim - 1) + [0, rows - x.shape[0]])


class ShardedF64Backend(TorchF64Backend):
    """``TorchF64Backend`` whose large Cauchy products and 1-axis solves
    run sharded over a device mesh (output-row blocks, operand rows or
    lanes on the ``tp`` axis).  Small ops stay on this rank's device; the
    crossovers are genfer_tpu's (sized for TPU chips: only a machine of
    several cards can re-measure them).

    Multivariate (>= 2 effective axes) div, exp and log are Newton-lifted
    into truncated convolutions and so shard through ``conv_trunc``;
    1-axis exp / log have one lane and stay local; 1-axis div shards its
    independent lanes (``sharded_div_lanes``).

    Construct with ``ShardedF64Backend(make_mesh())`` or let the CLI
    build it (``--backend sharded``).  ``routes`` counts the calls of
    each sharded route."""

    #: minimum multiply-adds before a >= 3-axis conv is worth sharding
    CONV_SHARD_FLOPS = 4_000_000
    #: minimum independent lanes per rank for the sharded solve
    MIN_LANES_PER_DEVICE = 8
    #: column-chunk width of the halo's P-pair decomposition (applied
    #: when out cols > 2x this)
    HALO_COL_CHUNK = 512
    #: output rows from which the operand-sharded halo kernel replaces
    #: the replicated-operand kernel
    HALO_MIN_ROWS = 1024
    #: the routes ``routes`` counts
    ROUTES = ("halo_2d", "conv_2d", "conv_1d", "halo_nd", "conv_nd",
              "div_lanes")

    def __init__(self, mesh: Mesh | None = None,
                 min_rows_per_device: int = 64,
                 conv_shard_flops: int | None = None,
                 min_lanes_per_device: int | None = None,
                 halo_min_rows: int | None = None, device=None):
        self.mesh = mesh or make_mesh(device=device)
        super().__init__(self.mesh.device)
        self.min_rows = min_rows_per_device
        self.conv_shard_flops = (self.CONV_SHARD_FLOPS
                                 if conv_shard_flops is None
                                 else conv_shard_flops)
        self.min_lanes_per_device = (self.MIN_LANES_PER_DEVICE
                                     if min_lanes_per_device is None
                                     else min_lanes_per_device)
        self.halo_min_rows = (self.HALO_MIN_ROWS if halo_min_rows is None
                              else halo_min_rows)
        self.routes = dict.fromkeys(self.ROUTES, 0)

    def conv_trunc(self, a, b, out_shape):
        out_shape = _norm_shape(out_shape)
        tp = self.mesh.shape["tp"]
        eff = _effective_axes(out_shape)
        if tp > 1 and len(eff) == 2 and eff[0] == 0:
            rows = _round_up(out_shape[0], tp)
            cols = out_shape[eff[1]]
            a2 = a.reshape(a.shape[0], -1)
            b2 = b.reshape(b.shape[0], -1)
            if out_shape[0] >= self.halo_min_rows:
                # memory-scaled path: operand storage sharded 1/tp
                self.routes["halo_2d"] += 1
                cc = (self.HALO_COL_CHUNK
                      if cols > 2 * self.HALO_COL_CHUNK else None)
                out = halo_conv_2d(self.mesh, _pad_rows(a2, rows),
                                   _pad_rows(b2, rows), (rows, cols),
                                   col_chunk=cc)
                return out[:out_shape[0]].reshape(out_shape)
            if out_shape[0] >= tp * self.min_rows:
                self.routes["conv_2d"] += 1
                out = sharded_conv_2d(self.mesh, a2, b2, (rows, cols))
                return out[:out_shape[0]].reshape(out_shape)
        if (tp > 1 and len(eff) == 1
                and out_shape[eff[0]] >= tp * 4 * self.min_rows):
            self.routes["conv_1d"] += 1
            n = out_shape[eff[0]]
            out = sharded_conv_1d(self.mesh, a.reshape(-1), b.reshape(-1),
                                  _round_up(n, tp))
            return out[:n].reshape(out_shape)
        if (tp > 1 and len(eff) >= 3
                and _conv_pair_flops(tuple(a.shape), tuple(b.shape),
                                     out_shape) >= self.conv_shard_flops):
            a_sq = a.reshape([a.shape[i] for i in eff])
            b_sq = b.reshape([b.shape[i] for i in eff])
            eff_out = tuple(out_shape[i] for i in eff)
            if eff_out[0] >= self.halo_min_rows:
                # memory-scaled n-D path: operand storage 1/tp
                self.routes["halo_nd"] += 1
                rows = _round_up(eff_out[0], tp)
                out = halo_conv_nd(self.mesh, _pad_rows(a_sq, rows),
                                   _pad_rows(b_sq, rows),
                                   (rows,) + eff_out[1:])
                return out[:eff_out[0]].reshape(out_shape)
            # shard the larger operand's leading axis
            if b_sq.shape[0] > a_sq.shape[0]:
                a_sq, b_sq = b_sq, a_sq
            if a_sq.shape[0] >= tp:
                self.routes["conv_nd"] += 1
                out = sharded_conv_nd(self.mesh, a_sq, b_sq, eff_out)
                return out.reshape(out_shape)
        return super().conv_trunc(a, b, out_shape)

    def poly_div(self, xs, ys, out_shape):
        out_shape = _norm_shape(out_shape)
        tp = self.mesh.shape["tp"]
        eff_ys = _effective_axes(tuple(ys.shape))
        if tp > 1 and len(eff_ys) == 1:
            axis = eff_ys[0]
            lanes = int(np.prod([s for i, s in enumerate(out_shape)
                                 if i != axis]))
            if lanes >= tp * self.min_lanes_per_device:
                self.routes["div_lanes"] += 1
                return sharded_div_lanes(self.mesh, xs, ys, out_shape, axis)
        return super().poly_div(xs, ys, out_shape)


# ===================================================================
# the launcher
# ===================================================================

def _rank_main(rank, fn, args, n_ranks, device, store_dir, timeout_s):
    """One spawned rank: join the group (gloo on the CPU, NCCL on card
    ``rank``), run ``fn(*args)``, save its result for the parent."""
    os.environ["LOCAL_RANK"] = str(rank)
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n_ranks))
    dist.init_process_group(
        _backend(dev), init_method=f"file://{store_dir}/store", rank=rank,
        world_size=n_ranks, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(*args)
        torch.save(out, os.path.join(store_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn, n_ranks: int, args=(), device=None, store_dir=None,
          timeout_s: float = TIMEOUT_S) -> list:
    """Run ``fn(*args)`` on ``n_ranks`` new processes, one rank each of a
    process group met through a ``FileStore`` in ``store_dir`` (a fresh
    temporary directory by default): gloo where ``device`` is ``"cpu"``,
    else NCCL with rank k on ``cuda:k``.  Returns each rank's return value
    (``torch.save``-able) in rank order.  A rank that raises fails the
    call; ranks still running after ``timeout_s`` seconds are killed and
    the call raises ``TimeoutError``.  ``fn`` must be importable by name
    (the ranks start fresh interpreters).  A store directory made here is
    removed at the end."""
    import shutil

    import torch.multiprocessing as mp

    own = store_dir is None
    store_dir = str(store_dir or tempfile.mkdtemp(prefix="genfer_spawn_"))
    os.makedirs(store_dir, exist_ok=True)
    try:
        return _spawned(mp, fn, n_ranks, args, device, store_dir, timeout_s)
    finally:
        if own:
            shutil.rmtree(store_dir, ignore_errors=True)


def _spawned(mp, fn, n_ranks, args, device, store_dir, timeout_s):
    ctx = mp.start_processes(
        _rank_main, args=(fn, tuple(args), n_ranks, device, store_dir,
                          timeout_s),
        nprocs=n_ranks, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(
                f"{n_ranks} ranks of {getattr(fn, '__name__', fn)} still "
                f"running after {timeout_s} s")
    return [torch.load(os.path.join(store_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(n_ranks)]

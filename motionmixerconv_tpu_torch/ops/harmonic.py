"""Fused harmonic embedding x Dense: the CUDA kernels' wrappers (forward and
backward), their autograd Function and their plain PyTorch versions.

Counterpart of ``make_fused_harmonic_dense`` in
``motionmixerconv_tpu/ops/pallas_harmonic.py``. The kernel
(``csrc/harmonic_dense.cu``) computes ``embed_mlp(harmonic_features(x))``
without writing the (R, 2nD) embedding to device memory. It takes the
weights i-major, (2, n, D, E): ``reorder_weight`` turns torch's (E, 2nD)
``embed_mlp.weight`` (feature index s*nD + d*n + i) into that layout, and
``PoseEncoder`` keeps the result in eval mode until the parameter changes,
so a serving call launches only the kernel. The backward kernels compute dW (straight into
torch's layout), db and, only when the input needs a gradient, dx; the
plain backward writes the same formula out rather than differentiating
``harmonic_features``, whose doubling recurrence autograd would
differentiate step by step to another gradient.

``fwd_plan`` and ``bwd_plan`` decide each launch from the shapes alone:
groups of harmonics (forward, dx) or chunks of rows (dW) that fill the
card's SMs, and the scratch for the partial sums, which the kernels add
in a fixed order (two launches give identical bits).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from ..models.encoding import harmonic_features
from ._build import MAX_SMEM_BYTES, Counter, check, load_library, stream_ptr

LAUNCHES = Counter()      # forward kernel launches (CUDA tensors)
LAUNCHES_BWD = Counter()  # backward kernel launches (CUDA tensors)
PLAIN_CALLS = Counter()   # forward or backward calls served by a plain
                          # version (CPU tensors)

IMPLS = ("direct", "doubling")

# The kernels' tiles (csrc/harmonic_dense.cu; chip_smoke.py checks that the
# library agrees). Forward: blocks of FWD_ROWS rows x up to FWD_MAX_COLS
# columns, FWD_THREADS threads of 4 x 4 outputs. dW: tiles of DW_ROWS rows,
# 4 features x 4 columns a thread, at most MAX_THREADS threads. dx: blocks
# of DX_ROWS rows, 4 rows of one input a thread, in groups of harmonics as
# the forward.
FWD_ROWS = 32
FWD_MAX_COLS = 64
FWD_THREADS = 256  # two halves: the sin and the cos rows of each harmonic
DW_ROWS = 32
MAX_THREADS = 1024
FINISH_THREADS = 1024  # dW's finishing launch
DX_ROWS = 16
SM_SMEM_BYTES = 233472  # shared memory of one H100 SM; each block also
                        # reserves 1 KB of it
PLAN_BLOCKS_PER_SM = 2  # resident blocks a plan counts on, to hide latency
FULL_WAVES = 0.9        # a plan within this share of the best wave
                        # efficiency is as good as the best


def device_launches() -> tuple:
    """(forward, dW) kernel launches the current CUDA device has run since
    the library was loaded, as the kernels count them on the device:
    replays of a captured CUDA graph included, which ``LAUNCHES`` and
    ``LAUNCHES_BWD`` (counted where a wrapper launches) cannot see. Waits
    for the device; callers read differences."""
    lib = load_library()
    out = (ctypes.c_ulonglong * 2)()
    torch.cuda.synchronize()
    check(lib, lib.mmc_harmonic_device_launches(ctypes.addressof(out)),
          "harmonic kernels' device launch counts")
    return int(out[0]), int(out[1])


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class FwdPlan:
    """How the forward kernel covers (R, D, E, n): ``groups`` groups of
    ``hg`` harmonics, each a grid of ``row_tiles`` x ``col_tiles`` blocks of
    ``threads`` threads; each group writes ``scratch`` / ``groups`` floats
    of partial sums unless there is one group."""
    cols: int
    col_tiles: int
    row_tiles: int
    threads: int
    hg: int
    groups: int
    blocks: int
    smem: int
    blocks_per_sm: int
    scratch: int


@dataclass(frozen=True)
class BwdPlan:
    """How the backward kernels cover (R, D, E, n): dW blocks of
    ``threads`` threads over n harmonics x ``chunks`` row chunks of
    ``chunk_rows`` x ``col_tiles`` column tiles of ``cols``; a finishing
    launch with ``finish_smem`` bytes; dx (0s when it is not asked for) in
    ``dx_groups`` groups of ``dx_hg`` harmonics, ``dx_blocks`` blocks of
    ``dx_threads``; ``scratch`` floats of partial sums, shared by the two."""
    cols: int
    col_tiles: int
    threads: int
    chunks: int
    chunk_rows: int
    blocks: int
    smem: int
    blocks_per_sm: int
    finish_smem: int
    dx_hg: int
    dx_groups: int
    dx_threads: int
    dx_ld: int
    dx_blocks: int
    dx_smem: int
    scratch: int


def _blocks_per_sm(smem: int) -> int:
    return max(1, min(PLAN_BLOCKS_PER_SM, SM_SMEM_BYTES // (smem + 1024)))


def _wave_share(units: int, blocks: int, per_block: int, slots: int) -> float:
    """Share of the card's block slots doing work, over whole waves, when
    ``blocks`` blocks of ``per_block`` units each cover ``units``."""
    return units / (_cdiv(blocks, slots) * slots * per_block)


def _group_size(tiles: int, n: int, slots: int) -> int:
    """The largest power-of-two group of harmonics whose grid of ``tiles``
    x groups blocks fills ``slots`` block slots in whole waves (FULL_WAVES
    of the best such group), so that as few partial sums as possible are
    written."""
    cands = []
    hg = 1
    while True:
        cands.append((_wave_share(tiles * n, tiles * _cdiv(n, hg), hg, slots),
                      hg))
        if hg >= n:
            break
        hg *= 2
    best = max(c for c, _ in cands)
    return max(h for c, h in cands if c >= FULL_WAVES * best)


@functools.lru_cache(maxsize=256)
def fwd_plan(r: int, d: int, e: int, n: int, sms: int = 132) -> FwdPlan:
    """The forward kernel's launch for R rows on a card of ``sms`` SMs.
    The harmonic group size is the largest power of two whose grid fills
    the SMs in whole waves (FULL_WAVES of the best), so that as few
    partial sums as possible are written. Raises NotImplementedError where
    the kernel's shared memory cannot hold the tile."""
    cols = min(FWD_MAX_COLS, 4 * _cdiv(e, 4))
    # inputs (D, 32), features 2 x (2D, 32), weights 2 x (2D, cols); at
    # least the (16, 128) floats in which the cos half hands its sums on
    smem = 4 * max(d * FWD_ROWS + 4 * d * FWD_ROWS + 4 * d * cols,
                   16 * FWD_THREADS // 2)
    if smem > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"harmonic_dense kernel: D={d} exceeds its shared memory "
            f"({smem} > {MAX_SMEM_BYTES} bytes)")
    threads = FWD_THREADS
    col_tiles, row_tiles = _cdiv(e, cols), _cdiv(max(r, 1), FWD_ROWS)
    per_sm = _blocks_per_sm(smem)
    slots, tiles = sms * per_sm, row_tiles * col_tiles
    hg = _group_size(tiles, n, slots)
    groups = _cdiv(n, hg)
    return FwdPlan(cols, col_tiles, row_tiles, threads, hg, groups,
                   tiles * groups, smem, per_sm,
                   groups * r * e if groups > 1 else 0)


@functools.lru_cache(maxsize=256)
def bwd_plan(r: int, d: int, e: int, n: int, need_dx: bool = True,
             sms: int = 132) -> BwdPlan:
    """The backward kernels' launches for R rows on a card of ``sms`` SMs.
    dW takes the fewest row chunks whose n x chunks grid fills the SMs in
    whole waves (FULL_WAVES of the best); dx takes groups of harmonics as
    the forward does. Raises NotImplementedError outside the kernels' shared
    memory and thread limits."""
    kgs = _cdiv(2 * d, 4)
    if kgs > MAX_THREADS:
        raise NotImplementedError(
            f"harmonic_dense backward kernel: D={d} exceeds its thread limit")
    cgs = min(_cdiv(e, 4), MAX_THREADS // kgs)
    cols = 4 * cgs
    threads = 32 * _cdiv(kgs * cgs, 32)
    smem = 4 * 2 * DW_ROWS * (4 * kgs + cols)
    finish_smem = 4 * max(e * (n + 1), FINISH_THREADS)
    if max(smem, finish_smem) > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"harmonic_dense backward kernel: D={d}, E={e}, n={n} exceed its "
            "shared memory")
    col_tiles, row_tiles = _cdiv(e, cols), _cdiv(max(r, 1), DW_ROWS)
    per_sm = _blocks_per_sm(smem)
    slots = sms * per_sm
    cands = []
    chunks = 1
    while True:
        tpc = _cdiv(row_tiles, chunks)
        used = _cdiv(row_tiles, tpc)
        cands.append((_wave_share(n * col_tiles * row_tiles,
                                  n * col_tiles * used, tpc, slots), used, tpc))
        if tpc == 1:
            break
        chunks *= 2
    best = max(c for c, _, _ in cands)
    chunks, tpc = min((u, t) for c, u, t in cands if c >= FULL_WAVES * best)
    scratch = chunks * n * 2 * d * e
    dx_hg = dx_groups = dx_threads = dx_ld = dx_blocks = dx_smem = 0
    if need_dx:
        dx_threads = 32 * _cdiv(4 * d, 32)
        dx_ld = e | 1  # an odd row stride: a warp's rows fall in distinct banks
        dx_smem = 4 * (e * DX_ROWS + 5 * DX_ROWS * d + 4 * d * dx_ld)
        if dx_threads > MAX_THREADS or dx_smem > MAX_SMEM_BYTES:
            raise NotImplementedError(
                f"harmonic_dense backward kernel: D={d}, E={e} exceed the dx "
                "kernel's threads or shared memory")
        tiles = _cdiv(max(r, 1), DX_ROWS)
        dx_hg = _group_size(tiles, n, sms * _blocks_per_sm(dx_smem))
        dx_groups = _cdiv(n, dx_hg)
        dx_blocks = tiles * dx_groups
        if dx_groups > 1:
            scratch = max(scratch, dx_groups * r * d)
    return BwdPlan(cols, col_tiles, threads, chunks, tpc * DW_ROWS,
                   n * chunks * col_tiles, smem, per_sm, finish_smem, dx_hg, dx_groups,
                   dx_threads, dx_ld, dx_blocks, dx_smem, scratch)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def reorder_weight(weight: torch.Tensor, n: int, d_in: int) -> torch.Tensor:
    """torch (E, 2nD) d-major -> the kernel's (2, n, D, E) i-major."""
    e = weight.shape[0]
    return (weight.t().reshape(2, d_in, n, e).permute(0, 2, 1, 3)
            .contiguous())


def harmonic_dense_plain(x2d: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, freqs: torch.Tensor,
                         impl: str = "direct") -> torch.Tensor:
    """The kernel's function in plain torch: (R, D) -> (R, E)."""
    n = freqs.numel()
    embed = harmonic_features(x2d, n, float(freqs[0]), impl, freqs)
    return F.linear(embed, weight, bias)


def harmonic_dense_bwd_plain(x2d: torch.Tensor, g: torch.Tensor,
                             weight: torch.Tensor, freqs: torch.Tensor,
                             impl: str = "direct", need_dx: bool = True):
    """The backward kernel's function in plain torch: (dx or None, dW, db)
    for the upstream gradient ``g`` (R, E); dW in torch's (E, 2nD) layout.

    dx_r = sum_i f_i (c_i * (g_r Ws_i^T) - s_i * (g_r Wc_i^T)) at the
    features the forward used: under doubling the recurrence's own (s_i,
    c_i), the analytic gradient the TPU kernel defines."""
    n = freqs.numel()
    r, d = x2d.shape
    feats = harmonic_features(x2d, n, float(freqs[0]), impl, freqs)
    dw = g.t() @ feats
    db = g.sum(0)
    if not need_dx:
        return None, dw, db
    nd = n * d
    ge = g @ weight  # (R, 2nD): the gradient at the embedding
    s, c = feats[:, :nd].reshape(r, d, n), feats[:, nd:].reshape(r, d, n)
    gs, gc = ge[:, :nd].reshape(r, d, n), ge[:, nd:].reshape(r, d, n)
    return ((c * gs - s * gc) * freqs).sum(-1), dw, db


def _check_args(x2d, weight, freqs, impl, weight_imajor, *more):
    """Validate what both kernels take; returns (R, D, n, E)."""
    if impl not in IMPLS:
        raise ValueError(f"unknown harmonic impl {impl!r}")
    ts = (x2d, weight, freqs, *more)
    dev = x2d.device
    for t in ts:  # loops, not any(): this runs on every training step
        if t.dtype != torch.float32:
            raise TypeError("harmonic_dense takes float32 tensors")
    for t in ts:
        if t.device != dev:
            raise ValueError("harmonic_dense: tensors on different devices")
    if x2d.dim() != 2 or freqs.dim() != 1 or freqs.numel() < 1:
        raise ValueError("expected x2d (R, D) and freqs (n,) with n >= 1")
    r, d = x2d.shape
    n = freqs.numel()
    e = weight.shape[0]
    if tuple(weight.shape) != (e, 2 * n * d):
        raise ValueError(
            f"expected weight ({e}, {2 * n * d}), got {tuple(weight.shape)}")
    for t in ts:
        if not t.is_contiguous():
            raise ValueError("harmonic_dense takes contiguous tensors")
    if weight_imajor is not None and (
            tuple(weight_imajor.shape) != (2, n, d, e)
            or weight_imajor.dtype != torch.float32
            or weight_imajor.device != dev
            or not weight_imajor.is_contiguous()):
        raise ValueError(
            f"weight_imajor must be a contiguous float32 (2, {n}, {d}, {e}) "
            f"tensor on {dev}")
    return r, d, n, e


def harmonic_dense_fwd(x2d: torch.Tensor, weight: torch.Tensor,
                       bias: torch.Tensor, freqs: torch.Tensor,
                       impl: str = "direct",
                       weight_imajor: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """(R, D) -> (R, E): the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors, an error otherwise. ``weight_imajor`` is
    ``reorder_weight(weight, n, D)`` where the caller keeps one; without it
    the kernel's call reorders the weight first."""
    r, d, n, e = _check_args(x2d, weight, freqs, impl, weight_imajor, bias)
    if tuple(bias.shape) != (e,):
        raise ValueError(
            f"expected weight ({e}, {2 * n * d}) and bias ({e},), got "
            f"{tuple(weight.shape)} and {tuple(bias.shape)}")
    if x2d.device.type == "cpu":
        PLAIN_CALLS.add()
        return harmonic_dense_plain(x2d, weight, bias, freqs, impl)
    if x2d.device.type != "cuda":
        raise RuntimeError(f"harmonic_dense: no kernel for {x2d.device}")
    plan = fwd_plan(r, d, e, n, _sms(x2d.device.index or 0))
    lib = load_library()
    out = torch.empty((r, e), device=x2d.device, dtype=torch.float32)
    if r == 0:
        return out
    part = torch.empty(plan.scratch, device=x2d.device, dtype=torch.float32) \
        if plan.scratch else None
    wsc = weight_imajor if weight_imajor is not None else \
        reorder_weight(weight, n, d)
    with torch.cuda.device(x2d.device):
        err = lib.mmc_harmonic_dense_fwd(
            x2d.data_ptr(), wsc.data_ptr(), bias.data_ptr(), freqs.data_ptr(),
            out.data_ptr(), part.data_ptr() if part is not None else None,
            r, d, e, n, int(impl == "doubling"), plan.hg, plan.cols,
            plan.threads, stream_ptr(x2d.device))
    check(lib, err, "harmonic_dense_fwd")
    LAUNCHES.add()
    return out


def harmonic_dense_bwd(x2d: torch.Tensor, g: torch.Tensor,
                       weight: torch.Tensor, freqs: torch.Tensor,
                       impl: str = "direct",
                       weight_imajor: Optional[torch.Tensor] = None,
                       need_dx: bool = True):
    """(dx or None, dW (E, 2nD), db (E,)) for the upstream gradient ``g``
    (R, E): the CUDA kernels for CUDA tensors, the plain version for CPU
    tensors, an error otherwise. dx is computed only with ``need_dx``."""
    r, d, n, e = _check_args(x2d, weight, freqs, impl, weight_imajor, g)
    if tuple(g.shape) != (r, e):
        raise ValueError(f"expected g ({r}, {e}), got {tuple(g.shape)}")
    if x2d.device.type == "cpu":
        PLAIN_CALLS.add()
        return harmonic_dense_bwd_plain(x2d, g, weight, freqs, impl, need_dx)
    if x2d.device.type != "cuda":
        raise RuntimeError(f"harmonic_dense: no kernel for {x2d.device}")
    plan = bwd_plan(r, d, e, n, need_dx, _sms(x2d.device.index or 0))
    lib = load_library()
    kw = dict(device=x2d.device, dtype=torch.float32)
    dw = torch.empty((e, 2 * n * d), **kw)
    db = torch.empty((e,), **kw)
    dx = torch.empty((r, d), **kw) if need_dx else None
    if r == 0:
        return (dx, dw.zero_(), db.zero_())
    part = torch.empty(plan.scratch, **kw)
    wsc = weight_imajor if weight_imajor is not None else \
        reorder_weight(weight, n, d)
    with torch.cuda.device(x2d.device):
        err = lib.mmc_harmonic_dense_bwd(
            x2d.data_ptr(), g.data_ptr(), wsc.data_ptr(), freqs.data_ptr(),
            dw.data_ptr(), db.data_ptr(),
            dx.data_ptr() if dx is not None else None, part.data_ptr(),
            r, d, e, n, int(impl == "doubling"), plan.chunk_rows, plan.cols,
            plan.threads, plan.dx_hg, plan.dx_threads, plan.dx_ld,
            stream_ptr(x2d.device))
    check(lib, err, "harmonic_dense_bwd")
    LAUNCHES_BWD.add()
    return dx, dw, db


class HarmonicDense(torch.autograd.Function):
    """Forward and backward through the kernels (on the CPU, through their
    plain versions). ``freqs``, ``impl`` and ``weight_imajor`` take no
    gradient; dx is computed only when ``x2d`` needs one."""

    @staticmethod
    def forward(ctx, x2d, weight, bias, freqs, impl, weight_imajor):
        ctx.impl = impl
        ctx.save_for_backward(x2d, weight, freqs, weight_imajor)
        return harmonic_dense_fwd(x2d, weight, bias, freqs, impl, weight_imajor)

    @staticmethod
    def backward(ctx, grad_out):
        x2d, weight, freqs, weight_imajor = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx, dw, db = harmonic_dense_bwd(
            x2d, grad_out.contiguous(), weight, freqs, ctx.impl,
            weight_imajor, need_dx=need_x)
        return (dx, dw if need_w else None, db if need_b else None,
                None, None, None)


def harmonic_dense(x2d: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   freqs: torch.Tensor, impl: str = "direct",
                   weight_imajor: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """``embed_mlp(harmonic_features(x2d))`` as one kernel: (R, D) -> (R, E)."""
    return HarmonicDense.apply(x2d.contiguous(), weight, bias, freqs, impl,
                               weight_imajor)

"""Fused multi-channel ConvMixer core (conv_nChan >= 2): weight packing, the
CUDA kernel's launch plan and wrapper, and its plain PyTorch version.

Counterpart of ``FusedConvMixerMC`` in
``motionmixerconv_tpu/ops/pallas_conv_mixer.py``. The PoseEncoder runs
outside the kernel in plain torch; everything after it is one launch of
``csrc/conv_mixer_mc.cu``: one cluster of K blocks per sample, block r
owning a contiguous slice of the E columns (``mc_plan`` picks K, the
threads and the stencil tile). The TPU kernel's block-Toeplitz mix
matrices, SE squeeze/scatter matrices and folded decoder matrix are devices
of the MXU and are not carried over: the packed weights are the model's own
(conv weights, biases, BatchNorm folded to a per-channel affine, SE,
decoder). ``conv_mixer_mc_plain`` computes the same function from the same
packed weights; ``conv_mixer_mc_fused`` uses it only for a tensor on the
CPU. Inference only.

Domain: conv_nChan * in_nTP <= 128, as the JAX kernel's, and one block's
share of the sample (its column slices of the three (C, T, E) planes, one
with its halos, plus one mixer block's weights) within one block's shared
memory for some cluster of at most 16 blocks whose slices are no narrower
than the convs' widest 'same' pad; outside it the factory raises
NotImplementedError.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ._build import (MAX_SMEM_BYTES, SM_SMEM_BYTES, Counter, check,
                     load_library, stream_ptr)
from .activations import gelu_exact, get_activation
from .conv_mixer import (_layer_norm, _same_equivalent, _unpack, bn_affine,
                         check_inputs, plain_encoder_copy)

LAUNCHES = Counter()     # kernel launches (CUDA tensors)
PLAIN_CALLS = Counter()  # calls served by the plain version (CPU tensors)

MAX_ROWS = 128  # conv_nChan * in_nTP, the JAX kernel's lane limit
CO_TILE = 8     # the kernel pads output channels to a multiple of this
CLUSTER_SIZES = (1, 2, 4, 8, 16)  # blocks per sample (16: non-portable)
# the stencil's tiles: output rows x consecutive columns x output channels
# per thread (csrc/conv_mixer_mc.cu kTileRows, kTileCols, kTileCo)
TILES = ((1, 1, 2), (1, 3, 8))
MAX_CB = max(c for _, c, _ in TILES)
BUSY_TASKS = 256  # stencil tasks a block should have to keep its warps busy
MAX_THREADS = 640
MIN_THREADS = 128


@dataclass(frozen=True)
class ConvMixerMCSpec:
    """Shapes and switches of a packed conv_nChan >= 2 ConvMixer core."""

    C: int
    T: int
    E: int
    P: int
    D: int
    H: int            # SE hidden width T // r_se (0 without SE)
    num_blocks: int
    k1: Tuple[int, int]
    k2: Tuple[int, int]
    twice: bool
    use_se: bool
    use_max: bool
    activation: str

    @property
    def Cp(self) -> int:
        """C rounded up to the kernel's output-channel tile."""
        return -(-self.C // CO_TILE) * CO_TILE

    def layout(self) -> Tuple[List[Tuple[str, int]], List[Tuple[str, int]]]:
        """(per-block, global) pieces of the flat weight buffer, in order;
        ``csrc/conv_mixer_mc.cu`` reads the same layout."""
        C, T, E, H, P, D, Cp = self.C, self.T, self.E, self.H, self.P, self.D, self.Cp
        block = [("ln1_g", E), ("ln1_b", E), ("ln2_g", E), ("ln2_b", E),
                 ("w1", C * self.k1[0] * self.k1[1] * Cp),
                 ("w2", C * self.k2[0] * self.k2[1] * Cp),
                 ("scal", 6 * Cp), ("se_w1", T * H), ("se_w2", H * T)]
        glob = [("g_ln", E), ("b_ln", E), ("w_time", T * P), ("b_time", P),
                ("w_chan", C), ("b_proj", 1), ("w_out", E * D), ("b_out", D)]
        return block, glob

    def numel(self) -> int:
        block, glob = self.layout()
        return (self.num_blocks * sum(n for _, n in block)
                + sum(n for _, n in glob))

    def halos(self) -> Tuple[int, int]:
        """The convs' largest left and right 'same' padding over E
        (torch's: an even kernel's extra pad on the right)."""
        (_, kw1), (_, kw2) = self.k1, self.k2
        return (max((kw1 - 1) // 2, (kw2 - 1) // 2),
                max(kw1 - 1 - (kw1 - 1) // 2, kw2 - 1 - (kw2 - 1) // 2))

    def z_stride(self, K: int) -> int:
        """Row stride of a block's LN output plane: its widest column slice,
        both halos, and the columns a stencil tile's last run reads past
        the slice."""
        return -(-self.E // K) + sum(self.halos()) + MAX_CB - 1

    def smem_bytes(self, K: int) -> int:
        """Dynamic shared memory of one block of a K-block cluster, as the
        kernel lays it out: one mixer block's weights (rounded up to 16
        bytes); the column slices of the residual stream, the LN output
        (with halos) and the branch output (or the decoder's (P, slice));
        the LN's four per-row vectors, the SE's three per-t vectors and its
        hidden; the fc_out partials."""
        block, _ = self.layout()
        staged = -(-sum(n for _, n in block) // 4) * 4
        R, ws = self.C * self.T, -(-self.E // K)
        return 4 * (staged + R * ws + R * self.z_stride(K)
                    + max(R, self.P) * ws + 4 * R + 3 * self.T
                    + max(self.H, 1) + self.P * self.D)

    def cluster_sizes(self) -> List[int]:
        """The cluster sizes the kernel takes at this shape: every column
        slice at least the widest halo (so halos come from the two
        neighbours only) and one block within its shared memory."""
        halo = max(*self.halos(), 1)
        return [K for K in CLUSTER_SIZES
                if (K == 1 or self.E // K >= halo)
                and self.smem_bytes(K) <= MAX_SMEM_BYTES]

    def kernel_args(self) -> List[int]:
        return [self.C, self.T, self.E, self.P, self.D, self.H,
                self.num_blocks, self.k1[0], self.k1[1], self.k2[0],
                self.k2[1], int(self.twice), int(self.use_se),
                int(self.use_max), {"gelu": 0, "mish": 1}[self.activation]]


def _conv_taps(conv: nn.Conv2d, Cp: int) -> torch.Tensor:
    """(C_out, C_in, kh, kw) weight -> [ci][dt][de][co] with co zero padded
    to Cp, flattened."""
    w = conv.weight.detach().permute(1, 2, 3, 0)  # (ci, kh, kw, co)
    return F.pad(w, (0, Cp - w.shape[-1])).reshape(-1)


def pack_conv_mixer_mc(model) -> Tuple[ConvMixerMCSpec, torch.Tensor]:
    """Spec and flat float32 weight buffer (on the model's device) of a
    conv_nChan >= 2 port ConvMixer. NotImplementedError outside the
    kernel's domain."""
    C, T = model.conv_nChan, model.in_nTP
    if C < 2:
        raise NotImplementedError(
            "the multi-channel ConvMixer kernel takes conv_nChan >= 2")
    if C * T > MAX_ROWS:
        raise NotImplementedError(
            f"fused MC kernel needs conv_nChan*in_nTP <= {MAX_ROWS}, got "
            f"{C * T}")
    blocks = list(model.Mixer_Block)
    twice = model.mode_conv == "twice"
    for mb in blocks:
        convs = [mb.conv1.conv] + ([mb.conv2.conv] if twice else [])
        if not all(_same_equivalent(c) for c in convs):
            raise NotImplementedError(
                "the fused ConvMixer kernel takes 'same'-equivalent padding "
                "with stride 1 only")
    k1 = tuple(blocks[0].conv1.conv.kernel_size)
    k2 = tuple(blocks[0].conv2.conv.kernel_size) if twice else (1, 1)
    spec = ConvMixerMCSpec(
        C=C, T=T, E=model.dimPosEmb, P=model.out_nTP, D=model.dimPosOut,
        H=T // model.r_se if model.use_se else 0,
        num_blocks=model.num_blocks, k1=k1, k2=k2, twice=twice,
        use_se=model.use_se, use_max=model.use_max_pooling,
        activation=model.activation)
    get_activation(spec.activation)  # ValueError for an unknown name
    if not spec.cluster_sizes():
        K = max(k for k in CLUSTER_SIZES
                if k == 1 or spec.E // k >= max(*spec.halos(), 1))
        raise NotImplementedError(
            f"shape outside the fused MC kernel's limits: even a cluster of "
            f"{K} blocks needs {spec.smem_bytes(K)} bytes of shared memory "
            f"per block, over {MAX_SMEM_BYTES}")

    E, Cp = spec.E, spec.Cp
    pad = Cp - C

    def chan(v: torch.Tensor) -> torch.Tensor:  # (C,) -> (Cp,) float64
        return F.pad(v.detach().double(), (0, pad))

    zeros_e = torch.zeros(E, dtype=torch.float64)
    pieces = []
    with torch.no_grad():
        for mb in blocks:
            s1, t1 = bn_affine(mb.conv1.reg, C)
            scal = [chan(mb.conv1.conv.bias), chan(s1), chan(t1)]
            if twice:
                s2, t2 = bn_affine(mb.conv2.reg, C)
                scal += [chan(mb.conv2.conv.bias), chan(s2), chan(t2)]
                ln2_g, ln2_b = mb.LN2.weight, mb.LN2.bias
                w2 = _conv_taps(mb.conv2.conv, Cp)
            else:
                scal += [torch.zeros(Cp, dtype=torch.float64)] * 3
                ln2_g = ln2_b = zeros_e
                w2 = torch.zeros(C * Cp)
            if spec.use_se:
                exc = mb.se.excitationBlock
                se_w1 = exc[0].weight.t().reshape(-1)  # (T, H)
                se_w2 = exc[2].weight.t().reshape(-1)  # (H, T)
            else:
                se_w1 = se_w2 = torch.zeros(0)
            pieces += [mb.LN1.weight, mb.LN1.bias, ln2_g, ln2_b,
                       _conv_taps(mb.conv1.conv, Cp), w2, *scal, se_w1, se_w2]
        pieces += [model.LN.weight, model.LN.bias,
                   model.conv_out.weight[:, :, 0, 0].t().reshape(-1),  # (T, P)
                   model.conv_out.bias,
                   model.project_channels.weight.reshape(-1),  # (C,)
                   model.project_channels.bias.reshape(-1),
                   model.fc_out.weight.t().reshape(-1),  # (E, D)
                   model.fc_out.bias]
        device = model.fc_out.weight.device
        flat = torch.cat([p.detach().to(device=device, dtype=torch.float32)
                          .reshape(-1) for p in pieces]).contiguous()
    if flat.numel() != spec.numel():
        raise AssertionError("packed weights disagree with the layout")
    return spec, flat


def _conv_same_mc(z, w, bias, k, spec):
    """C x C 'same' Conv2d over (T, E) with torch's padding (extra pad
    right), from the packed [ci][dt][de][co] weights."""
    kh, kw = k
    C = spec.C
    weight = w.view(C, kh, kw, spec.Cp)[..., :C].permute(3, 0, 1, 2)
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    zp = F.pad(z, (pw, kw - 1 - pw, ph, kh - 1 - ph))
    return F.conv2d(zp, weight.contiguous(), bias)


def _se_gate_mc(z, w1, w2, spec):
    s = z.amax(dim=(1, 3)) if spec.use_max else z.mean(dim=(1, 3))  # (B, T)
    h = torch.relu(s @ w1.view(spec.T, spec.H))
    g = torch.sigmoid(h @ w2.view(spec.H, spec.T))
    return z * g[:, None, :, None]


def conv_mixer_mc_plain(y: torch.Tensor, flat: torch.Tensor,
                        spec: ConvMixerMCSpec) -> torch.Tensor:
    """The kernel's function in plain torch: (B, C, T, E) -> (B, P, D)."""
    act = get_activation(spec.activation)
    blocks, g = _unpack(flat, spec)
    C = spec.C

    def affine(v, row):  # per-channel vector over (B, C, T, E)
        return v.view(6, spec.Cp)[row, :C][None, :, None, None]

    for w in blocks:
        sc = w["scal"]
        z = _layer_norm(y, w["ln1_g"], w["ln1_b"])
        z = _conv_same_mc(z, w["w1"], sc.view(6, spec.Cp)[0, :C], spec.k1, spec)
        z = act(z) * affine(sc, 1) + affine(sc, 2)
        if spec.use_se:
            z = _se_gate_mc(z, w["se_w1"], w["se_w2"], spec)
        y = y + z
        if spec.twice:
            z = _layer_norm(y, w["ln2_g"], w["ln2_b"])
            z = _conv_same_mc(z, w["w2"], sc.view(6, spec.Cp)[3, :C], spec.k2,
                              spec)
            z = act(z) * affine(sc, 4) + affine(sc, 5)
        else:
            z = y  # LN2/conv2 are identity in 'once' mode
        if spec.use_se:
            z = _se_gate_mc(z, w["se_w1"], w["se_w2"], spec)
        y = y + z
    d = _layer_norm(y, g["g_ln"], g["b_ln"])
    d = torch.einsum("bcte,tp->bcpe", d, g["w_time"].view(spec.T, spec.P))
    d = d + g["b_time"][None, None, :, None]
    d = torch.einsum("bcpe,c->bpe", d, g["w_chan"]) + g["b_proj"]
    d = gelu_exact(d)  # the decoder's activation is always GELU
    return d @ g["w_out"].view(spec.E, spec.D) + g["b_out"]


@dataclass(frozen=True)
class MCPlan:
    """One launch of the kernel: a cluster of ``K`` blocks of ``threads``
    threads per sample, stencil tile ``TILES[tile]``, ``smem`` bytes of
    dynamic shared memory a block. Block r owns columns
    ``_build.slices(E, K)[r]``."""

    K: int
    threads: int
    tile: int
    smem: int


def _stencil_tasks(spec: ConvMixerMCSpec, K: int, tile: int) -> int:
    """Threads' worth of stencil work in one block: (output-channel tiles)
    x (row tiles) x (column runs of its widest slice)."""
    rb, cb, co = TILES[tile]
    runs = -(-(-(-spec.E // K)) // cb)
    return spec.Cp // co * -(-spec.T // rb) * runs


def _plan(spec: ConvMixerMCSpec, K: int, tile: int) -> MCPlan:
    tasks = _stencil_tasks(spec, K, tile)
    threads = min(MAX_THREADS, max(MIN_THREADS, 32 * -(-tasks // 32)))
    return MCPlan(K, threads, tile, spec.smem_bytes(K))


@functools.lru_cache(maxsize=None)
def cluster_slots(index: int) -> Tuple[Tuple[int, int], ...]:
    """(K, clusters of K blocks that card ``index`` holds at once with one
    block an SM) for every cluster size, from the kernel's
    cudaOccupancyMaxActiveClusters query (a block of more than half an
    SM's shared memory): what ``mc_plan`` sizes a launch by. An H100 SXM
    answers ((1, 132), (2, 66), (4, 30), (8, 15), (16, 7))."""
    lib = load_library()
    slots = []
    with torch.cuda.device(index):
        for K in CLUSTER_SIZES:
            n = lib.mmc_conv_mixer_mc_max_clusters(K, MIN_THREADS,
                                                   SM_SMEM_BYTES // 2 + 1)
            if n < 0:
                check(lib, -n, f"the card's room for clusters of {K} blocks")
            slots.append((K, n))
    return tuple(slots)


@functools.lru_cache(maxsize=512)
def mc_plan(spec: ConvMixerMCSpec, batch: int,
            slots: Tuple[Tuple[int, int], ...], K: int = None,
            tile: int = None) -> MCPlan:
    """The launch for ``batch`` samples on a card with ``slots``
    (``cluster_slots``): the widest cluster whose ``batch`` clusters the
    card holds at once, the shortest latency chain a sample can have in one
    wave; one block a sample above that (or the smallest cluster the shape
    allows). The tile: 1 x 3 x 8 where it gives a block BUSY_TASKS tasks,
    else 1 x 1 x 2. ``K`` and ``tile`` override the choice (for timing the
    alternatives); NotImplementedError where the kernel does not take the
    shape or the override."""
    sizes = spec.cluster_sizes()
    if not sizes or (K is not None and K not in sizes):
        raise NotImplementedError(
            f"the fused MC kernel takes clusters of {sizes} blocks at this "
            f"shape (shared memory and halos), not {K}")
    if K is None:
        room = dict(slots)
        K = max((k for k in sizes if batch <= room[k]), default=min(sizes))
    if tile is None:
        tile = _tile(spec, K)
    return _plan(spec, K, tile)


def _tile(spec: ConvMixerMCSpec, K: int) -> int:
    """The tile with the most multiply-adds a task that still gives a block
    of a K-block cluster BUSY_TASKS tasks; the smallest if none does."""
    busy = [t for t in range(len(TILES))
            if _stencil_tasks(spec, K, t) >= BUSY_TASKS]
    return max(busy, key=lambda t: TILES[t][0] * TILES[t][1] * TILES[t][2],
               default=0)


def conv_mixer_mc_fused(y: torch.Tensor, flat: torch.Tensor,
                        spec: ConvMixerMCSpec,
                        plan: MCPlan = None) -> torch.Tensor:
    """(B, C, T, E) encoder output -> (B, P, D): the CUDA kernel for a CUDA
    tensor (``plan``, default ``mc_plan`` for B samples on its card), the
    plain version for a CPU tensor, an error otherwise."""
    check_inputs("conv_mixer_mc_fused", y, flat, spec,
                 (spec.C, spec.T, spec.E))
    if y.device.type == "cpu":
        PLAIN_CALLS.add()
        return conv_mixer_mc_plain(y, flat, spec)
    B = y.shape[0]
    out = torch.empty((B, spec.P, spec.D), device=y.device, dtype=torch.float32)
    if B == 0:
        return out
    lib = load_library()
    if plan is None:
        plan = mc_plan(spec, B, cluster_slots(y.device.index))
    with torch.cuda.device(y.device):
        err = lib.mmc_conv_mixer_mc(
            y.data_ptr(), flat.data_ptr(), out.data_ptr(), B,
            *spec.kernel_args(), plan.K, plan.threads, plan.tile,
            stream_ptr(y.device))
    check(lib, err, f"conv_mixer_mc_fused (clusters of {plan.K} blocks x "
          f"{plan.threads} threads, {plan.smem} bytes of shared memory each)")
    LAUNCHES.add()
    return out


class FusedConvMixerMC:
    """A port conv_nChan >= 2 ConvMixer's core packed for the fused kernel;
    the encoder (``plain_encoder_copy``) runs outside it. ``__call__``:
    (B, in_nTP, dimPosIn) -> (B, out_nTP, D)."""

    def __init__(self, model):
        self.spec, self.weights = pack_conv_mixer_mc(model)
        self.encoder = plain_encoder_copy(model.encoder, self.weights.device)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        y = self.encoder(x).permute(0, 3, 1, 2).contiguous()  # (B, C, T, E)
        return conv_mixer_mc_fused(y, self.weights, self.spec)

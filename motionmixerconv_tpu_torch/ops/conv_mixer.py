"""Fused single-channel ConvMixer core: weight packing, the CUDA kernel's
wrapper and its plain PyTorch version.

Counterpart of ``FusedConvMixer`` in
``motionmixerconv_tpu/ops/pallas_conv_mixer.py``. The PoseEncoder (with its
large embedding matmul and the ``channelUpscaling`` affine) runs outside the
kernel in plain torch; everything after it is one launch of
``csrc/conv_mixer_fused.cu``. ``conv_mixer_plain`` computes the same function
from the same packed weights; ``conv_mixer_fused`` uses it only for a tensor
on the CPU. Inference only.

The launch shape, one block a sample and how many warps it gets, is
``b2_plan``'s alone (plain Python, tested on the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.encoding import PoseEncoder
from ._build import MAX_SMEM_BYTES, Counter, check, load_library, stream_ptr
from .activations import gelu_exact, get_activation

LAUNCHES = Counter()     # kernel launches (CUDA tensors)
PLAIN_CALLS = Counter()  # calls served by the plain version (CPU tensors)


@dataclass(frozen=True)
class ConvMixerSpec:
    """Shapes and switches of a packed conv_nChan == 1 ConvMixer core."""

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

    def layout(self) -> Tuple[List[Tuple[str, int]], List[Tuple[str, int]]]:
        """(per-block, global) pieces of the flat weight buffer, in order;
        ``csrc/conv_mixer_fused.cu`` reads the same layout."""
        T, E, H, P, D = self.T, self.E, self.H, self.P, self.D
        block = [("ln1_g", E), ("ln1_b", E), ("ln2_g", E), ("ln2_b", E),
                 ("taps1", self.k1[0] * self.k1[1]),
                 ("taps2", self.k2[0] * self.k2[1]),
                 ("scal", 6), ("se_w1", T * H), ("se_w2", H * T)]
        glob = [("g_ln", E), ("b_ln", E), ("w_time", T * P), ("b_time", P),
                ("proj", 2), ("w_out", E * D), ("b_out", D)]
        return block, glob

    def numel(self) -> int:
        block, glob = self.layout()
        return (self.num_blocks * sum(n for _, n in block)
                + sum(n for _, n in glob))

    def sample_floats(self) -> int:
        """A sample's shared floats: the LayerNorm output (T, E); the
        residual stream and the branch output (T, E) each, whose space the
        decoder's (P, E) plane takes over; the SE squeeze, double-buffered."""
        te = self.T * self.E
        return te + max(2 * te, self.P * self.E) + 2 * self.T

    def smem_bytes(self) -> int:
        """Dynamic shared memory of a block: the packed weights and one
        sample's planes."""
        return 4 * (self.numel() + self.sample_floats())

    def kernel_args(self) -> List[int]:
        return [self.T, self.E, self.P, self.D, self.H, self.num_blocks,
                self.k1[0], self.k1[1], self.k2[0], self.k2[1],
                int(self.twice), int(self.use_se), int(self.use_max),
                {"gelu": 0, "mish": 1}[self.activation]]


MAX_WARPS = 16  # warps a block may have (csrc/conv_mixer_fused.cu kMaxWarps)


@dataclass(frozen=True)
class B2Plan:
    """B2's launch: one block a sample, ``warps`` warps a block (warp i owns
    the sample's time rows i, i + warps, ...)."""

    warps: int
    blocks: int
    threads: int
    smem: int


@lru_cache(maxsize=256)
def b2_plan(spec: ConvMixerSpec, batch: int) -> B2Plan:
    """The launch of ``batch`` samples: one block a sample, with as many
    warps as the sample has time rows, up to a block's 16. Cached, as the
    serving path asks for it on every call."""
    warps = min(spec.T, MAX_WARPS)
    return B2Plan(warps=warps, blocks=batch, threads=32 * warps,
                  smem=spec.smem_bytes())


def _unpack(flat: torch.Tensor, spec: ConvMixerSpec
            ) -> Tuple[List[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    block, glob = spec.layout()
    off = 0
    blocks = []
    for _ in range(spec.num_blocks):
        d = {}
        for name, n in block:
            d[name] = flat[off: off + n]
            off += n
        blocks.append(d)
    g = {}
    for name, n in glob:
        g[name] = flat[off: off + n]
        off += n
    return blocks, g


def _same_equivalent(conv: nn.Conv2d) -> bool:
    kh, kw = conv.kernel_size
    if tuple(conv.stride) != (1, 1) or tuple(conv.dilation) != (1, 1):
        return False
    if conv.padding == "same":
        return True
    # a symmetric pad equals torch's 'same' only for odd kernels
    return (kh % 2 == 1 and kw % 2 == 1
            and tuple(conv.padding) == ((kh - 1) // 2, (kw - 1) // 2))


def bn_affine(reg: nn.Module, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm over ``n`` channels as per-channel (scale, shift),
    folded in float64; identity for dropout and no regularization."""
    if not isinstance(reg, (nn.BatchNorm1d, nn.BatchNorm2d)):
        return (torch.ones(n, dtype=torch.float64),
                torch.zeros(n, dtype=torch.float64))
    s = reg.weight.detach().double() / torch.sqrt(
        reg.running_var.double() + reg.eps)
    return s, reg.bias.detach().double() - reg.running_mean.double() * s


def pack_conv_mixer(model) -> Tuple[ConvMixerSpec, torch.Tensor]:
    """Spec and flat float32 weight buffer (on the model's device) of a
    conv_nChan == 1 port ConvMixer. NotImplementedError outside the
    kernel's domain."""
    if model.conv_nChan != 1:
        raise NotImplementedError(
            "the fused ConvMixer kernel covers conv_nChan == 1; conv_nChan "
            ">= 2 goes to FusedConvMixerMC (ops/conv_mixer_mc.py)")
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
    T, P = model.in_nTP, model.out_nTP
    spec = ConvMixerSpec(
        T=T, E=model.dimPosEmb, P=P, D=model.dimPosOut,
        H=T // model.r_se if model.use_se else 0,
        num_blocks=model.num_blocks, k1=k1, k2=k2, twice=twice,
        use_se=model.use_se, use_max=model.use_max_pooling,
        activation=model.activation)
    get_activation(spec.activation)  # ValueError for an unknown name
    # every loop of the kernel strides over any size; shared memory, which
    # holds all weights and the sample's planes, is its one limit
    if spec.smem_bytes() > MAX_SMEM_BYTES:
        raise NotImplementedError(
            f"shape outside the fused ConvMixer kernel's limits: it needs "
            f"{spec.smem_bytes()} bytes of shared memory, over "
            f"{MAX_SMEM_BYTES}")

    E = spec.E
    zeros_e = torch.zeros(E, dtype=torch.float64)
    pieces = []
    with torch.no_grad():
        for mb in blocks:
            s1, t1 = (float(v[0]) for v in bn_affine(mb.conv1.reg, 1))
            b1 = float(mb.conv1.conv.bias[0])
            if twice:
                s2, t2 = (float(v[0]) for v in bn_affine(mb.conv2.reg, 1))
                b2 = float(mb.conv2.conv.bias[0])
                ln2_g, ln2_b = mb.LN2.weight, mb.LN2.bias
                taps2 = mb.conv2.conv.weight[0, 0].reshape(-1)
            else:
                s2, t2, b2 = 1.0, 0.0, 0.0
                ln2_g = ln2_b = zeros_e
                taps2 = torch.zeros(1)
            if spec.use_se:
                exc = mb.se.excitationBlock
                se_w1 = exc[0].weight.t().reshape(-1)  # (T, H)
                se_w2 = exc[2].weight.t().reshape(-1)  # (H, T)
            else:
                se_w1 = se_w2 = torch.zeros(0)
            pieces += [mb.LN1.weight, mb.LN1.bias, ln2_g, ln2_b,
                       mb.conv1.conv.weight[0, 0].reshape(-1), taps2,
                       torch.tensor([b1, s1, t1, b2, s2, t2]), se_w1, se_w2]
        pieces += [model.LN.weight, model.LN.bias,
                   model.conv_out.weight[:, :, 0, 0].t().reshape(-1),  # (T, P)
                   model.conv_out.bias,
                   torch.stack([model.project_channels.weight.reshape(()),
                                model.project_channels.bias.reshape(())]),
                   model.fc_out.weight.t().reshape(-1),  # (E, D)
                   model.fc_out.bias]
        device = model.fc_out.weight.device
        flat = torch.cat([p.detach().to(device=device, dtype=torch.float32)
                          .reshape(-1) for p in pieces]).contiguous()
    if flat.numel() != spec.numel():
        raise AssertionError("packed weights disagree with the layout")
    return spec, flat


def _layer_norm(y, g, b):
    return F.layer_norm(y, (y.shape[-1],), g, b, eps=1e-5)


def _conv_same(z, taps, k):
    """'same' stencil over (T, E) with torch's padding (extra pad right)."""
    kh, kw = k
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    T, E = z.shape[1], z.shape[2]
    zp = F.pad(z, (pw, kw - 1 - pw, ph, kh - 1 - ph))
    acc = torch.zeros_like(z)
    for dt in range(kh):
        for de in range(kw):
            acc = acc + taps[dt * kw + de] * zp[:, dt: dt + T, de: de + E]
    return acc


def _se_gate(z, w1, w2, spec):
    s = z.amax(dim=-1) if spec.use_max else z.mean(dim=-1)  # (B, T)
    h = torch.relu(s @ w1.view(spec.T, spec.H))
    g = torch.sigmoid(h @ w2.view(spec.H, spec.T))
    return z * g[:, :, None]


def conv_mixer_plain(y: torch.Tensor, flat: torch.Tensor,
                     spec: ConvMixerSpec) -> torch.Tensor:
    """The kernel's function in plain torch: (B, T, E) -> (B, P, D)."""
    act = get_activation(spec.activation)
    blocks, g = _unpack(flat, spec)
    for w in blocks:
        sc = w["scal"]
        z = _layer_norm(y, w["ln1_g"], w["ln1_b"])
        z = act(_conv_same(z, w["taps1"], spec.k1) + sc[0]) * sc[1] + sc[2]
        if spec.use_se:
            z = _se_gate(z, w["se_w1"], w["se_w2"], spec)
        y = y + z
        if spec.twice:
            z = _layer_norm(y, w["ln2_g"], w["ln2_b"])
            z = act(_conv_same(z, w["taps2"], spec.k2) + sc[3]) * sc[4] + sc[5]
        else:
            z = y  # LN2/conv2 are identity in 'once' mode
        if spec.use_se:
            z = _se_gate(z, w["se_w1"], w["se_w2"], spec)
        y = y + z
    d = _layer_norm(y, g["g_ln"], g["b_ln"])
    d = torch.einsum("bte,tp->bpe", d, g["w_time"].view(spec.T, spec.P))
    d = (d + g["b_time"][None, :, None]) * g["proj"][0] + g["proj"][1]
    d = gelu_exact(d)  # the decoder's activation is always GELU
    return d @ g["w_out"].view(spec.E, spec.D) + g["b_out"]


def check_inputs(what: str, y: torch.Tensor, flat: torch.Tensor, spec,
                 sample_shape: Tuple[int, ...]) -> None:
    """Raise unless ``y`` is a contiguous float32 (B, *sample_shape) tensor
    and ``flat`` the contiguous float32 packed weights of ``spec``, both on
    one device."""
    if y.dtype != torch.float32 or flat.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 tensors")
    if y.dim() != 1 + len(sample_shape) or tuple(y.shape[1:]) != sample_shape:
        raise ValueError(f"expected (B, {', '.join(map(str, sample_shape))}),"
                         f" got {tuple(y.shape)}")
    if flat.dim() != 1 or flat.numel() != spec.numel():
        raise ValueError("packed weights do not match the spec")
    if y.device != flat.device:
        raise ValueError(f"y on {y.device}, weights on {flat.device}")
    if not (y.is_contiguous() and flat.is_contiguous()):
        raise ValueError(f"{what} takes contiguous tensors")
    if y.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{what}: no kernel for {y.device}")


def conv_mixer_fused(y: torch.Tensor, flat: torch.Tensor,
                     spec: ConvMixerSpec) -> torch.Tensor:
    """(B, T, E) encoder output -> (B, P, D): the CUDA kernel for a CUDA
    tensor (launched as ``b2_plan`` says), the plain version for a CPU
    tensor, an error otherwise."""
    check_inputs("conv_mixer_fused", y, flat, spec, (spec.T, spec.E))
    if y.device.type == "cpu":
        PLAIN_CALLS.add()
        return conv_mixer_plain(y, flat, spec)
    B = y.shape[0]
    out = torch.empty((B, spec.P, spec.D), device=y.device, dtype=torch.float32)
    if B == 0:
        return out
    plan = b2_plan(spec, B)
    lib = load_library()
    with torch.cuda.device(y.device):
        err = lib.mmc_conv_mixer_fused(
            y.data_ptr(), flat.data_ptr(), out.data_ptr(), B,
            *spec.kernel_args(), plan.warps, stream_ptr(y.device))
    check(lib, err, "conv_mixer_fused")
    LAUNCHES.add()
    return out


def plain_encoder_copy(enc: PoseEncoder, device) -> PoseEncoder:
    """A plain PoseEncoder (direct harmonics, no kernel) on ``device``
    holding a copy of ``enc``'s weights: the fused cores' encoder, as the
    JAX fused classes build their XLA-side encoder."""
    copy = PoseEncoder(enc.dimPosIn, enc.dimPosEmb, conv_nChan=enc.conv_nChan,
                       n_harmonic_functions=enc.n_harmonic_functions,
                       omega0=enc.omega0)
    copy.load_state_dict(enc.state_dict(), strict=True)
    return copy.to(device).eval()


class FusedConvMixer:
    """A port ConvMixer's core packed for the fused kernel; the encoder
    (``plain_encoder_copy``) runs outside it. ``__call__``: (B, in_nTP,
    dimPosIn) -> (B, out_nTP, D)."""

    def __init__(self, model):
        self.spec, self.weights = pack_conv_mixer(model)
        self.encoder = plain_encoder_copy(model.encoder, self.weights.device)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        y = self.encoder(x)[..., 0].contiguous()  # (B, T, E), C == 1
        return conv_mixer_fused(y, self.weights, self.spec)


def make_fused_conv_mixer(model):
    """Kernel factory, as the JAX package's: conv_nChan == 1 ->
    FusedConvMixer (B2); conv_nChan >= 2 -> FusedConvMixerMC (B3,
    ``ops/conv_mixer_mc.py``). NotImplementedError outside the kernels'
    domains (conv_nChan * in_nTP > 128 among them)."""
    if model.conv_nChan == 1:
        return FusedConvMixer(model)
    from .conv_mixer_mc import FusedConvMixerMC

    return FusedConvMixerMC(model)

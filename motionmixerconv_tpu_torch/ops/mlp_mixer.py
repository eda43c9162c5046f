"""Fused MlpMixer forward: weight packing, the CUDA kernel's wrapper and its
plain PyTorch version.

Counterpart of ``FusedMlpMixer`` in ``motionmixerconv_tpu/ops/pallas_mixer.py``:
the whole inference forward, pose embed -> num_blocks mixer blocks -> LN ->
time upsample -> ``fc_out``, is one launch of ``csrc/mlp_mixer_fused.cu``.
The packed weights are the model's own at their true widths (the TPU
kernel's 128-lane padding is not carried over), with each MlpBlock's two
inference BatchNorms and its fc2 bias folded into a per-row multiplier A
and an additive plane P (``pallas_mixer.py:107-151``):
``BN2(fc2(BN1(a))) = A * (a @ W2) + P``. ``mlp_mixer_plain`` computes the
same function from the same packed weights; ``mlp_mixer_fused`` uses it
only for a tensor on the CPU. Inference only (dropout is inactive).

Domain: every width and window length. A sample's activations live in
shared memory where they fit and in a device scratch buffer otherwise
(``MlpMixerSpec.uses_scratch``); the weight matrices are copied into two
shared buffers in turn (the next while the current is used), or one, where
they fit beside them (``nbufs``, ``wbuf_floats``), and are read in place
otherwise. The spec alone decides that placement and passes it to the
kernel. Every piece of the packed buffer starts at a 16-byte boundary (the
kernel's bulk copies need it). Sizes whose indices overflow 32 bits raise
NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from ._build import MAX_SMEM_BYTES, Counter, check, load_library, stream_ptr
from .activations import get_activation
from .conv_mixer import bn_affine, check_inputs

LAUNCHES = Counter()     # kernel launches (CUDA tensors)
PLAIN_CALLS = Counter()  # calls served by the plain version (CPU tensors)

BLOCK_TYPES = {"normal": 0, "channel_only": 1, "token_only": 2}
_INT_MAX = 2**31 - 1
# a sample's room for the split-K partial tiles (csrc/mlp_mixer_fused.cu
# `pick` splits K only where they fit)
PART_FLOATS = 12288
MBAR_FLOATS = 4  # the kernel's two mbarriers at the start of shared memory


def pad4(n: int) -> int:
    """``n`` rounded up to a multiple of 4 floats (16 bytes)."""
    return -(-n // 4) * 4


@dataclass(frozen=True)
class MlpMixerSpec:
    """Shapes and switches of a packed MlpMixer."""

    T: int            # seq_len
    D: int            # input_size
    H: int            # hidden_dim
    P: int            # pred_len
    NC: int           # num_classes
    tok: int          # tokens_mlp_dim
    ch: int           # channels_mlp_dim
    S: int            # SE hidden width T // r_se (0 without SE)
    num_blocks: int
    block_type: str   # 'normal' | 'channel_only' | 'token_only'
    use_se: bool
    use_max: bool
    activation: str

    @property
    def has_tok(self) -> bool:
        return self.block_type != "channel_only"

    @property
    def has_ch(self) -> bool:
        return self.block_type != "token_only"

    def layout(self) -> Tuple[List[Tuple[str, int]], List[Tuple[str, int]],
                              List[Tuple[str, int]]]:
        """(embed, per-block, head) pieces of the flat weight buffer, in
        order, with their true sizes; each takes ``pad4`` of its size in the
        buffer. ``csrc/mlp_mixer_fused.cu`` reads the same layout. Matrices
        are (in, out), row major; planes are (T, H)."""
        T, D, H, P, NC, S = self.T, self.D, self.H, self.P, self.NC, self.S
        tok, ch = self.tok, self.ch
        embed = [("w_embed", D * H), ("b_embed", H)]
        block = []
        if self.has_tok:
            block += [("ln1_g", H), ("ln1_b", H), ("tok_w1", T * tok),
                      ("tok_b1", tok), ("tok_w2", tok * T), ("tok_A", H),
                      ("tok_P", T * H)]
        block += [("se_w1", T * S), ("se_w2", S * T)]
        if self.has_ch:
            block += [("ln2_g", H), ("ln2_b", H), ("ch_w1", H * ch),
                      ("ch_b1", ch), ("ch_w2", ch * H), ("ch_A", T),
                      ("ch_P", T * H)]
        head = [("g_ln", H), ("b_ln", H), ("w_time", T * P), ("b_time", P),
                ("w_out", H * NC), ("b_out", NC)]
        return embed, block, head

    def numel(self) -> int:
        embed, block, head = self.layout()
        return (sum(pad4(n) for _, n in embed) + self.num_blocks
                * sum(pad4(n) for _, n in block)
                + sum(pad4(n) for _, n in head))

    def sample_floats(self) -> int:
        """A sample's working set: the SE squeeze (T), the residual stream
        and the LN/branch plane (T, H) each, one buffer for the MLP hiddens
        and the time upsample, the split-K partials; each piece padded to
        16 bytes."""
        T, H = self.T, self.H
        buf = max(self.H * self.tok if self.has_tok else 0,
                  T * self.ch if self.has_ch else 0, self.P * H)
        return pad4(T) + 2 * pad4(T * H) + pad4(buf) + PART_FLOATS

    @property
    def uses_scratch(self) -> bool:
        """The activations outgrow one block's shared memory and live in a
        device buffer of ``sample_floats`` per sample instead."""
        return 4 * (MBAR_FLOATS + self.sample_floats()) > MAX_SMEM_BYTES

    def act_smem_floats(self) -> int:
        """The activations' share of shared memory (0 when they live in
        scratch)."""
        return 0 if self.uses_scratch else self.sample_floats()

    def wbuf_floats(self) -> int:
        """One shared buffer a weight matrix is copied into: the largest
        matrix, when one fits beside the activations; else 0 (every matrix
        read in place)."""
        T, D, H, P, NC = self.T, self.D, self.H, self.P, self.NC
        n = pad4(max(D * H, T * P, H * NC,
                      T * self.tok if self.has_tok else 0,
                      H * self.ch if self.has_ch else 0))
        fits = 4 * (MBAR_FLOATS + self.act_smem_floats() + n) <= MAX_SMEM_BYTES
        return n if fits else 0

    def nbufs(self) -> int:
        """Shared weight buffers: 2 where they fit (each matrix is copied
        while the one before it is used), else 1 or 0."""
        n = self.wbuf_floats()
        if n and 4 * (MBAR_FLOATS + self.act_smem_floats() + 2 * n) \
                <= MAX_SMEM_BYTES:
            return 2
        return 1 if n else 0

    def smem_bytes(self) -> int:
        """Dynamic shared memory per block: the mbarriers, the activations
        (unless in scratch) and the weight buffers."""
        return 4 * (MBAR_FLOATS + self.act_smem_floats()
                    + self.nbufs() * self.wbuf_floats())

    def kernel_args(self) -> List[int]:
        """The kernel's shapes and switches, then its placement: a sample's
        working set, whether it lives in scratch, the partials' share of
        it, the weight buffers and their size (floats)."""
        return [self.T, self.D, self.H, self.P, self.NC, self.tok, self.ch,
                self.S, self.num_blocks, BLOCK_TYPES[self.block_type],
                int(self.use_se), int(self.use_max),
                {"gelu": 0, "mish": 1}[self.activation],
                self.sample_floats(), int(self.uses_scratch), PART_FLOATS,
                self.nbufs(), self.wbuf_floats()]


def _unpack(flat: torch.Tensor, spec: MlpMixerSpec
            ) -> Tuple[Dict[str, torch.Tensor], List[Dict[str, torch.Tensor]],
                       Dict[str, torch.Tensor]]:
    embed, block, head = spec.layout()
    off = 0

    def take(pieces):
        nonlocal off
        d = {}
        for name, n in pieces:
            d[name] = flat[off: off + n]
            off += pad4(n)
        return d

    e = take(embed)
    blocks = [take(block) for _ in range(spec.num_blocks)]
    return e, blocks, take(head)


def _fold(mlp, n: int, rows_are_t: bool, T: int, H: int):
    """(A, P) of an MlpBlock's fc2 with its two BatchNorms over ``n``
    channels folded in, in float64: A = s1 s2 per channel, P = s2 (t1
    colsum(W2) + b2) + t2 as a (T, H) plane. The token block's channels are
    H (the plane's columns), the channel block's T (its rows). Computed on
    the CPU, whatever the model's device."""
    s1, t1, s2, t2 = (v.cpu() for v in (*bn_affine(mlp.reg1, n),
                                        *bn_affine(mlp.reg2, n)))
    colsum = mlp.fc2.weight.detach().double().cpu().sum(1)  # over its inputs
    b2 = mlp.fc2.bias.detach().double().cpu()
    if rows_are_t:   # channel mixing: channels T, fc2 outputs H
        plane = (s2[:, None] * (t1[:, None] * colsum[None, :] + b2[None, :])
                 + t2[:, None])
    else:            # token mixing: channels H, fc2 outputs T
        plane = (s2[None, :] * (t1[None, :] * colsum[:, None] + b2[:, None])
                 + t2[None, :])
    return s1 * s2, plane.reshape(T * H)


def pack_mlp_mixer(model) -> Tuple[MlpMixerSpec, torch.Tensor]:
    """Spec and flat float32 weight buffer (on the model's device) of a port
    MlpMixer. NotImplementedError outside the kernel's domain."""
    bt = model.mlp_block_type
    spec = MlpMixerSpec(
        T=model.seq_len, D=model.input_size, H=model.hidden_dim,
        P=model.pred_len, NC=model.num_classes, tok=model.tokens_mlp_dim,
        ch=model.channels_mlp_dim,
        S=model.seq_len // model.r_se if model.use_se else 0,
        num_blocks=model.num_blocks,
        block_type=bt if bt in ("channel_only", "token_only") else "normal",
        use_se=model.use_se, use_max=model.use_max_pooling,
        activation=model.activation)
    get_activation(spec.activation)  # ValueError for an unknown name
    sizes = [spec.numel(), spec.sample_floats(), spec.T * spec.D,
             spec.P * spec.NC]
    if max(sizes) > _INT_MAX:
        raise NotImplementedError(
            f"the fused MlpMixer kernel indexes a sample with 32-bit ints; "
            f"this shape needs {max(sizes)} elements")
    T, H = spec.T, spec.H
    pieces = []
    with torch.no_grad():
        pieces += [model.conv.weight[:, 0, 0, :].t(), model.conv.bias]
        for mb in model.Mixer_Block:
            if spec.has_tok:
                tm = mb.mlp_block_token_mixing
                A, Pl = _fold(tm, H, False, T, H)
                pieces += [mb.LN1.weight, mb.LN1.bias, tm.fc1.weight.t(),
                           tm.fc1.bias, tm.fc2.weight.t(), A, Pl]
            if spec.use_se:
                exc = mb.se.excitation
                pieces += [exc[0].weight.t(), exc[2].weight.t()]
            if spec.has_ch:
                cm = mb.mlp_block_channel_mixing
                A, Pl = _fold(cm, T, True, T, H)
                pieces += [mb.LN2.weight, mb.LN2.bias, cm.fc1.weight.t(),
                           cm.fc1.bias, cm.fc2.weight.t(), A, Pl]
        pieces += [model.LN.weight, model.LN.bias,
                   model.conv_out.weight[:, :, 0].t(),  # (T, P)
                   model.conv_out.bias,
                   model.fc_out.weight.t(),  # (H, NC)
                   model.fc_out.bias]
        device = model.fc_out.weight.device
        flat = []
        for p in pieces:  # each piece at a 16-byte boundary
            v = p.detach().to(device=device, dtype=torch.float32).reshape(-1)
            flat += [v, torch.zeros(pad4(v.numel()) - v.numel(),
                                    device=device)]
        flat = torch.cat(flat).contiguous()
    if flat.numel() != spec.numel():
        raise AssertionError("packed weights disagree with the layout")
    return spec, flat


def _layer_norm(y, g, b):
    return F.layer_norm(y, (y.shape[-1],), g, b, eps=1e-5)


def _se_gate(z, w1, w2, spec):
    s = z.amax(dim=-1) if spec.use_max else z.mean(dim=-1)  # (B, T)
    h = torch.relu(s @ w1.view(spec.T, spec.S))
    g = torch.sigmoid(h @ w2.view(spec.S, spec.T))
    return z * g[:, :, None]


def mlp_mixer_plain(x: torch.Tensor, flat: torch.Tensor,
                    spec: MlpMixerSpec) -> torch.Tensor:
    """The kernel's function in plain torch: (B, T, D) -> (B, P, NC)."""
    act = get_activation(spec.activation)
    e, blocks, g = _unpack(flat, spec)
    T, H = spec.T, spec.H
    y = x @ e["w_embed"].view(spec.D, H) + e["b_embed"]
    for w in blocks:
        if spec.has_tok:
            z = _layer_norm(y, w["ln1_g"], w["ln1_b"]).transpose(1, 2)
            h1 = act(z @ w["tok_w1"].view(T, spec.tok) + w["tok_b1"])
            z = (h1 @ w["tok_w2"].view(spec.tok, T)).transpose(1, 2)
            z = z * w["tok_A"] + w["tok_P"].view(T, H)
            if spec.use_se:
                z = _se_gate(z, w["se_w1"], w["se_w2"], spec)
            y = y + z
            if spec.block_type == "token_only":
                y = y + z  # the reference's double residual
                continue
        else:
            # the channel-only block's leading x + se(x)
            y = y + (_se_gate(y, w["se_w1"], w["se_w2"], spec)
                     if spec.use_se else y)
        z = _layer_norm(y, w["ln2_g"], w["ln2_b"])
        h1 = act(z @ w["ch_w1"].view(H, spec.ch) + w["ch_b1"])
        z = (h1 @ w["ch_w2"].view(spec.ch, H)) * w["ch_A"][:, None] \
            + w["ch_P"].view(T, H)
        if spec.use_se:
            z = _se_gate(z, w["se_w1"], w["se_w2"], spec)
        y = y + z
    y = _layer_norm(y, g["g_ln"], g["b_ln"]).transpose(1, 2)  # (B, H, T)
    u = (y @ g["w_time"].view(T, spec.P) + g["b_time"]).transpose(1, 2)
    return u @ g["w_out"].view(H, spec.NC) + g["b_out"]


def mlp_mixer_fused(x: torch.Tensor, flat: torch.Tensor,
                    spec: MlpMixerSpec) -> torch.Tensor:
    """(B, T, D) -> (B, P, NC): the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor, an error otherwise."""
    check_inputs("mlp_mixer_fused", x, flat, spec, (spec.T, spec.D))
    if x.device.type == "cpu":
        PLAIN_CALLS.add()
        return mlp_mixer_plain(x, flat, spec)
    B = x.shape[0]
    out = torch.empty((B, spec.P, spec.NC), device=x.device,
                      dtype=torch.float32)
    if B == 0:
        return out
    scratch = (torch.empty(B * spec.sample_floats(), device=x.device,
                           dtype=torch.float32)
               if spec.uses_scratch else None)
    lib = load_library()
    if flat.data_ptr() % 16:
        raise ValueError("the packed weights must start at a 16-byte "
                         "boundary (the kernel copies them in bulk)")
    with torch.cuda.device(x.device):
        err = lib.mmc_mlp_mixer(
            x.data_ptr(), flat.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), B,
            *spec.kernel_args(), stream_ptr(x.device))
    check(lib, err, "mlp_mixer_fused")
    LAUNCHES.add()
    return out


class FusedMlpMixer:
    """A port MlpMixer packed for the fused kernel. ``__call__``:
    (B, seq_len, input_size) -> (B, pred_len, num_classes)."""

    def __init__(self, model):
        self.spec, self.weights = pack_mlp_mixer(model)

    @torch.no_grad()
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_mixer_fused(x.contiguous(), self.weights, self.spec)


def make_fused_mlp_mixer(model) -> FusedMlpMixer:
    """Kernel factory, as the JAX package's ``FusedMlpMixer(model,
    variables)``. NotImplementedError outside the kernel's domain."""
    return FusedMlpMixer(model)

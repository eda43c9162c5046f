"""Plain float32 PyTorch reference of the ConvMixer (reference
``conv_mixer/models/mixer_conv.py``, ``encoding/pose_encoder.py``): its
parameters in the reference's state_dict layout, their seeded init, and the
forward as equations on a dict of tensors.

Nothing here imports the port. It follows the published module:

- encoder: NeRF harmonics sin(x f_i), cos(x f_i) with f_i = omega0 2^i in
  the layout d*n + i, sin block first (none when n = 0), ``embed_mlp``,
  then ``channelUpscaling`` Linear(1, C) to (B, C, T, E);
- each block: x + SE(reg(act(conv1(LN1(x))))), then the same with conv2,
  LN2 and the one SE layer the block shares between its branches; conv2's
  kernel is conv1's transposed and clipped to (T, E); 'same' padding;
- SE: mean over (C, E), Linear(T, T // r) - ReLU - Linear - sigmoid, no
  biases, scaling each time row;
- regularization: dropout(p) for p > 0, BatchNorm2d over C for -1 (flax's
  running variance: the biased batch variance, momentum 0.1, eps 1e-5);
- decoder: LN, a 1x1 conv over time-as-channels (T to P), a 1x1 conv over
  C to 1, exact GELU whatever the activation, Linear(E, D).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]
BN_MOMENTUM = 0.1
EPS = 1e-5


def _k2(cfg) -> Tuple[int, int]:
    k1 = cfg["conv1_kernel_shape"]
    return (min(k1[1], cfg["in_nTP"]), min(k1[0], cfg["dimPosEmb"]))


def param_table(cfg) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every state_dict entry, in order. ``init``:
    'uniform' (U(-1/sqrt(fan_in), +), torch's default), 'ones', 'zeros',
    'freqs', 'running_mean', 'running_var', 'count'."""
    T, E, C = cfg["in_nTP"], cfg["dimPosEmb"], cfg["conv_nChan"]
    D_in, D_out, P = cfg["dimPosIn"], cfg["dimPosOut"], cfg["out_nTP"]
    n = cfg["n_harmonic_functions"]
    h = T // cfg["r_se"]
    k1, k2 = tuple(cfg["conv1_kernel_shape"]), _k2(cfg)
    bn = cfg["regularization"] == -1.0
    out = []
    if n > 0:
        out.append(("encoder.frequencies", (n,), "freqs"))
    emb_in = 2 * n * D_in if n > 0 else D_in
    out += [("encoder.embed_mlp.weight", (E, emb_in), "uniform"),
            ("encoder.embed_mlp.bias", (E,), "uniform"),
            ("encoder.channelUpscaling.weight", (C, 1), "uniform"),
            ("encoder.channelUpscaling.bias", (C,), "uniform")]
    for b in range(cfg["num_blocks"]):
        p = f"Mixer_Block.{b}."
        for conv, k, ln in (("conv1", k1, "LN1"), ("conv2", k2, "LN2")):
            out += [(p + f"{conv}.conv.weight", (C, C, *k), "uniform"),
                    (p + f"{conv}.conv.bias", (C,), "uniform")]
            if bn:
                out += [(p + f"{conv}.reg.weight", (C,), "ones"),
                        (p + f"{conv}.reg.bias", (C,), "zeros"),
                        (p + f"{conv}.reg.running_mean", (C,), "running_mean"),
                        (p + f"{conv}.reg.running_var", (C,), "running_var"),
                        (p + f"{conv}.reg.num_batches_tracked", (), "count")]
            se = "se" if conv == "conv1" else "se2"
            out += [(p + f"{se}.excitationBlock.0.weight", (h, T), "uniform"),
                    (p + f"{se}.excitationBlock.2.weight", (T, h), "uniform"),
                    (p + f"{ln}.weight", (E,), "ones"),
                    (p + f"{ln}.bias", (E,), "zeros")]
    out += [("LN.weight", (E,), "ones"), ("LN.bias", (E,), "zeros"),
            ("conv_out.weight", (P, T, 1, 1), "uniform"),
            ("conv_out.bias", (P,), "uniform"),
            ("project_channels.weight", (1, C, 1, 1), "uniform"),
            ("project_channels.bias", (1,), "uniform"),
            ("fc_out.weight", (D_out, E), "uniform"),
            ("fc_out.bias", (D_out,), "uniform")]
    return out


def _fan_in(name: str, table) -> int:
    """fan_in of a weight or of the bias beside it: the weight's numel per
    output (torch's default init bounds a bias by its weight's fan_in)."""
    wname = name[: -len("bias")] + "weight" if name.endswith("bias") else name
    shape = dict((n, s) for n, s, _ in table)[wname]
    return math.prod(shape[1:])


def init_params(cfg, seed: int, device) -> Params:
    """The state_dict of a freshly initialised model, from ``seed`` alone:
    one uniform draw on ``device`` for every entry at once, scaled per
    entry. Shared SE entries (``se2`` under ``se``'s weights) are the same
    tensors, as the module's alias makes them. BatchNorm running
    statistics are drawn too (mean in [-0.5, 0.5), variance in [0.5,
    1.5)), so that an evaluation exercises them."""
    table = param_table(cfg)
    sizes = [math.prod(s) for _, s, _ in table]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    u = torch.rand(sum(sizes), generator=g, device=device)
    out: Params = {}
    off = 0
    n = cfg["n_harmonic_functions"]
    for (name, shape, init), size in zip(table, sizes):
        x = u[off: off + size].reshape(shape)
        off += size
        if init == "uniform":
            b = 1.0 / math.sqrt(_fan_in(name, table))
            t = (2.0 * x - 1.0) * b
        elif init == "ones":
            t = torch.ones(shape, device=device)
        elif init == "zeros":
            t = torch.zeros(shape, device=device)
        elif init == "freqs":
            t = torch.tensor([cfg["omega0"] * 2.0 ** i for i in range(n)],
                             dtype=torch.float64).float().to(device)
        elif init == "running_mean":
            t = x - 0.5
        elif init == "running_var":
            t = x + 0.5
        else:  # count
            t = torch.zeros((), dtype=torch.long, device=device)
        out[name] = t.contiguous()
    for name in list(out):
        if ".se2." in name:
            out[name] = out[name.replace(".se2.", ".se.")]
    return out


def leaves(params: Params) -> List[str]:
    """The trainable entries: every float entry but the frequencies and
    BatchNorm's running statistics, each shared tensor once (the port's
    ``named_parameters`` order)."""
    return [k for k in params
            if not k.endswith(("frequencies", "running_mean", "running_var",
                               "num_batches_tracked")) and ".se2." not in k]


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


def _act(name: str):
    return {"mish": mish, "gelu": lambda x: F.gelu(x)}[name]


def _reg(p: Params, pre: str, x, cfg, train: bool, update_bn: bool):
    r = cfg["regularization"]
    if r > 0.0:
        return F.dropout(x, r, training=train)
    if r != -1.0:
        return x
    w, b = p[pre + "weight"], p[pre + "bias"]
    rm, rv = p[pre + "running_mean"], p[pre + "running_var"]
    if not train:
        return F.batch_norm(x, rm, rv, w, b, False, 0.0, EPS)
    if update_bn:
        with torch.no_grad():
            dims = (0, 2, 3)
            rm.mul_(1 - BN_MOMENTUM).add_(x.mean(dims), alpha=BN_MOMENTUM)
            rv.mul_(1 - BN_MOMENTUM).add_(x.var(dims, unbiased=False),
                                          alpha=BN_MOMENTUM)
    return F.batch_norm(x, None, None, w, b, True, 0.0, EPS)


def _se(p: Params, pre: str, x):
    y = x.mean(dim=(1, 3))
    y = torch.relu(F.linear(y, p[pre + "excitationBlock.0.weight"]))
    y = torch.sigmoid(F.linear(y, p[pre + "excitationBlock.2.weight"]))
    return x * y[:, None, :, None]


def harmonics(x: torch.Tensor, n: int, omega0: float) -> torch.Tensor:
    freqs = torch.tensor([omega0 * 2.0 ** i for i in range(n)],
                         dtype=torch.float64).float().to(x.device)
    e = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    return torch.cat([torch.sin(e), torch.cos(e)], dim=-1)


def forward(p: Params, x: torch.Tensor, cfg, train: bool = False,
            update_bn: bool = False) -> torch.Tensor:
    """(B, in_nTP, dimPosIn) -> (B, out_nTP, dimPosOut). ``train``: dropout
    draws and BatchNorm takes batch statistics; ``update_bn`` also moves
    the running statistics in ``p`` (in place)."""
    n = cfg["n_harmonic_functions"]
    emb = harmonics(x, n, cfg["omega0"]) if n > 0 else x
    y = F.linear(emb, p["encoder.embed_mlp.weight"], p["encoder.embed_mlp.bias"])
    y = F.linear(y[..., None], p["encoder.channelUpscaling.weight"],
                 p["encoder.channelUpscaling.bias"])  # (B, T, E, C)
    y = y.permute(0, 3, 1, 2)
    E = cfg["dimPosEmb"]
    act = _act(cfg["activation"])
    for b in range(cfg["num_blocks"]):
        pre = f"Mixer_Block.{b}."
        for conv, ln in (("conv1", "LN1"), ("conv2", "LN2")):
            z = F.layer_norm(y, (E,), p[pre + ln + ".weight"],
                             p[pre + ln + ".bias"], EPS)
            z = F.conv2d(z, p[pre + conv + ".conv.weight"],
                         p[pre + conv + ".conv.bias"], padding="same")
            z = _reg(p, pre + conv + ".reg.", act(z), cfg, train, update_bn)
            y = y + _se(p, pre + "se.", z)
    y = F.layer_norm(y, (E,), p["LN.weight"], p["LN.bias"], EPS)
    y = F.conv2d(y.transpose(1, 2), p["conv_out.weight"],
                 p["conv_out.bias"]).transpose(1, 2)  # (B, C, P, E)
    y = F.conv2d(y, p["project_channels.weight"],
                 p["project_channels.bias"])[:, 0]
    y = F.gelu(y)
    return F.linear(y, p["fc_out.weight"], p["fc_out.bias"])


def rollout(step, window: torch.Tensor, n_steps: int,
            out_n: int) -> torch.Tensor:
    """Closed loop: ``step`` maps (B, T, D) to (B, out_n, D); each
    prediction replaces the window's oldest ``out_n`` frames. Returns the
    predictions stitched, (B, n_steps * out_n, D)."""
    preds = []
    for _ in range(n_steps):
        pred = step(window)
        preds.append(pred)
        window = torch.cat([window[:, out_n:], pred], dim=1)
    return torch.cat(preds, dim=1)


def clone(p: Params, device=None) -> Params:
    """A copy of ``p`` (shared entries stay shared)."""
    out: Params = {}
    seen: Dict[int, torch.Tensor] = {}
    for k, v in p.items():
        key = id(v)
        if key not in seen:
            seen[key] = v.detach().clone().to(device or v.device)
        out[k] = seen[key]
    return out


def core_floats(cfg) -> int:
    """Floats of the model after its encoder (what a fused core reads as
    weights): every entry outside ``encoder.``, each shared tensor once."""
    return sum(math.prod(s) for n, s, _ in param_table(cfg)
               if not n.startswith("encoder.") and ".se2." not in n
               and not n.endswith("num_batches_tracked"))


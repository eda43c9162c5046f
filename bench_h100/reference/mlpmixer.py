"""Plain float32 PyTorch reference of the MotionMixer MLP-Mixer (Bouazizi
et al., "MotionMixer: MLP-based 3D Human Body Pose Forecasting", IJCAI
2022; reference ``amass/mlp_mixer.py``, trained by
``amass/train_mixer_amass.py``): its parameters in the reference's
state_dict layout, their seeded init, the forward as equations on a dict
of tensors, and the training loss.

Nothing here imports the port. The forward, on x (B, T, D):

- embedding: a per-frame Linear D -> H (the reference's ``Conv2d(1, H, (1,
  D))``, which spans the whole feature axis: its weight (H, 1, 1, D) read
  as (H, D));
- each block: y = SE(TokenMLP(LN1(x)^T)^T), x <- x + y; then y =
  SE(ChannelMLP(LN2(x))), x <- x + y. An MLP is fc1, GELU (exact),
  dropout, fc2, dropout; the token MLP runs over time (T -> tokens_mlp_dim
  -> T), the channel MLP over H. One SE layer serves both branches of a
  block (a reference quirk kept): the mean over H, Linear(T, T // r) -
  ReLU - Linear - sigmoid, no biases, scaling each time row;
- head: LN, then the reference's ``Conv1d(T, P, 1)`` over time-as-channels
  as the product (P, T) @ (B, T, H) plus its bias, then Linear H -> D.

LayerNorms take eps 1e-5. The loss is the mean joint distance (MPJPE) of
the prediction, weighted over the batch, x 1000 (``loss_scale``; the
input is unscaled meters). Adam with coupled L2 and the per-batch
MultiStepLR are ``train.py``'s ``follow`` and ``lr_at``, which the
ConvMixer's reference shares.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .train import follow, lr_at, mpjpe, wmean  # noqa: F401 (re-exported)

Params = Dict[str, torch.Tensor]
EPS = 1e-5
MLPS = ("mlp_block_token_mixing", "mlp_block_channel_mixing")


def param_table(cfg) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every state_dict entry, in order; ``init``
    'uniform' (U(-1/sqrt(fan_in), +), torch's default), 'ones' or
    'zeros'."""
    H, D = cfg["hidden_dim"], cfg["pose_dim"]
    T, P = cfg["input_n"], cfg["output_n"]
    h = T // cfg["r_se"]
    widths = {MLPS[0]: (T, cfg["tokens_mlp_dim"]),
              MLPS[1]: (H, cfg["channels_mlp_dim"])}
    out = [("conv.weight", (H, 1, 1, D), "uniform"),
           ("conv.bias", (H,), "uniform")]
    for b in range(cfg["num_blocks"]):
        pre = f"Mixer_Block.{b}."
        for mlp in MLPS:
            n, hid = widths[mlp]
            out += [(pre + mlp + ".fc1.weight", (hid, n), "uniform"),
                    (pre + mlp + ".fc1.bias", (hid,), "uniform"),
                    (pre + mlp + ".fc2.weight", (n, hid), "uniform"),
                    (pre + mlp + ".fc2.bias", (n,), "uniform")]
        out += [(pre + "se.excitation.0.weight", (h, T), "uniform"),
                (pre + "se.excitation.2.weight", (T, h), "uniform")]
        for ln in ("LN1", "LN2"):
            out += [(pre + ln + ".weight", (H,), "ones"),
                    (pre + ln + ".bias", (H,), "zeros")]
    out += [("LN.weight", (H,), "ones"), ("LN.bias", (H,), "zeros"),
            ("fc_out.weight", (D, H), "uniform"),
            ("fc_out.bias", (D,), "uniform"),
            ("conv_out.weight", (P, T, 1), "uniform"),
            ("conv_out.bias", (P,), "uniform")]
    return out


def init_params(cfg, seed: int, device) -> Params:
    """The state_dict of a freshly initialised model, from ``seed`` alone:
    one uniform draw on ``device`` for every entry at once, scaled per
    entry by its weight's fan_in (a bias by its weight's)."""
    table = param_table(cfg)
    shapes = {n: s for n, s, _ in table}
    sizes = [math.prod(s) for _, s, _ in table]
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    u = torch.rand(sum(sizes), generator=g, device=device)
    out: Params = {}
    off = 0
    for (name, shape, init), size in zip(table, sizes):
        x = u[off: off + size].reshape(shape)
        off += size
        if init == "uniform":
            w = name[: -len("bias")] + "weight" if name.endswith("bias") else name
            b = 1.0 / math.sqrt(math.prod(shapes[w][1:]))
            t = (2.0 * x - 1.0) * b
        elif init == "ones":
            t = torch.ones(shape, device=device)
        else:
            t = torch.zeros(shape, device=device)
        out[name] = t.contiguous()
    return out


def _mlp(p: Params, pre: str, x, rate: float, train: bool):
    y = F.gelu(F.linear(x, p[pre + "fc1.weight"], p[pre + "fc1.bias"]))
    y = F.linear(F.dropout(y, rate, training=train), p[pre + "fc2.weight"],
                 p[pre + "fc2.bias"])
    return F.dropout(y, rate, training=train)


def _se(p: Params, pre: str, x):
    """(B, T, H): each time row scaled by its excitation."""
    y = torch.relu(F.linear(x.mean(dim=-1), p[pre + "excitation.0.weight"]))
    y = torch.sigmoid(F.linear(y, p[pre + "excitation.2.weight"]))
    return x * y[..., None]


def forward(p: Params, x: torch.Tensor, cfg, train: bool = False
            ) -> torch.Tensor:
    """(B, input_n, pose_dim) -> (B, output_n, pose_dim); ``train`` draws
    the dropout masks."""
    H, rate = cfg["hidden_dim"], cfg["regularization"]
    y = F.linear(x, p["conv.weight"][:, 0, 0, :], p["conv.bias"])  # (B, T, H)
    for b in range(cfg["num_blocks"]):
        pre = f"Mixer_Block.{b}."
        z = F.layer_norm(y, (H,), p[pre + "LN1.weight"], p[pre + "LN1.bias"],
                         EPS).transpose(1, 2)
        z = _mlp(p, pre + MLPS[0] + ".", z, rate, train).transpose(1, 2)
        y = y + _se(p, pre + "se.", z)
        z = F.layer_norm(y, (H,), p[pre + "LN2.weight"], p[pre + "LN2.bias"],
                         EPS)
        z = _mlp(p, pre + MLPS[1] + ".", z, rate, train)
        y = y + _se(p, pre + "se.", z)  # the same SE layer
    y = F.layer_norm(y, (H,), p["LN.weight"], p["LN.bias"], EPS)
    y = p["conv_out.weight"][:, :, 0] @ y + p["conv_out.bias"][:, None]
    return F.linear(y, p["fc_out.weight"], p["fc_out.bias"])


class Task:
    """What a training step computes from a batch of (B, input_n +
    output_n, pose_dim) windows: the model maps the first ``input_n``
    frames to the next ``output_n``; the loss is the weighted mean MPJPE
    times ``loss_scale``."""

    def __init__(self, cfg, input_n: int, output_n: int,
                 loss_scale: float = 1000.0):
        self.cfg, self.input_n, self.output_n = cfg, input_n, output_n
        self.loss_scale = loss_scale

    def predict(self, p, seq: torch.Tensor, train: bool) -> torch.Tensor:
        return forward(p, seq[:, : self.input_n], self.cfg, train)

    def loss(self, p, seq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        gt = seq[:, self.input_n: self.input_n + self.output_n]
        per = mpjpe(self.predict(p, seq, train=True), gt)
        return wmean(per, w) * self.loss_scale

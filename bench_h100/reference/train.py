"""Plain PyTorch reference of a training step and of validation: the
per-sample MPJPE loss weighted over the batch, the closed-loop rollout
(reference ``h36m/train_autoreg_mixer_h36m.py``) with its once-per-step
BatchNorm harvest, and Adam with coupled L2 (``torch.optim.Adam``'s
update written out).

Nothing here imports the port.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from . import convmixer

BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(B, T, 3J) -> (B,): the mean joint distance."""
    b = pred.shape[0]
    return torch.linalg.norm((gt - pred).reshape(b, -1, 3), dim=-1).mean(-1)


def wmean(per: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (per * w).sum() / torch.clamp(w.sum(), min=1.0)


def windows(frames: torch.Tensor, starts: torch.Tensor, seq_len: int,
            dim_used: torch.Tensor) -> torch.Tensor:
    """(B, seq_len, len(dim_used)) windows of an (N, 96) corpus."""
    idx = starts[:, None] + torch.arange(seq_len, device=starts.device)
    return frames[idx][:, :, dim_used]


class Task:
    """What a step computes from a batch of windows (B, L, dims):
    ``direct``: the model maps the first ``input_n`` frames (times
    ``input_scale``) to the next ``output_n``; ``closed_loop``: the model
    (``input_n`` -> ``step`` frames) is rolled over the ``output_n`` frames
    after the first ``input_n``, each prediction fed back, the loss summed
    over the steps over their count, after one train-mode harvest forward
    on the first window that moves BatchNorm's running statistics."""

    def __init__(self, cfg, kind: str, input_n: int, output_n: int,
                 input_scale: float, step: Optional[int] = None):
        self.cfg, self.kind = cfg, kind
        self.input_n, self.output_n = input_n, output_n
        self.input_scale, self.step = input_scale, step

    def per_sample(self, p, seq: torch.Tensor, train: bool) -> torch.Tensor:
        x = seq[:, : self.input_n] * self.input_scale
        gt = seq[:, self.input_n: self.input_n + self.output_n]
        if self.kind == "direct":
            return mpjpe(convmixer.forward(p, x, self.cfg, train), gt)
        n_steps = self.output_n // self.step
        pred = convmixer.rollout(
            lambda win: convmixer.forward(p, win, self.cfg, train), x,
            n_steps, self.step)
        per = sum(mpjpe(pred[:, s * self.step: (s + 1) * self.step],
                        gt[:, s * self.step: (s + 1) * self.step])
                  for s in range(n_steps))
        return per / n_steps

    def test_per_sample(self, p, full: torch.Tensor, dim_used, ignore,
                        equal) -> torch.Tensor:
        """The test's first metric per window of full (B, L, 96) frames:
        direct, the 32-joint MPJPE of the prediction written into the
        ground truth's used dims, each ignored joint copied from its equal
        on both sides (train_mixer_h36m.py:324-397); closed loop, the
        rollout loss (train_autoreg_mixer_h36m.py:261-357)."""
        seq = full[:, :, dim_used]
        if self.kind != "direct":
            return self.per_sample(p, seq, train=False)
        x = seq[:, : self.input_n] * self.input_scale
        gt = full[:, self.input_n: self.input_n + self.output_n]
        pred = gt.clone()
        pred[:, :, dim_used] = convmixer.forward(p, x, self.cfg, False)
        pred[:, :, ignore] = pred[:, :, equal]
        gt = gt.clone()
        gt[:, :, ignore] = gt[:, :, equal]
        return mpjpe(pred, gt)

    def loss(self, p, seq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.kind == "closed_loop" and self.cfg["regularization"] == -1.0:
            with torch.no_grad():
                convmixer.forward(p, seq[:, : self.input_n] * self.input_scale,
                                  self.cfg, train=True, update_bn=True)
        return wmean(self.per_sample(p, seq, train=True), w)


def lr_at(lr: float, milestones, gamma: float, steps_per_epoch: int,
          step: int) -> float:
    """MultiStepLR's learning rate for the step that follows ``step``
    steps, the schedule stepped once a batch with its milestones in epochs
    (the port steps it per batch, the reference per epoch: the same step
    sees the same rate)."""
    for m in milestones:
        if m * steps_per_epoch <= step:
            lr *= gamma
    return lr


def follow(task: Task, params, batches, lr: float, weight_decay: float,
           start: Optional[tuple] = None) -> Dict[str, object]:
    """Run ``len(batches)`` Adam steps from ``params`` (not changed: the
    steps work on a copy) over ``batches`` of (windows, weights). ``start``
    ((first moments, second moments, steps taken), per leaf) continues
    Adam from a state; without it Adam starts afresh. Returns each step's
    loss, the first step's raw gradient and the gradient as Adam takes it
    (plus the coupled L2 term), per leaf, and the copy after the steps
    (BatchNorm's running statistics moved as the steps move them)."""
    p = convmixer.clone(params)
    names = convmixer.leaves(p)
    if start is None:
        m = {k: torch.zeros_like(p[k]) for k in names}
        v = {k: torch.zeros_like(p[k]) for k in names}
        t0 = 0
    else:
        m = {k: start[0][k].clone() for k in names}
        v = {k: start[1][k].clone() for k in names}
        t0 = int(start[2])
    losses: List[float] = []
    grad1 = opt1 = None
    for t, (seq, w) in enumerate(batches, start=t0 + 1):
        for k in names:
            p[k].requires_grad_(True)
        loss = task.loss(p, seq, w)
        grads = torch.autograd.grad(loss, [p[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g = {k: gk + weight_decay * p[k] for k, gk in zip(names, grads)}
            if t == t0 + 1:
                grad1 = {k: gk.detach().clone() for k, gk in zip(names, grads)}
                opt1 = {k: g[k].clone() for k in names}
            b1, b2 = BETAS
            for k in names:
                m[k].mul_(b1).add_(g[k], alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g[k], g[k], value=1 - b2)
                m_hat = m[k] / (1 - b1 ** t)
                v_hat = v[k] / (1 - b2 ** t)
                p[k].requires_grad_(False)
                p[k].sub_(lr * m_hat / (v_hat.sqrt() + ADAM_EPS))
    return {"losses": losses, "grad1": grad1, "opt1": opt1, "params": p}


@torch.no_grad()
def evaluate(task: Task, params, seqs_fn, n: int, block: int) -> float:
    """The eval-mode mean per-sample loss over ``n`` windows, ``seqs_fn(lo,
    hi)`` giving windows lo..hi-1, in blocks of ``block`` windows."""
    total = 0.0
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        total += float(task.per_sample(params, seqs_fn(lo, hi),
                                       train=False).double().sum())
    return total / n

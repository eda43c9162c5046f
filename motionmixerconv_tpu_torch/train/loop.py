"""The direct trainer: train step, epoch driver, validation and grouped
evaluation, with the corpus resident on the training device.

Counterpart of ``motionmixerconv_tpu/train/loop.py`` ``Trainer``. A step
gathers its windows from the device corpus, selects the used dims, runs the
forward, the per-sample loss and the backward, and steps the optimizer; no
step copies anything between host and device, and an epoch reads its loss
back once, at its end. The last batch of an epoch is padded with weight-0
rows, and every loss and metric is computed per sample, then
weight-averaged, so padded results equal the reference's ragged-batch
averages.

Not ported in this slice, each raising NotImplementedError: the mesh
(data-parallel) path, ``run_epochs_fused`` (whole epochs per dispatch) and
the angle loss with its euler evaluation. The JAX package's scan and
prefetch epoch variants have no eager counterpart: PyTorch issues each
step's gather on the stream ahead of its compute already.

Reference call-stack parity: h36m/train_mixer_h36m.py:47-279 (train),
:282-417 (test_mpjpe).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from ..data.constants import H36M_INDEX_TO_EQUAL_EVAL, H36M_INDEX_TO_IGNORE_EVAL
from ..data.windows import WindowedCorpus, batch_starts, gather_windows
from ..metrics.metrics import auc_pck_from_dist, delta_2_gt
from .optim import Optimizer

ANGLE_TODO = ("the angle loss and its euler/joint-angle evaluation land with "
              "the H36M angle slice (ROADMAP queue A item 9)")


def _per_sample_mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B,): mean joint L2, D a multiple of 3."""
    b = pred.shape[0]
    return torch.linalg.norm((gt - pred).reshape(b, -1, 3), dim=-1).mean(-1)


def _per_sample_auc_pck(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(B, T, J, 3) -> (B,): per-sample AUC of PCK over thresholds .001..0.3."""
    dist = torch.sqrt(torch.sum((pred - gt) ** 2, dim=-1))  # (B, T, J)
    return auc_pck_from_dist(dist, dim=(1, 2))


def _wmean(per_sample: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.sum(per_sample * w) / torch.clamp(torch.sum(w), min=1.0)


def _make_delta(seq_all: torch.Tensor) -> torch.Tensor:
    """Frame deltas with the reference's duplicated first step
    (test_mixer_h36m.py:64-72): delta[0] == delta[1] == x1 - x0."""
    d = seq_all[:, 1:] - seq_all[:, :-1]
    return torch.cat([d[:, :1], d], dim=1)


PerSample = Callable[[torch.Tensor, torch.Tensor],
                     "tuple[torch.Tensor, torch.Tensor]"]


class Trainer:
    """Direct (non-autoregressive) trainer for one model + corpus family.

    Args:
        model: maps (B, input_n, len(dim_used)) -> (B, output_n,
            len(dim_used)); it lives on the training device.
        optimizer: ``train.optim.Optimizer`` over the model's parameters.
        loss_type: 'mpjpe' ('angle' is a later slice and raises).
        dim_used: indices into the corpus feature axis fed to the model.
        input_n / output_n: window split.
        input_scale: multiplier on the model input (1/1000 for H36M xyz,
            which is in mm; train_mixer_h36m.py:179).
        loss_scale: multiplier on the train loss.
        delta_x: velocity mode: the model consumes frame deltas and its
            predictions are decoded with a prefix sum.
        mesh: the data-parallel path is a later slice and raises.
    """

    def __init__(self, model: nn.Module, optimizer: Optimizer, *,
                 loss_type: str, dim_used, input_n: int, output_n: int,
                 input_scale: float = 1.0, loss_scale: float = 1.0,
                 delta_x: bool = False, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "the data-parallel (mesh) trainer lands with the multi-GPU "
                "slice (ROADMAP queue A item 17)")
        if loss_type not in ("mpjpe", "angle"):
            raise ValueError(f"unknown loss_type {loss_type}")
        if loss_type == "angle":
            raise NotImplementedError(ANGLE_TODO)
        self.model = model
        self.optimizer = optimizer
        self.loss_type = loss_type
        self.dim_used = np.asarray(dim_used)
        self.input_n = input_n
        self.output_n = output_n
        self.input_scale = input_scale
        self.loss_scale = loss_scale
        self.delta_x = delta_x
        self.device = next(model.parameters()).device
        self._dim_used = torch.as_tensor(self.dim_used, dtype=torch.long,
                                         device=self.device)

    @property
    def seq_len(self) -> int:
        return self.input_n + self.output_n

    def _to_device(self, a: np.ndarray, dtype) -> torch.Tensor:
        return torch.as_tensor(a, dtype=dtype).to(self.device)

    # ------------------------------------------------------------- data prep

    def _prepare(self, batch: torch.Tensor):
        """Slice (B, L, D_full) into model input and dim_used ground truth."""
        seq = batch.index_select(2, self._dim_used)
        seq_in = seq[:, : self.input_n]
        seq_gt = seq[:, self.input_n : self.input_n + self.output_n]
        if self.delta_x:
            delta = _make_delta(torch.cat([seq_in, seq_gt], dim=1))
            return delta[:, : self.input_n], seq_gt, seq_in[:, -1, :]
        return seq_in * self.input_scale, seq_gt, None

    def _predict(self, model_in: torch.Tensor, last) -> torch.Tensor:
        pred = self.model(model_in).float()
        return delta_2_gt(pred, last) if self.delta_x else pred

    # ------------------------------------------------------------ train step

    def train_step(self, frames: torch.Tensor, starts: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
        """One optimizer step on the windows at ``starts`` (weights ``w``);
        returns the weighted mean loss as a device scalar (no host sync)."""
        model_in, seq_gt, last = self._prepare(
            gather_windows(frames, starts, self.seq_len))
        pred = self._predict(model_in, last)
        loss = _wmean(_per_sample_mpjpe(pred, seq_gt), w) * self.loss_scale
        self.optimizer.zero_grad()
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def train_epoch(self, corpus: WindowedCorpus, frames: torch.Tensor,
                    batch_size: int, seed: int) -> float:
        """One epoch over the windows, shuffled by ``seed``; returns the
        sample-weighted mean train loss (train_mixer_h36m.py:195-197), the
        epoch's one host sync."""
        all_s, all_w = zip(*batch_starts(corpus, batch_size, shuffle=True,
                                         seed=seed))
        starts = self._to_device(np.stack(all_s), torch.long)
        w = self._to_device(np.stack(all_w), torch.float32)
        counts = [float(x.sum()) for x in all_w]
        self.model.train()
        total = torch.zeros((), device=self.device)
        for i, k in enumerate(counts):
            total += self.train_step(frames, starts[i], w[i]) * k
        return float(total) / max(sum(counts), 1.0)

    def run_epochs_fused(self, *args, **kwargs):
        raise NotImplementedError(
            "whole epochs per dispatch (--epochs_per_dispatch > 1) land as "
            "CUDA graphs in a later PR (ROADMAP queue A item 19)")

    # ------------------------------------------------------------ evaluation

    def _stack_eval_batches(self, window_starts: np.ndarray,
                            group_ids: np.ndarray, batch_size: int):
        """Pad eval windows to (n_batches, bs) device tensors."""
        n = len(window_starts)
        bs = max(1, min(batch_size, n))
        n_batches = (n + bs - 1) // bs
        pad = n_batches * bs - n
        starts = np.concatenate([window_starts, np.zeros(pad, np.int64)])
        w = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
        gids = np.concatenate([group_ids, np.zeros(pad, np.int64)])
        return (self._to_device(starts.reshape(n_batches, bs), torch.long),
                self._to_device(w.reshape(n_batches, bs), torch.float32),
                self._to_device(gids.reshape(n_batches, bs), torch.long))

    @torch.no_grad()
    def evaluate_grouped(self, frames: torch.Tensor, window_starts: np.ndarray,
                         group_ids: np.ndarray, n_groups: int,
                         batch_size: int, kind: str):
        """Per-group (e.g. per-action) sums of two per-sample metrics and of
        the weights, accumulated on the device by ``index_add_`` and read
        back once. Returns (m1_per_group, m2_per_group, n_per_group) numpy
        arrays (train_mixer_h36m.py:311-323 evaluates each action with its
        own loader; here every group's windows share one corpus)."""
        per_sample = self._per_sample_for_kind(kind)
        starts, w, gids = self._stack_eval_batches(
            window_starts, group_ids, batch_size)
        self.model.eval()
        sums = torch.zeros((3, n_groups), device=self.device)
        for i in range(starts.shape[0]):
            per1, per2 = per_sample(frames, starts[i])
            sums[0].index_add_(0, gids[i], per1 * w[i])
            sums[1].index_add_(0, gids[i], per2 * w[i])
            sums[2].index_add_(0, gids[i], w[i])
        out = sums.cpu().numpy()
        return out[0], out[1], out[2]

    def _per_sample_for_kind(self, kind: str) -> PerSample:
        if kind == "h36m_angle":
            raise NotImplementedError(ANGLE_TODO)
        return {
            "val": self._val_per_sample,
            "h36m_xyz": self._test_h36m_xyz_per_sample,
            "simple": self._test_simple_per_sample,
            "amass22": self._test_amass22_per_sample,
        }[kind]

    def _forward_eval(self, frames, starts):
        batch = gather_windows(frames, starts, self.seq_len)
        model_in, seq_gt, last = self._prepare(batch)
        return batch, self._predict(model_in, last), seq_gt

    def _val_per_sample(self, frames, starts):
        """Per-sample validation loss (duplicated into both metric slots)."""
        _, pred, seq_gt = self._forward_eval(frames, starts)
        per = _per_sample_mpjpe(pred, seq_gt) * self.loss_scale
        return per, per

    def _test_h36m_xyz_per_sample(self, frames, starts):
        """Full-skeleton 32-joint MPJPE + 22-joint AUC-PCK per sample
        (train_mixer_h36m.py:324-397)."""
        batch, pred, seq_gt = self._forward_eval(frames, starts)
        full_gt = batch[:, self.input_n : self.input_n + self.output_n]
        ignore = torch.as_tensor(H36M_INDEX_TO_IGNORE_EVAL, device=self.device)
        equal = torch.as_tensor(H36M_INDEX_TO_EQUAL_EVAL, device=self.device)
        all_seq = full_gt.clone()
        all_seq[:, :, self._dim_used] = pred
        all_seq[:, :, ignore] = all_seq[:, :, equal]
        all_gt = full_gt.clone()
        all_gt[:, :, ignore] = full_gt[:, :, equal]
        b = all_seq.shape[0]
        per_mpjpe = _per_sample_mpjpe(
            all_seq.reshape(b, self.output_n, 32, 3),
            all_gt.reshape(b, self.output_n, 32, 3))
        per_auc = _per_sample_auc_pck(
            pred.reshape(b, self.output_n, -1, 3) / 1000.0,
            seq_gt.reshape(b, self.output_n, -1, 3) / 1000.0)
        return per_mpjpe, per_auc

    def _test_simple_per_sample(self, frames, starts):
        """dim_used-space MPJPE + AUC-PCK per sample
        (train_mixer_ais.py:340-357)."""
        _, pred, seq_gt = self._forward_eval(frames, starts)
        b = pred.shape[0]
        per_mpjpe = _per_sample_mpjpe(pred, seq_gt) * self.loss_scale
        per_auc = _per_sample_auc_pck(
            pred.reshape(b, self.output_n, -1, 3),
            seq_gt.reshape(b, self.output_n, -1, 3))
        return per_mpjpe, per_auc

    def _test_amass22_per_sample(self, frames, starts):
        """AMASS test MPJPE per sample, x1000 (train_mixer_amass.py:153-199,
        JAX ``make_amass_test_fn``): the predicted joints are scattered into
        the 22-joint ground truth (duplicated into both metric slots)."""
        batch, pred, _ = self._forward_eval(frames, starts)
        gt22 = batch[:, self.input_n: self.input_n + self.output_n, : 22 * 3]
        all_seq = gt22.clone()
        all_seq[:, :, self._dim_used] = pred
        per = _per_sample_mpjpe(all_seq, gt22) * 1000.0
        return per, per

    def validate(self, corpus: WindowedCorpus, frames: torch.Tensor,
                 batch_size: int) -> float:
        """Validation loss over the corpus."""
        m1, _, nn_ = self.evaluate_grouped(
            frames, corpus.window_starts, np.zeros(len(corpus), np.int64), 1,
            batch_size, "val")
        return float(m1[0] / max(nn_[0], 1.0))

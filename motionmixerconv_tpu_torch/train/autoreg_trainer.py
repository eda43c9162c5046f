"""Trainer for autoregressive (sliding-window rollout) models.

Counterpart of ``motionmixerconv_tpu/train/autoreg_trainer.py``
(``AutoregressiveTrainer``), after h36m/train_autoreg_mixer_h36m.py:
teacher forcing for the first ``n_epochs_teacher_forcing`` epochs
(:122-125), closed loop afterwards; validation and test always run closed
loop (:153, :322). The reference feeds unscaled (mm) sequences in this path
(``input_scale`` 1.0: there is no /1000 in ``autoregressive_process_batch``)
and the test metric is the rollout loss in dim_used space plus AUC-PCK
scaled by ``auc_scale`` (:322-338), not the full-skeleton MPJPE. With
``loss_type`` 'angle' the rollout loss is the L1 angle loss and the test
takes the euler and joint-angle errors of the stitched prediction put into
the full expmap frame (:360-412).

BatchNorm, as the JAX trainer has it (autoreg_trainer.py:113-171): inside
the rollout, train-mode BatchNorm normalises with batch statistics and its
running stats do not move; once per optimizer step they are harvested from
one train-mode forward on the first model window with the pre-update
parameters. Plain torch would move them on every one of the rollout's
forwards.

Training and evaluation run the plain ``nn.Module`` forward with autograd;
the fused kernels are inference only. On a CUDA device a step (teacher
forcing or closed loop, one graph each) and an evaluation batch are
captured CUDA graphs, replayed once per batch, as in ``Trainer``. Under a
mesh (``Trainer``'s) the harvest forward, like every train-mode forward,
takes the global batch's BatchNorm statistics.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..data.windows import WindowedCorpus, gather_windows
from ..models.common import frozen_running_stats
from ..profiling import span
from .autoregressive import autoregressive_rollout
from .loop import (PerSample, Trainer, _per_sample_auc_pck, _per_sample_euler,
                   _per_sample_joint_angle, _per_sample_l1_angle,
                   _per_sample_mpjpe, _wmean)
from .optim import Optimizer


class AutoregressiveTrainer(Trainer):
    """Extends Trainer with rollout-based train/val/test steps.

    ``input_n``/``output_n`` are the *dataset* window geometry
    (input_n_dataset / output_n_dataset in the reference);
    ``input_n_model``/``output_n_model`` the model's window and
    ``step_window`` the rollout stride.
    """

    def __init__(self, model: nn.Module, optimizer: Optimizer, *,
                 loss_type: str, dim_used, input_n: int, output_n: int,
                 input_n_model: int, output_n_model: int, step_window: int,
                 input_scale: float = 1.0, loss_scale: float = 1.0,
                 auc_scale: float = 1e-3, mesh=None):
        super().__init__(model, optimizer, loss_type=loss_type,
                         dim_used=dim_used, input_n=input_n,
                         output_n=output_n, input_scale=input_scale,
                         loss_scale=loss_scale, mesh=mesh)
        self.input_n_model = input_n_model
        self.output_n_model = output_n_model
        self.step_window = step_window
        # h36m divides AUC-PCK by 1000 (train_autoreg_mixer_h36m.py:327-329);
        # the AIS variant does not (train_autoreg_mixer_ais.py:266-268)
        self.auc_scale = auc_scale
        self._has_bn = any(isinstance(m, nn.BatchNorm2d)
                           for m in model.modules())

    def _sequence(self, frames: torch.Tensor, starts: torch.Tensor):
        """The windows at ``starts`` in full-frame and in dim_used space,
        times input_scale."""
        batch = gather_windows(frames, starts, self.seq_len)
        return batch, batch.index_select(2, self._dim_used) * self.input_scale

    def _rollout(self, seq: torch.Tensor, teacher_forcing: bool):
        return autoregressive_rollout(
            lambda x: self.model(x).float(), seq,
            input_n_model=self.input_n_model,
            output_n_model=self.output_n_model,
            step_window=self.step_window, teacher_forcing=teacher_forcing,
            loss_per_sample=(_per_sample_mpjpe if self.loss_type == "mpjpe"
                             else _per_sample_l1_angle))

    # ------------------------------------------------------------ train step

    def _train_loss(self, frames: torch.Tensor, starts: torch.Tensor,
                    w: torch.Tensor, teacher_forcing=None,
                    total=None) -> torch.Tensor:
        """The weighted mean rollout loss of the windows at ``starts``,
        after the once-per-step BatchNorm harvest. ``teacher_forcing`` is
        fixed in a captured step, as the JAX trainer binds it statically;
        so is ``frozen_running_stats``, a host attribute set at capture."""
        if teacher_forcing is None:
            raise ValueError("the autoregressive step needs teacher_forcing")
        _, seq = self._sequence(frames, starts)
        if self._has_bn:
            # the once-per-step running-stats harvest, before the update
            with torch.no_grad():
                self.model(seq[:, : self.input_n_model])
        with frozen_running_stats(self.model):
            per_sample, _ = self._rollout(seq, teacher_forcing)
        return _wmean(per_sample, w, total) * self.loss_scale

    def train_step_ar(self, frames: torch.Tensor, starts: torch.Tensor,
                      w: torch.Tensor, teacher_forcing: bool) -> torch.Tensor:
        """One optimizer step of the rollout loss on the windows at
        ``starts`` (weights ``w``; the global batch under a mesh); returns
        the weighted mean loss as a device scalar (no host sync)."""
        starts, w, total = self._shard(starts, w)
        loss = self._step(frames, starts, w, teacher_forcing, total=total)
        self.optimizer.advance()
        return self._reduce(loss)

    def train_epoch_ar(self, corpus: WindowedCorpus, frames: torch.Tensor,
                       batch_size: int, seed: int, teacher_forcing: bool,
                       scan: bool = True) -> float:
        """One epoch over the windows, shuffled by ``seed``; returns the
        sample-weighted mean train loss, the epoch's one host read. On a
        CUDA device ``scan`` replays one captured step per batch, a graph
        for each value of ``teacher_forcing``. A non-finite loss raises
        FloatingPointError (the reference's ``assert not isnan(loss)``,
        train_autoreg_mixer_h36m.py:256)."""
        with span("train.epoch"):
            starts, w = self._epoch_batches(corpus, batch_size, [seed])
            sums = self._reduce(self._train_sums(
                frames, starts[0], w[0], teacher_forcing, scan))
            with span("read"):
                total, n = sums.tolist()
        mean_loss = total / max(n, 1.0)
        if not np.isfinite(mean_loss):
            # closed-loop gradients can explode through the feedback rollout
            raise FloatingPointError(
                "Loss is nan — closed-loop rollout diverged "
                "(try --clip_grad or more teacher-forcing epochs)")
        return mean_loss

    # ------------------------------------------------------------ evaluation

    def _ar_val_per_sample(self, frames, starts):
        """Per-sample closed-loop rollout loss (in both metric slots)."""
        _, seq = self._sequence(frames, starts)
        per, _ = self._rollout(seq, False)
        per = per * self.loss_scale
        return per, per

    def _ar_test_per_sample(self, frames, starts):
        """Per-sample closed-loop rollout test (train_autoreg_mixer_h36m.py:
        261-357, :360-412). mpjpe: the rollout loss and the AUC-PCK of the
        stitched prediction, scaled by ``auc_scale``; angle: the euler and
        joint-angle errors of the stitched prediction put into the full
        frame."""
        batch, seq = self._sequence(frames, starts)
        per_loss, full_pred = self._rollout(seq, False)
        if self.loss_type == "angle":
            full_gt = batch[:, self.input_n:]
            all_seq = self._in_full_frame(full_gt, full_pred)
            return (_per_sample_euler(all_seq, full_gt),
                    _per_sample_joint_angle(all_seq, full_gt))
        gt = seq[:, self.input_n:]
        b = gt.shape[0]
        per_metric = _per_sample_auc_pck(
            full_pred.reshape(b, self.output_n, -1, 3) * self.auc_scale,
            gt.reshape(b, self.output_n, -1, 3) * self.auc_scale)
        return per_loss, per_metric

    def _per_sample_for_kind(self, kind: str) -> PerSample:
        if kind == "ar":
            return self._ar_test_per_sample
        if kind == "val":
            return self._ar_val_per_sample
        return super()._per_sample_for_kind(kind)

    def evaluate_ar(self, corpus: WindowedCorpus, frames: torch.Tensor,
                    batch_size: int, kind: str = "val"):
        """Closed-loop evaluation over the corpus. kind 'val' -> the mean
        rollout loss; 'test' -> (mean rollout loss, mean AUC-PCK)."""
        m1, m2, n = self.evaluate_grouped(
            frames, corpus.window_starts, np.zeros(len(corpus), np.int64), 1,
            batch_size, "val" if kind == "val" else "ar")
        if kind == "val":
            return float(m1[0] / max(n[0], 1.0))
        return float(m1[0] / max(n[0], 1.0)), float(m2[0] / max(n[0], 1.0))

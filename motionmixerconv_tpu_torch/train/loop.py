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

On a CUDA device ``train_epoch``, ``validate``, ``evaluate_grouped`` and
``run_epochs_fused`` replay a captured CUDA graph of one step (one
evaluation batch) per batch (``train/graphs.py``), the counterpart of the
JAX package's ``lax.scan`` over batches; their ``scan=False`` launches
every step op by op, as the JAX package's does. ``run_epochs_fused`` runs
K epochs of train, validation and grouped test and reads their results
back once.

Both loss types are ported: 'mpjpe' (xyz) and 'angle' (L1 on the expmap
dims, validated and tested by the euler error on the full frame, whose
gimbal branches are masks, so the evaluation is device work a graph can
replay).

Under a data-parallel mesh (``mesh=``, a ``parallel.DataMesh`` of ranks
started by ``parallel.launch``) a run on n ranks computes what the same
run computes on one, as the JAX package's single-controller mesh does:
each rank takes the contiguous rows ``[r*B/n, (r+1)*B/n)`` of every global
batch, in ``batch_starts``' order; its loss is its weighted sum over the
global batch's weight sum (every rank holds the global batch's weights, so
that sum needs no collective); the gradients are summed over the ranks by
one all-reduce, before the clip, and every rank steps Adam alike from rank
0's parameters; BatchNorm and Dropout take the global batch
(``models/common.py``); evaluation rounds its batch up to a multiple of n
with weight-0 rows; every epoch's and evaluation's sums are all-reduced
once, at the end. On NCCL the collectives are captured in the step graphs;
gloo cannot capture one, so there the steps run eagerly, as
``scan=False``.

Reference call-stack parity: h36m/train_mixer_h36m.py:47-279 (train),
:282-417 (test_mpjpe), :420-469 (test_angle).
"""

from __future__ import annotations

import hashlib
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..data.constants import H36M_INDEX_TO_EQUAL_EVAL, H36M_INDEX_TO_IGNORE_EVAL
from ..data.windows import WindowedCorpus, batch_starts, gather_windows
from ..geometry.rotations import expmap2rotmat, rotmat2euler
from ..metrics.metrics import auc_pck_from_dist, delta_2_gt
from ..models.common import use_mesh
from ..parallel.mesh import DataMesh, replicated_sharding
from ..profiling import span
from .graphs import StepGraph
from .optim import Optimizer


def _per_sample_mpjpe(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B,): mean joint L2, D a multiple of 3."""
    b = pred.shape[0]
    return torch.linalg.norm((gt - pred).reshape(b, -1, 3), dim=-1).mean(-1)


def _per_sample_l1_angle(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(B, T, D) -> (B,): mean over T of sum-abs over D (the angle train
    loss)."""
    return torch.abs(pred - gt).sum(dim=2).mean(dim=1)


def _per_sample_euler(pred_ang: torch.Tensor, gt_ang: torch.Tensor
                      ) -> torch.Tensor:
    """(B, T, D) expmap -> (B,): mean over T of the D-dim euler-diff norm."""
    b, t, d = pred_ang.shape
    pe = rotmat2euler(expmap2rotmat(pred_ang.reshape(-1, 3))).reshape(b, t, d)
    te = rotmat2euler(expmap2rotmat(gt_ang.reshape(-1, 3))).reshape(b, t, d)
    return torch.linalg.norm(pe - te, dim=-1).mean(dim=-1)


def _per_sample_joint_angle(pred: torch.Tensor, gt: torch.Tensor
                            ) -> torch.Tensor:
    """(B, T, D) -> (B,): mean over T of the D-dim angle-diff norm."""
    return torch.linalg.norm(gt - pred, dim=-1).mean(dim=-1)


def _per_sample_auc_pck(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """(B, T, J, 3) -> (B,): per-sample AUC of PCK over thresholds .001..0.3."""
    dist = torch.sqrt(torch.sum((pred - gt) ** 2, dim=-1))  # (B, T, J)
    return auc_pck_from_dist(dist, dim=(1, 2))


def _wmean(per_sample: torch.Tensor, w: torch.Tensor,
           total: Optional[torch.Tensor] = None) -> torch.Tensor:
    """sum(per_sample * w) over max(total, 1); ``total`` is the global
    batch's weight sum under a mesh, else the sum of ``w``."""
    total = torch.sum(w) if total is None else total
    return torch.sum(per_sample * w) / torch.clamp(total, min=1.0)


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
        optimizer: ``train.optim.Optimizer`` over the model's parameters
            (None for a trainer that only evaluates).
        loss_type: 'mpjpe' or 'angle' (L1 train loss, euler validation).
        dim_used: indices into the corpus feature axis fed to the model.
        input_n / output_n: window split.
        input_scale: multiplier on the model input (1/1000 for H36M xyz,
            which is in mm; 1.0 for angles, AIS and AMASS;
            train_mixer_h36m.py:179).
        loss_scale: multiplier on the train loss.
        delta_x: velocity mode: the model consumes frame deltas and its
            predictions are decoded with a prefix sum.
        mesh: a ``parallel.DataMesh`` of ranks: data-parallel training
            and evaluation (module docstring); the model lives on
            ``mesh.device``. Only rank 0 writes (``is_writer``).
    """

    def __init__(self, model: nn.Module, optimizer: Optional[Optimizer], *,
                 loss_type: str, dim_used, input_n: int, output_n: int,
                 input_scale: float = 1.0, loss_scale: float = 1.0,
                 delta_x: bool = False, mesh=None):
        if loss_type not in ("mpjpe", "angle"):
            raise ValueError(f"unknown loss_type {loss_type}")
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
        self._ignore = torch.as_tensor(H36M_INDEX_TO_IGNORE_EVAL,
                                       device=self.device)
        self._equal = torch.as_tensor(H36M_INDEX_TO_EQUAL_EVAL,
                                      device=self.device)
        self._graphs: dict = {}
        self._eval_stacks: dict = {}
        self.mesh = mesh
        self._capture = True  # steps on a CUDA device replay graphs
        if mesh is not None:
            self._join(mesh)

    def _join(self, mesh: DataMesh) -> None:
        """Check ``mesh``, start every rank from rank 0's parameters and
        buffers, and let BatchNorm and Dropout see the global batch."""
        if not isinstance(mesh, DataMesh):
            raise TypeError(f"mesh must be a parallel.DataMesh, not "
                            f"{type(mesh).__name__}")
        if mesh.group is None and mesh.size > 1:
            raise ValueError(
                "a trainer's mesh is one of ranks (parallel.launch); a "
                "one-process mesh over several devices serves "
                "Predictor(mesh=) only")
        if mesh.device != self.device:
            raise ValueError(f"the model is on {self.device}, the mesh's "
                             f"rank on {mesh.device}")
        replicated_sharding(mesh, self.model)
        use_mesh(self.model, mesh)
        # gloo's collectives cannot be captured in a CUDA graph
        self._capture = mesh.backend != "gloo"
        if self.device.type == "cuda" and not self._capture and mesh.rank == 0:
            warnings.warn(f"a mesh on {mesh.backend}: the steps run eagerly "
                          "(a gloo collective cannot be captured in a CUDA "
                          "graph)", stacklevel=3)

    @property
    def is_writer(self) -> bool:
        """Whether this process writes checkpoints and logs: rank 0 only,
        as the JAX package's single controller writes once."""
        return self.mesh is None or self.mesh.rank == 0

    def _shard(self, starts: torch.Tensor, w: torch.Tensor):
        """This rank's rows of the global batch(es) on the last axis, and
        the global weight sums (None without a mesh)."""
        if self.mesh is None:
            return starts, w, None
        rows = self.mesh.rows(w.shape[-1])
        return starts[..., rows], w[..., rows], w.sum(-1)

    def _reduce(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks (in place); as it is without a
        mesh."""
        return t if self.mesh is None else self.mesh.all_reduce(t)

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

    def _train_loss(self, frames: torch.Tensor, starts: torch.Tensor,
                    w: torch.Tensor, teacher_forcing=None,
                    total: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The weighted mean train loss of the windows at ``starts``
        (this rank's part of it under a mesh: ``total`` is the global
        weight sum)."""
        model_in, seq_gt, last = self._prepare(
            gather_windows(frames, starts, self.seq_len))
        pred = self._predict(model_in, last)
        per = (_per_sample_mpjpe if self.loss_type == "mpjpe"
               else _per_sample_l1_angle)(pred, seq_gt)
        return _wmean(per, w, total) * self.loss_scale

    def _step(self, frames: torch.Tensor, starts: torch.Tensor,
              w: torch.Tensor, teacher_forcing=None,
              sums: Optional[torch.Tensor] = None,
              total: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The device work of one optimizer step (the body a CUDA graph
        captures): forward, loss, backward, the gradients' all-reduce under
        a mesh, clip and Adam; adds (loss * weight sum, sum w) into
        ``sums``. Returns the loss (this rank's part under a mesh) as a
        device scalar."""
        loss = self._train_loss(frames, starts, w, teacher_forcing, total)
        self.optimizer.zero_grad()
        loss.backward()
        if self.mesh is not None:
            self.mesh.all_reduce_grads(self.optimizer.params)
        self.optimizer.update()
        loss = loss.detach()
        if sums is not None:
            n = w.sum()
            sums += torch.stack([loss * (n if total is None else total), n])
        return loss

    def train_step(self, frames: torch.Tensor, starts: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
        """One optimizer step on the windows at ``starts`` (weights ``w``;
        the global batch under a mesh); returns the weighted mean loss as
        a device scalar (no host sync)."""
        starts, w, total = self._shard(starts, w)
        loss = self._step(frames, starts, w, total=total)
        self.optimizer.advance()
        return self._reduce(loss)

    def _epoch_batches(self, corpus: WindowedCorpus, batch_size: int,
                       seeds: Sequence[int], orders=None):
        """(len(seeds), n_batches, B) starts and weights of the shuffled
        epochs, copied to the device at once. ``orders`` (one window
        permutation or None per epoch) replaces an epoch's shuffle: the
        order reaches a captured step only through these device buffers,
        which every replay reads."""
        with span("train.batches"):
            all_s, all_w = [], []
            for seed, order in zip(seeds, orders or [None] * len(seeds)):
                s, w = zip(*batch_starts(corpus, batch_size, shuffle=True,
                                         seed=seed, order=order))
                all_s.append(np.stack(s))
                all_w.append(np.stack(w))
            return (self._to_device(np.stack(all_s), torch.long),
                    self._to_device(np.stack(all_w), torch.float32))

    def _runner(self, key: tuple, frames: torch.Tensor, body,
                sums_shape, scan: bool) -> StepGraph:
        """The step runner for ``body``: on a CUDA device with ``scan`` the
        graph cached under ``key`` and the corpus ``frames`` it reads (the
        graph holds the corpus, so its address stays that corpus's), else
        an eager one. ``key[0]`` ("train" or "eval") names its spans."""
        kind = key[0]
        if not (scan and self.device.type == "cuda" and self._capture):
            return StepGraph(body, self.device, sums_shape, capture=False,
                             kind=kind)
        key = (*key, frames.data_ptr(), tuple(frames.shape))
        runner = self._graphs.get(key)
        if runner is None:
            runner = self._graphs[key] = StepGraph(
                body, self.device, sums_shape, capture=True, kind=kind)
        return runner

    def _train_sums(self, frames: torch.Tensor, starts: torch.Tensor,
                    w: torch.Tensor, teacher_forcing=None,
                    scan: bool = True) -> torch.Tensor:
        """One epoch's steps over (n_batches, B) ``starts``/``w`` (the
        global batches under a mesh); returns the device sums (loss * sum
        w, sum w) without a host read, this rank's under a mesh."""
        self.model.train()
        starts, w, total = self._shard(starts, w)
        stacked = (starts, w) if total is None else (starts, w, total)
        runner = self._runner(
            ("train", teacher_forcing, w.shape[1],
             self.optimizer.generation), frames,
            lambda sums, s, ww, *tot: self._step(frames, s, ww,
                                                 teacher_forcing, sums, *tot),
            (2,), scan)
        sums = runner.run(*stacked, after=self.optimizer.advance)
        if runner.graph is not None:
            # replays updated the parameters in place without bumping their
            # version counters, which version-keyed caches read
            for p in self.model.parameters():
                torch.autograd.graph.increment_version(p)
        return sums

    def train_epoch(self, corpus: WindowedCorpus, frames: torch.Tensor,
                    batch_size: int, seed: int, scan: bool = True,
                    order: Optional[np.ndarray] = None) -> float:
        """One epoch over the windows, shuffled by ``seed``; returns the
        sample-weighted mean train loss (train_mixer_h36m.py:195-197), the
        epoch's one host read. ``scan`` (on a CUDA device) replays a
        captured step per batch, the JAX scan's counterpart; ``scan=False``
        launches each step op by op. ``order`` replaces the shuffle with an
        explicit window permutation (the lockstep parity runs)."""
        with span("train.epoch"):
            starts, w = self._epoch_batches(corpus, batch_size, [seed],
                                            [order])
            sums = self._reduce(
                self._train_sums(frames, starts[0], w[0], scan=scan))
            with span("read"):
                total, n = sums.tolist()
        return total / max(n, 1.0)

    def run_epochs_fused(self, corpus: WindowedCorpus, frames: torch.Tensor,
                         batch_size: int, seeds: Sequence[int],
                         vald: WindowedCorpus, vframes: torch.Tensor,
                         tframes: torch.Tensor, test_starts: np.ndarray,
                         test_gids: np.ndarray, n_groups: int,
                         test_kind: str, batch_size_test: int,
                         teacher_forcing=None, scan: bool = True) -> dict:
        """``len(seeds)`` whole epochs (train, validation and the grouped
        test of ``test_kind`` each) with one host read at the end: the JAX
        ``run_epochs_fused`` without its ``state``. ``seeds``: one shuffle
        seed per epoch (the drivers pass the epoch index, as
        ``train_epoch(seed=epoch)``). ``teacher_forcing``: None for the
        direct trainer, the chunk's flag for the autoregressive one.

        Returns numpy arrays of leading dimension K: ``train`` and ``val``
        (the losses ``train_epoch`` and ``validate`` return) and the
        per-group test sums ``m1``, ``m2``, ``n`` of ``evaluate_grouped``.
        """
        starts, w = self._epoch_batches(corpus, batch_size, seeds)
        vgids = np.zeros(len(vald), np.int64)
        rows = []
        for k in range(len(seeds)):
            tr = self._train_sums(frames, starts[k], w[k], teacher_forcing,
                                  scan)
            va = self._eval_sums(vframes, vald.window_starts, vgids, 1,
                                 batch_size, "val", scan)
            te = self._eval_sums(tframes, test_starts, test_gids, n_groups,
                                 batch_size_test, test_kind, scan)
            rows.append(torch.cat([tr, va.flatten(), te.flatten()]))
        # the chunk's one all-reduce and one host read
        out = self._reduce(torch.stack(rows))
        with span("read"):
            out = out.cpu().numpy()
        tr, va = out[:, :2].astype(np.float64), out[:, 2:5]
        te = out[:, 5:].reshape(len(seeds), 3, n_groups)
        return {"train": tr[:, 0] / np.maximum(tr[:, 1], 1.0),
                "val": va[:, 0] / np.maximum(va[:, 2], 1.0),
                "m1": te[:, 0], "m2": te[:, 1], "n": te[:, 2]}

    # ------------------------------------------------------------ evaluation

    def _stack_eval_batches(self, window_starts: np.ndarray,
                            group_ids: np.ndarray, batch_size: int):
        """Pad eval windows to (n_batches, bs) device tensors, kept per
        content (as the JAX package keeps its fused evaluation stacks), so
        that an evaluation set is copied to the device once. Under a mesh
        bs is rounded up to a multiple of the ranks (weight-0 rows absorb
        the extra) and each rank keeps its rows."""
        key = (_content_key(window_starts), _content_key(group_ids),
               batch_size)
        hit = self._eval_stacks.get(key)
        if hit is not None:
            return hit
        n = len(window_starts)
        bs = max(1, min(batch_size, n))
        if self.mesh is not None:
            bs = -(-bs // self.mesh.size) * self.mesh.size
        n_batches = (n + bs - 1) // bs
        pad = n_batches * bs - n
        # padding repeats the first window (as batch_starts does): finite
        starts = np.concatenate([window_starts,
                                 np.repeat(window_starts[:1], pad)])
        w = np.concatenate([np.ones(n, np.float32), np.zeros(pad, np.float32)])
        gids = np.concatenate([group_ids, np.zeros(pad, np.int64)])
        rows = slice(None) if self.mesh is None else self.mesh.rows(bs)
        hit = self._eval_stacks[key] = tuple(
            self._to_device(np.ascontiguousarray(
                a.reshape(n_batches, bs)[:, rows]), dtype)
            for a, dtype in ((starts, torch.long), (w, torch.float32),
                             (gids, torch.long)))
        return hit

    def _eval_sums(self, frames: torch.Tensor, window_starts: np.ndarray,
                   group_ids: np.ndarray, n_groups: int, batch_size: int,
                   kind: str, scan: bool = True) -> torch.Tensor:
        """(3, n_groups) device sums of the two per-sample metrics of
        ``kind`` times the weights, and of the weights, per group (this
        rank's under a mesh); no host read."""
        per_sample = self._per_sample_for_kind(kind)
        with span("eval.stack"):
            starts, w, gids = self._stack_eval_batches(
                window_starts, group_ids, batch_size)

        def body(sums, s, ww, g):
            with torch.no_grad():
                per1, per2 = per_sample(frames, s)
                sums[0].index_add_(0, g, per1 * ww)
                sums[1].index_add_(0, g, per2 * ww)
                sums[2].index_add_(0, g, ww)

        self.model.eval()
        return self._runner(("eval", kind, n_groups, starts.shape[1]), frames,
                            body, (3, n_groups), scan).run(starts, w, gids)

    def evaluate_grouped(self, frames: torch.Tensor, window_starts: np.ndarray,
                         group_ids: np.ndarray, n_groups: int,
                         batch_size: int, kind: str, scan: bool = True):
        """Per-group (e.g. per-action) sums of two per-sample metrics and of
        the weights, accumulated on the device by ``index_add_`` and read
        back once. Returns (m1_per_group, m2_per_group, n_per_group) numpy
        arrays (train_mixer_h36m.py:311-323 evaluates each action with its
        own loader; here every group's windows share one corpus). ``scan``
        as in ``train_epoch``."""
        with span("eval.pass"):
            out = self._reduce(self._eval_sums(
                frames, window_starts, group_ids, n_groups, batch_size, kind,
                scan))
            with span("read"):
                out = out.cpu().numpy()
        return out[0], out[1], out[2]

    def _per_sample_for_kind(self, kind: str) -> PerSample:
        return {
            "val": self._val_per_sample,
            "h36m_xyz": self._test_h36m_xyz_per_sample,
            "h36m_angle": self._test_h36m_angle_per_sample,
            "simple": self._test_simple_per_sample,
            "amass22": self._test_amass22_per_sample,
        }[kind]

    def _forward_eval(self, frames, starts):
        batch = gather_windows(frames, starts, self.seq_len)
        model_in, seq_gt, last = self._prepare(batch)
        return batch, self._predict(model_in, last), seq_gt

    def _in_full_frame(self, full_gt: torch.Tensor, pred: torch.Tensor
                       ) -> torch.Tensor:
        """The full-frame ground truth with the dim_used dims replaced by
        ``pred``."""
        out = full_gt.clone()
        out[:, :, self._dim_used] = pred
        return out

    def _val_per_sample(self, frames, starts):
        """Per-sample validation loss (duplicated into both metric slots):
        MPJPE in dim_used space, or for angles the euler error of the
        prediction put into the full frame (train_mixer_h36m.py:215-240)."""
        batch, pred, seq_gt = self._forward_eval(frames, starts)
        if self.loss_type == "mpjpe":
            per = _per_sample_mpjpe(pred, seq_gt) * self.loss_scale
        else:
            full_gt = batch[:, self.input_n : self.input_n + self.output_n]
            per = _per_sample_euler(self._in_full_frame(full_gt, pred),
                                    full_gt)
        return per, per

    def h36m_xyz_outputs(self, frames, starts):
        """(prediction, dim_used ground truth, per-sample full-skeleton
        32-joint MPJPE) of the windows at ``starts``: the prediction is
        written into the 32-joint ground truth and the ignored joints are
        re-inserted from their equals (train_mixer_h36m.py:324-397)."""
        batch, pred, seq_gt = self._forward_eval(frames, starts)
        full_gt = batch[:, self.input_n : self.input_n + self.output_n]
        all_seq = self._in_full_frame(full_gt, pred)
        all_seq[:, :, self._ignore] = all_seq[:, :, self._equal]
        all_gt = full_gt.clone()
        all_gt[:, :, self._ignore] = full_gt[:, :, self._equal]
        b = all_seq.shape[0]
        per_mpjpe = _per_sample_mpjpe(
            all_seq.reshape(b, self.output_n, 32, 3),
            all_gt.reshape(b, self.output_n, 32, 3))
        return pred, seq_gt, per_mpjpe

    def _test_h36m_xyz_per_sample(self, frames, starts):
        """Full-skeleton 32-joint MPJPE + 22-joint AUC-PCK per sample
        (train_mixer_h36m.py:324-397)."""
        pred, seq_gt, per_mpjpe = self.h36m_xyz_outputs(frames, starts)
        b = pred.shape[0]
        per_auc = _per_sample_auc_pck(
            pred.reshape(b, self.output_n, -1, 3) / 1000.0,
            seq_gt.reshape(b, self.output_n, -1, 3) / 1000.0)
        return per_mpjpe, per_auc

    def _test_h36m_angle_per_sample(self, frames, starts):
        """Euler and joint-angle errors per sample, the prediction put into
        the full expmap frame (train_mixer_h36m.py:445-463)."""
        batch, pred, _ = self._forward_eval(frames, starts)
        full_gt = batch[:, self.input_n : self.input_n + self.output_n]
        all_seq = self._in_full_frame(full_gt, pred)
        return (_per_sample_euler(all_seq, full_gt),
                _per_sample_joint_angle(all_seq, full_gt))

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
        per = _per_sample_mpjpe(self._in_full_frame(gt22, pred), gt22) * 1000.0
        return per, per

    def evaluate(self, corpus: WindowedCorpus, frames: torch.Tensor,
                 batch_size: int, kind: str = "val"):
        """The corpus's evaluation of ``kind`` (``evaluate_grouped`` with
        one group): 'val' -> the scalar loss; 'h36m_xyz', 'h36m_angle',
        'simple', 'amass22' -> (metric1, metric2), each a weighted mean over
        the windows."""
        m1, m2, nn_ = self.evaluate_grouped(
            frames, corpus.window_starts, np.zeros(len(corpus), np.int64), 1,
            batch_size, kind)
        n = max(float(nn_[0]), 1.0)
        if kind == "val":
            return float(m1[0] / n)
        return float(m1[0] / n), float(m2[0] / n)

    def validate(self, corpus: WindowedCorpus, frames: torch.Tensor,
                 batch_size: int) -> float:
        """Validation loss over the corpus."""
        return self.evaluate(corpus, frames, batch_size, "val")


def _content_key(a) -> tuple:
    """A key for an array's content (not its id, which CPython recycles)."""
    a = np.ascontiguousarray(a)
    return a.shape, a.dtype.str, hashlib.sha1(a.tobytes()).hexdigest()

"""The training-run driver behind the H36M CLI.

Counterpart of ``motionmixerconv_tpu/cli/_runner.py`` for the direct H36M
path: build the model from the flags, load the three splits, train epoch
by epoch, validate on S11, run the grouped test over the actions, log, and
write a checkpoint every epoch. The other drivers (autoregressive, AIS,
AMASS) land with their slices.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np
import torch

from ..data import H36MDataset
from ..data.constants import H36M_DIM_USED_XYZ, define_actions
from ..logging import MetricLogger
from ..models import ConvMixer
from ..serving import resolve_device
from ..train import Trainer, make_optimizer, restore_checkpoint, save_checkpoint

STATE_FILE = "train_state.pt"  # full training state, for --resume
WEIGHTS_FILE = "model.pt"      # reference-layout weights, for serving


def build_conv_mixer(args, dim_in: int, dim_out: int, in_ntp: int,
                     out_ntp: int,
                     generator: Optional[torch.Generator] = None
                     ) -> ConvMixer:
    """ConvMixer from CLI flags (train_mixer_h36m.py:575-595 defaults);
    ``generator`` seeds its init."""
    if getattr(args, "embed_dtype", "f32") != "f32":
        raise NotImplementedError(
            "--embed_dtype bf16 is not ported to the training CLI yet "
            "(ROADMAP queue A item 19)")
    return ConvMixer(
        num_blocks=args.num_blocks,
        dimPosIn=dim_in,
        dimPosEmb=args.hidden_dim,
        dimPosOut=dim_out,
        in_nTP=in_ntp,
        out_nTP=out_ntp,
        conv_nChan=getattr(args, "conv_nChan", 1),
        conv1_kernel_shape=tuple(getattr(args, "conv1_kernel_shape", (1, 3))),
        conv1_stride=(1, 1),
        conv1_padding=None,
        mode_conv=getattr(args, "mode_conv", "twice"),
        activation=args.activation,
        regularization=args.regularization,
        use_se=True,
        r_se=args.r_se,
        use_max_pooling=False,
        encoder_n_harmonic_functions=getattr(
            args, "encoder_n_harmonic_functions", 64),
        encoder_omega0=getattr(args, "encoder_omega0", 0.1),
        encoder_fused=getattr(args, "fused_encoder", False),
        encoder_harmonic_impl=getattr(args, "harmonic_impl", "direct"),
        generator=generator,
    )


def _log_dir(args, model_name: str) -> str:
    log_dir = os.path.join(args.save_path, model_name)
    if (os.path.exists(log_dir) and os.listdir(log_dir)
            and not getattr(args, "resume", None)):
        # parity with train_mixer_h36m.py:50-55; a --resume run continues
        # in its own (existing) directory
        raise ValueError(
            "The directory already exists. Please, change the name of the model",
            log_dir,
        )
    os.makedirs(log_dir, exist_ok=True)
    return log_dir


def param_count(model: torch.nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())


def _steps_per_epoch(n: int, batch_size: int) -> int:
    return max(1, (n + batch_size - 1) // batch_size)


def _combine_test_sets(test_sets: dict, device: torch.device):
    """Concatenate per-action corpora into one (frames on ``device``,
    starts, group_ids, names)."""
    frames_list, starts_list, gid_list = [], [], []
    off = 0
    for gi, ds in enumerate(test_sets.values()):
        frames_list.append(ds.frames)
        starts_list.append(ds.window_starts + off)
        gid_list.append(np.full(len(ds), gi, np.int64))
        off += ds.frames.shape[0]
    frames = torch.as_tensor(np.concatenate(frames_list)).to(device)
    return (frames, np.concatenate(starts_list), np.concatenate(gid_list),
            list(test_sets.keys()))


def _train_and_evaluate(
    args, trainer: Trainer, logger: MetricLogger, log_dir: str,
    dataset, frames, vald, vframes,
    test_frames, test_starts, test_gids, action_names, start_epoch: int = 0,
):
    """Epoch driver: train -> validate -> grouped per-action test (MPJPE,
    AUC-PCK) -> history, logged scalars, checkpoint."""
    if int(getattr(args, "epochs_per_dispatch", 1) or 1) > 1:
        trainer.run_epochs_fused()  # raises: not ported
    history = {"train": [], "val": [], "test": [],
               "metrics": {"mpjpe": [], "auc_pck": []},
               "train_s": [], "epoch_s": []}
    for epoch in range(start_epoch, args.n_epochs):
        t0 = time.perf_counter()
        train_loss = trainer.train_epoch(dataset, frames, args.batch_size,
                                         seed=epoch)
        train_s = time.perf_counter() - t0
        logger.add_scalar("perf/train_seq_per_sec",
                          len(dataset) / max(train_s, 1e-9), epoch)
        val_loss = trainer.validate(vald, vframes, args.batch_size)
        m1s, m2s, ns = trainer.evaluate_grouped(
            test_frames, test_starts, test_gids, len(action_names),
            args.batch_size_test, "h36m_xyz")
        per_action = {a: (m1s[i] / ns[i], m2s[i] / ns[i])
                      for i, a in enumerate(action_names)}
        m1_avg = m1s.sum() / ns.sum()
        m2_avg = m2s.sum() / ns.sum()

        history["train"].append(train_loss)
        history["val"].append(val_loss)
        history["test"].append(m1_avg)
        history["per_action"] = per_action
        history["metrics"]["mpjpe"].append(m1_avg)
        history["metrics"]["auc_pck"].append(m2_avg)
        logger.add_scalar("loss/train", train_loss, epoch)
        logger.add_scalar("loss/val", val_loss, epoch)
        logger.add_scalar("loss/test", m1_avg, epoch)
        logger.add_scalar("metrics/mpjpe", m1_avg, epoch)
        logger.add_scalar("metrics/auc_pck", m2_avg, epoch)

        save_checkpoint(os.path.join(log_dir, STATE_FILE), trainer.model,
                        trainer.optimizer, epoch, meta=vars(args),
                        weights_path=os.path.join(log_dir, WEIGHTS_FILE))
        epoch_s = time.perf_counter() - t0
        history["train_s"].append(train_s)
        history["epoch_s"].append(epoch_s)
        logger.add_scalar("perf/epoch_s", epoch_s, epoch)
        print(f"epoch {epoch}: train {train_loss:.4f} val {val_loss:.4f} "
              f"test {m1_avg:.4f} ({epoch_s:.1f}s, train {train_s:.1f}s)")
    return history


def run_h36m(args, model: Optional[ConvMixer] = None,
             model_name: Optional[str] = None, init_state_dict=None):
    """H36M direct training (train_mixer_h36m.py:47-279 + per-epoch tests)
    on ``args.dev``. ``init_state_dict`` (reference layout) replaces the
    seeded init, e.g. to start from the JAX package's init. Returns
    (history, trainer)."""
    if args.loss_type != "mpjpe":
        raise NotImplementedError(
            "--loss_type angle lands with the H36M angle slice (ROADMAP "
            "queue A item 9)")
    device = resolve_device(getattr(args, "dev", "cuda"))
    dim_used = H36M_DIM_USED_XYZ
    seed = getattr(args, "seed", 0)

    dataset = H36MDataset(args.data_dir, args.input_n, args.output_n,
                          args.skip_rate, split=0)
    vald = H36MDataset(args.data_dir, args.input_n, args.output_n,
                       args.skip_rate, split=1)
    test_sets = {
        a: H36MDataset(args.data_dir, args.input_n, args.output_n,
                       args.skip_rate, actions=[a], split=2)
        for a in define_actions(args.actions_to_consider)
    }
    print(f">>> Training dataset length: {len(dataset)}")
    print(f">>> Validation dataset length: {len(vald)}")

    torch.manual_seed(seed)  # the dropout stream (CPU and CUDA generators)
    if model is None:
        model = build_conv_mixer(args, len(dim_used), len(dim_used),
                                 args.input_n, args.output_n,
                                 generator=torch.Generator().manual_seed(seed))
    if init_state_dict is not None:
        model.load_state_dict(init_state_dict, strict=True)
    model = model.to(device)
    model_name = model_name or f"h36_3d_{args.output_n}frames_ckpt"
    log_dir = _log_dir(args, model_name)
    logger = MetricLogger(log_dir)

    opt = make_optimizer(
        model.parameters(), lr=args.lr, weight_decay=1e-5,
        use_scheduler=args.use_scheduler, milestones=args.milestones,
        gamma=args.gamma,
        steps_per_epoch=_steps_per_epoch(len(dataset), args.batch_size),
        clip_grad=args.clip_grad)
    trainer = Trainer(
        model, opt, loss_type=args.loss_type, dim_used=dim_used,
        input_n=args.input_n, output_n=args.output_n, input_scale=1e-3,
        delta_x=getattr(args, "delta_x", False))
    print(f"total number of parameters of the network is: {param_count(model)}")

    start_epoch = 0
    resume_path = getattr(args, "resume", None)
    if resume_path:
        start_epoch = restore_checkpoint(resume_path, model, opt) + 1
        print(f"resumed from {resume_path} at epoch {start_epoch}")

    test_frames, test_starts, test_gids, action_names = _combine_test_sets(
        test_sets, device)
    try:
        history = _train_and_evaluate(
            args, trainer, logger, log_dir,
            dataset, dataset.frames_on(device), vald, vald.frames_on(device),
            test_frames, test_starts, test_gids, action_names, start_epoch)
    finally:
        logger.close()
    return history, trainer

"""The training-run drivers behind the H36M, AIS and AMASS CLIs.

Counterpart of ``motionmixerconv_tpu/cli/_runner.py`` for the direct and the
autoregressive H36M paths (both loss types), the direct and autoregressive
AIS paths and the AMASS MlpMixer path: build the model from the flags, load
the three splits, train epoch by epoch, validate, test (the grouped test
over the H36M or AIS test actions; AMASS's 22-joint scatter test), log, and
write a checkpoint every epoch. With ``--epochs_per_dispatch`` K > 1 each
chunk of K epochs runs as ``Trainer.run_epochs_fused`` (one host read a
chunk) and is checkpointed at its last epoch, as the JAX drivers'
``_run_fused_chunks`` do. ``model_from_checkpoint_meta`` rebuilds a trained
model from its checkpoint's stored flags.
"""

from __future__ import annotations

import os
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from ..data import AISDataset, AMASSDataset, H36MDataset
from ..data.constants import (AIS_DIM_USED, AIS_TEST_ACTIONS,
                              AIS_TRAIN_ACTIONS, AIS_VAL_ACTIONS,
                              AMASS_DIM_USED, H36M_DIM_USED_ANGLE,
                              H36M_DIM_USED_XYZ, define_actions)
from ..logging import MetricLogger
from ..models import ConvMixer, MlpMixer
from ..profiling import (epoch_numbers, profile_dir_from_env, profile_trace,
                         snapshot)
from ..serving import resolve_device
from ..train import (AutoregressiveTrainer, Trainer, make_optimizer,
                     restore_checkpoint, save_checkpoint)
from ..train.state import is_torch_file, save_jax_checkpoint

STATE_FILE = "train_state.pt"  # full training state, for --resume
WEIGHTS_FILE = "model.pt"      # reference-layout weights, for serving
METRIC_NAMES = ("mpjpe", "auc_pck")  # the xyz test kinds' two metrics


def _h36m_metric_names(loss_type: str) -> tuple:
    """The H36M test kinds' two metrics for ``loss_type``."""
    return METRIC_NAMES if loss_type == "mpjpe" else ("euler_angle",
                                                      "joint_angle")


def build_conv_mixer(args, dim_in: int, dim_out: int, in_ntp: int,
                     out_ntp: int,
                     generator: Optional[torch.Generator] = None
                     ) -> ConvMixer:
    """ConvMixer from CLI flags (train_mixer_h36m.py:575-595 defaults);
    ``generator`` seeds its init. ``--embed_dtype bf16`` stores the
    materialized harmonic embedding in bfloat16 (with ``--fused_encoder``
    the encoder raises ValueError, as the JAX package's does)."""
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
        encoder_embed_dtype=(
            torch.bfloat16
            if getattr(args, "embed_dtype", "f32") == "bf16" else None),
        generator=generator,
    )


def build_mlp_mixer(args, dim: int, in_ntp: int, out_ntp: int,
                    generator: Optional[torch.Generator] = None) -> MlpMixer:
    """MlpMixer from CLI flags (amass/train_mixer_amass.py:250-258
    defaults); ``generator`` seeds its init."""
    return MlpMixer(
        num_classes=dim,
        num_blocks=args.num_blocks,
        hidden_dim=args.hidden_dim,
        tokens_mlp_dim=args.tokens_mlp_dim,
        channels_mlp_dim=args.channels_mlp_dim,
        seq_len=in_ntp,
        pred_len=out_ntp,
        activation=args.activation,
        regularization=args.regularization,
        input_size=dim,
        r_se=args.r_se,
        use_max_pooling=False,
        use_se=True,
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


def _h36m_splits(args, input_n: int, output_n: int):
    """(train, validation, {action: test}) H36M corpora of (input_n +
    output_n)-frame windows: xyz for the mpjpe loss, expmap angles for the
    angle loss."""
    mode = "xyz" if args.loss_type == "mpjpe" else "angle"

    def split(s, actions=None):
        return H36MDataset(args.data_dir, input_n, output_n, args.skip_rate,
                           actions=actions, split=s, mode=mode)

    tests = {a: split(2, [a]) for a in define_actions(args.actions_to_consider)}
    return split(0), split(1), tests


def _model_and_optimizer(args, model: Optional[torch.nn.Module],
                         init_state_dict, device: torch.device, in_ntp: int,
                         out_ntp: int, n_train: int):
    """The model (from the flags, ``args.pose_dim`` wide, seeded by
    ``args.seed``, unless given: an MlpMixer with ``model_type mlp``, else a
    ConvMixer; ``init_state_dict`` loaded strictly over it) on ``device``,
    and its Adam with coupled L2 1e-5 and per-batch MultiStepLR."""
    seed = getattr(args, "seed", 0)
    torch.manual_seed(seed)  # the dropout stream (CPU and CUDA generators)
    if model is None:
        gen = torch.Generator().manual_seed(seed)
        dim = args.pose_dim
        if getattr(args, "model_type", "conv") == "mlp":
            model = build_mlp_mixer(args, dim, in_ntp, out_ntp, generator=gen)
        else:
            model = build_conv_mixer(args, dim, dim, in_ntp, out_ntp,
                                     generator=gen)
    if init_state_dict is not None:
        model.load_state_dict(init_state_dict, strict=True)
    model = model.to(device)
    opt = make_optimizer(
        model.parameters(), lr=args.lr, weight_decay=1e-5,
        use_scheduler=args.use_scheduler, milestones=args.milestones,
        gamma=args.gamma,
        steps_per_epoch=_steps_per_epoch(n_train, args.batch_size),
        clip_grad=args.clip_grad)
    return model, opt


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


def model_from_checkpoint_meta(meta: dict) -> torch.nn.Module:
    """The model a checkpoint's stored training args (``train_state.pt``
    meta) describe, for every trainer family, as JAX
    ``model_from_checkpoint_meta`` builds it: H36M direct (ConvMixer, or
    MlpMixer with ``model_type mlp``) and autoregressive (``*_model`` window
    args), 48 dims for an H36M angle run and ``pose_dim`` otherwise; AIS
    direct and autoregressive (ConvMixer: their CLIs store ``kernel1_x``
    and ``conv_nChan``, no ``model_type``); AMASS (MlpMixer)."""
    args = SimpleNamespace(**meta)
    in_n = meta.get("input_n_model", meta.get("input_n", 10))
    out_n = meta.get("output_n_model", meta.get("output_n", 25))
    if meta.get("loss_type") == "angle" and "actions_to_consider" in meta:
        dim = len(H36M_DIM_USED_ANGLE)  # the H36M angle trainers' 48 dims
    else:
        dim = meta.get("pose_dim", 66)
    model_type = meta.get("model_type")
    if model_type is None:
        conv_keys = ("conv1_kernel_shape", "conv_nChan", "kernel1_x")
        model_type = "conv" if any(k in meta for k in conv_keys) else "mlp"
    if model_type == "mlp":
        return build_mlp_mixer(args, dim, in_n, out_n)
    return build_conv_mixer(args, dim, dim, in_n, out_n)


def h36m_visualization_arrays(trainer: Trainer, test_set, n_windows: int = 2,
                              first: int = 10):
    """(all_seq, gt, full_in) host arrays of windows ``first`` to ``first +
    n_windows``, computed on the trainer's device: the full-skeleton
    prediction (decoded by ``delta_2_gt`` under ``delta_x``) and ground
    truth (T_out, 96) with the ignored joints re-inserted from their
    equals, and the (T_in, 96) input frames (train_mixer_h36m.py:399-411,
    the save_results path of test_mpjpe, which starts at window 10)."""
    frames = test_set.frames_on(trainer.device)
    starts = torch.as_tensor(
        test_set.window_starts[first: first + n_windows], dtype=torch.long,
        device=trainer.device)
    trainer.model.eval()
    with torch.no_grad():
        batch, pred, _ = trainer._forward_eval(frames, starts)
        full_gt = batch[:, trainer.input_n:]
        all_seq = trainer._in_full_frame(full_gt, pred)
        all_seq[:, :, trainer._ignore] = all_seq[:, :, trainer._equal]
        gt = full_gt.clone()
        gt[:, :, trainer._ignore] = full_gt[:, :, trainer._equal]
    return (all_seq.cpu().numpy(), gt.cpu().numpy(),
            batch[:, :trainer.input_n].cpu().numpy())


def export_h36m_visualizations(trainer: Trainer, test_set, log_dir: str,
                               action: str, n_windows: int = 2) -> list:
    """Render prediction-vs-gt GIFs of ``h36m_visualization_arrays``'
    windows into ``log_dir/visualization/<action>_<i>.gif``: the
    prediction in yellow over the blue ground truth, preceded by the blue
    input frames. Returns the paths."""
    from ..viz import visualize_batch

    all_seq, gt, full_in = h36m_visualization_arrays(trainer, test_set,
                                                     n_windows)
    out_dir = os.path.join(log_dir, "visualization")
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i in range(all_seq.shape[0]):
        path = os.path.join(out_dir, f"{action}_{i}.gif")
        visualize_batch(all_seq[i], path, batch_gt=gt[i],
                        batch_train=full_in[i])
        paths.append(path)
    return paths


def _log_epoch(history: dict, logger: MetricLogger, epoch: int,
               train_loss: float, val_loss: float, m1s, m2s, ns,
               action_names, metric_names: tuple, m1_scale: float) -> float:
    """Record one epoch's losses and per-group test sums in ``history``
    and the logger under ``metric_names``, the first metric times
    ``m1_scale``; returns the test metric's mean."""
    per_action = {a: (m1s[i] / ns[i] * m1_scale, m2s[i] / ns[i])
                  for i, a in enumerate(action_names)}
    m1_avg = m1s.sum() / ns.sum() * m1_scale
    m2_avg = m2s.sum() / ns.sum()
    history["train"].append(train_loss)
    history["val"].append(val_loss)
    history["test"].append(m1_avg)
    history["per_action"] = per_action
    for name, value in zip(metric_names, (m1_avg, m2_avg)):
        history["metrics"][name].append(value)
        logger.add_scalar(f"metrics/{name}", value, epoch)
    logger.add_scalar("loss/train", train_loss, epoch)
    logger.add_scalar("loss/val", val_loss, epoch)
    logger.add_scalar("loss/test", m1_avg, epoch)
    return m1_avg


def _train_and_evaluate(
    args, trainer: Trainer, logger: MetricLogger, log_dir: str,
    dataset, frames, vald, vframes,
    test_frames, test_starts, test_gids, action_names, start_epoch: int = 0,
    *, test_kind: str = "h36m_xyz",
    metric_names: tuple = METRIC_NAMES,
    m1_scale: float = 1.0,
    teacher_forcing_epochs: Optional[int] = None,
    test_batch_size: Optional[int] = None,
    state_copy_path: Optional[str] = None,
    batch_order_fn=None,
    epoch_callback=None,
):
    """Epoch driver: train -> validate -> grouped per-action test (the two
    metrics of ``test_kind``, named ``metric_names``, the first times
    ``m1_scale``; in batches of ``test_batch_size``, by default
    ``args.batch_size_test``) -> history, logged scalars, checkpoint (also
    to ``state_copy_path`` when given, in the format its name reads as:
    ``train_state.pt``'s payload for a ``.pt``/``.pth``, else the JAX
    package's ``.ckpt``, which the JAX runner writes there).
    ``teacher_forcing_epochs`` not None selects the autoregressive
    trainer: teacher forcing while ``epoch`` is below it, closed loop
    after. ``args.epochs_per_dispatch`` > 1 runs the
    epochs in chunks (``_train_and_evaluate_fused``). Each epoch logs,
    beside ``perf/epoch_s``, its change in the program's untraced spans
    (``profiling.epoch_numbers``): ``perf/graph_launch_us``,
    ``perf/step_host_us``, ``perf/epoch_host_share``, where they have a
    count to divide by (on the CPU, where every step is an eager call, the
    share is of the epoch's time outside the model's own compute); an
    epoch traced under ``MMC_PROFILE_DIR`` logs none of them.

    ``batch_order_fn(epoch)`` (epoch -> window permutation) replays an
    explicit batch stream (the lockstep parity runs, ``parity_runs.py``);
    direct trainer only. ``epoch_callback(epoch, history)`` runs after each
    epoch's metrics are in ``history`` and its checkpoint is written: the
    studies report and prune through it (``sweep/engine.py``; the runners
    close their logger before its ``TrialPruned`` propagates). Either one
    forces the per-epoch path, as in the JAX package: pruning needs a host
    decision every epoch, and an explicit order is handed over per epoch."""
    autoreg = teacher_forcing_epochs is not None
    history = {"train": [], "val": [], "test": [],
               "metrics": {name: [] for name in metric_names},
               "train_s": [], "epoch_s": []}
    batch_size_test = test_batch_size or args.batch_size_test

    def save(epoch: int) -> None:
        if not trainer.is_writer:  # a mesh's rank 0 writes, once
            return
        save_checkpoint(os.path.join(log_dir, STATE_FILE), trainer.model,
                        trainer.optimizer, epoch, meta=vars(args),
                        weights_path=os.path.join(log_dir, WEIGHTS_FILE))
        if state_copy_path and is_torch_file(state_copy_path):
            save_checkpoint(state_copy_path, trainer.model, trainer.optimizer,
                            epoch, meta=vars(args))
        elif state_copy_path:
            save_jax_checkpoint(state_copy_path, trainer.model,
                                trainer.optimizer, epoch, meta=vars(args),
                                seed=getattr(args, "seed", 0))

    epd = int(getattr(args, "epochs_per_dispatch", 1) or 1)
    if epd > 1 and batch_order_fn is not None:
        print(">>> --epochs_per_dispatch ignored: an explicit batch-order "
              "stream (parity run) requires the per-epoch path")
    if epd > 1 and epoch_callback is not None:
        print(">>> --epochs_per_dispatch ignored: per-epoch reporting/pruning "
              "requires the per-epoch path")
    if epd > 1 and batch_order_fn is None and epoch_callback is None:
        return _train_and_evaluate_fused(
            args, trainer, logger, history, save, epd,
            dataset=dataset, frames=frames, vald=vald, vframes=vframes,
            test_frames=test_frames, test_starts=test_starts,
            test_gids=test_gids, action_names=action_names,
            test_kind=test_kind, metric_names=metric_names,
            m1_scale=m1_scale, batch_size_test=batch_size_test,
            start_epoch=start_epoch,
            teacher_forcing_epochs=teacher_forcing_epochs)

    for epoch in range(start_epoch, args.n_epochs):
        spans0 = snapshot()["untraced"]
        trace_dir = profile_dir_from_env() if epoch == 0 else None
        t0 = time.perf_counter()
        with profile_trace(trace_dir):
            if autoreg:
                tf = epoch < teacher_forcing_epochs
                train_loss = trainer.train_epoch_ar(
                    dataset, frames, args.batch_size, seed=epoch,
                    teacher_forcing=tf)
            else:
                train_loss = trainer.train_epoch(
                    dataset, frames, args.batch_size, seed=epoch,
                    order=batch_order_fn(epoch) if batch_order_fn else None)
        train_s = time.perf_counter() - t0
        logger.add_scalar("perf/train_seq_per_sec",
                          len(dataset) / max(train_s, 1e-9), epoch)
        val_loss = trainer.validate(vald, vframes, args.batch_size)
        m1s, m2s, ns = trainer.evaluate_grouped(
            test_frames, test_starts, test_gids, len(action_names),
            batch_size_test, test_kind)
        m1_avg = _log_epoch(history, logger, epoch, train_loss, val_loss,
                            m1s, m2s, ns, action_names, metric_names,
                            m1_scale)
        save(epoch)
        epoch_s = time.perf_counter() - t0
        history["train_s"].append(train_s)
        history["epoch_s"].append(epoch_s)
        logger.add_scalar("perf/epoch_s", epoch_s, epoch)
        numbers = {} if trace_dir else epoch_numbers(snapshot()["untraced"],
                                                     spans0)
        for name, value in numbers.items():
            if value is not None:
                logger.add_scalar(f"perf/{name}", value, epoch)
        tf_note = f"tf={epoch < teacher_forcing_epochs} " if autoreg else ""
        print(f"epoch {epoch}: {tf_note}train {train_loss:.4f} val "
              f"{val_loss:.4f} test {m1_avg:.4f} ({epoch_s:.1f}s, train "
              f"{train_s:.1f}s)")
        if epoch_callback is not None:
            epoch_callback(epoch, history)
    return history


def _chunk_epochs(start: int, stop: int, epd: int, tf_boundary=None):
    """Split [start, stop) into chunks of <= epd epochs, never straddling the
    teacher-forcing boundary (a chunk's steps share one teacher-forcing
    flag). The JAX package's chunking, kept identical: per segment, if epd
    does not divide the length, the largest divisor in [ceil(epd/2), epd]
    (one chunk length), otherwise balanced chunk sizes differing by one."""
    cuts = [start, stop]
    if tf_boundary is not None and start < tf_boundary < stop:
        cuts.insert(1, tf_boundary)
    chunks = []
    for lo, hi in zip(cuts[:-1], cuts[1:]):
        length = hi - lo
        if length <= 0:
            continue
        if length % epd == 0:
            sizes = [epd] * (length // epd)
        else:
            div = next(
                (d for d in range(min(epd, length), (epd + 1) // 2 - 1, -1)
                 if length % d == 0),
                None,
            )
            if div is not None:
                sizes = [div] * (length // div)
            else:
                n_chunks = -(-length // epd)
                base, extra = divmod(length, n_chunks)
                sizes = [base + 1] * extra + [base] * (n_chunks - extra)
                print(
                    f">>> epochs_per_dispatch={epd} does not divide "
                    f"{length} epochs: using chunk sizes {base + 1}/{base} "
                    "(two compiled programs)"
                )
        e = lo
        for s in sizes:
            chunks.append(range(e, e + s))
            e += s
    return chunks


def _train_and_evaluate_fused(args, trainer: Trainer, logger: MetricLogger,
                              history: dict, save, epd: int, *, dataset,
                              frames, vald, vframes, test_frames,
                              test_starts, test_gids, action_names,
                              test_kind: str, batch_size_test: int,
                              start_epoch: int, teacher_forcing_epochs,
                              metric_names: tuple = METRIC_NAMES,
                              m1_scale: float = 1.0):
    """``_train_and_evaluate`` with ``--epochs_per_dispatch`` > 1: each chunk
    of ``_chunk_epochs`` runs as ``Trainer.run_epochs_fused``, and its one
    read gives the same per-epoch history, scalars and lines. The
    differences, as in the JAX package's ``_run_fused_chunks``: checkpoints
    (``save``) are written once per chunk, at its last epoch, and
    ``perf/train_seq_per_sec`` (like the history's ``train_s`` and
    ``epoch_s``) is the chunk's amortised rate, validation and test
    included. For the autoregressive trainer, a chunk whose train losses go
    non-finite logs its finite prefix of epochs, then raises
    FloatingPointError; the last checkpoint is the previous chunk's."""
    autoreg = teacher_forcing_epochs is not None
    for ci, chunk in enumerate(_chunk_epochs(start_epoch, args.n_epochs, epd,
                                             teacher_forcing_epochs)):
        epochs = list(chunk)
        k = len(epochs)
        tf = epochs[0] < teacher_forcing_epochs if autoreg else None
        t0 = time.perf_counter()
        with profile_trace(profile_dir_from_env() if ci == 0 else None):
            out = trainer.run_epochs_fused(
                dataset, frames, args.batch_size, epochs, vald, vframes,
                test_frames, test_starts, test_gids, len(action_names),
                test_kind, batch_size_test, teacher_forcing=tf)
        per_epoch_s = (time.perf_counter() - t0) / k
        seq_per_s = len(dataset) / max(per_epoch_s, 1e-9)
        finite = np.isfinite(out["train"])
        n_good = k if (not autoreg or finite.all()) else int(np.argmin(finite))
        for i, epoch in enumerate(epochs[:n_good]):
            train_loss, val_loss = float(out["train"][i]), float(out["val"][i])
            m1_avg = _log_epoch(history, logger, epoch, train_loss, val_loss,
                                out["m1"][i], out["m2"][i], out["n"][i],
                                action_names, metric_names, m1_scale)
            history["train_s"].append(per_epoch_s)
            history["epoch_s"].append(per_epoch_s)
            logger.add_scalar("perf/train_seq_per_sec", seq_per_s, epoch)
            logger.add_scalar("perf/epoch_s", per_epoch_s, epoch)
            tf_note = f"tf={epoch < teacher_forcing_epochs} " if autoreg else ""
            print(f"epoch {epoch}: {tf_note}train {train_loss:.4f} val "
                  f"{val_loss:.4f} test {m1_avg:.4f} ({per_epoch_s:.1f}s, "
                  f"fused x{k})")
        if n_good < k:
            raise FloatingPointError(
                f"Loss is nan at epoch {epochs[n_good]} — closed-loop "
                "rollout diverged (try --clip_grad or more teacher-forcing "
                f"epochs); logged {n_good} finite epochs of this chunk, "
                "last checkpoint is the previous chunk's")
        save(epochs[-1])
    return history


def run_h36m(args, model: Optional[ConvMixer] = None,
             model_name: Optional[str] = None, init_state_dict=None,
             batch_order_fn=None, epoch_callback=None):
    """H36M direct training (train_mixer_h36m.py:47-279 + per-epoch tests)
    on ``args.dev``: xyz (66 dims, input /1000, MPJPE and AUC-PCK) or, with
    ``--loss_type angle``, expmap angles (48 dims, input unscaled, L1
    loss, euler validation, euler and joint-angle test).
    ``init_state_dict`` (reference layout) replaces the seeded init, e.g.
    to start from the JAX package's init; ``--resume`` takes a
    ``train_state.pt`` or a JAX ``.ckpt``. ``batch_order_fn`` and
    ``epoch_callback`` as in ``_train_and_evaluate``. With ``--visualize``
    an xyz run then writes GIFs of the first test action
    (``export_h36m_visualizations``). Returns (history, trainer)."""
    device = resolve_device(getattr(args, "dev", "cuda"))
    xyz = args.loss_type == "mpjpe"
    dim_used = H36M_DIM_USED_XYZ if xyz else H36M_DIM_USED_ANGLE
    dataset, vald, test_sets = _h36m_splits(args, args.input_n, args.output_n)
    print(f">>> Training dataset length: {len(dataset)}")
    print(f">>> Validation dataset length: {len(vald)}")
    model, opt = _model_and_optimizer(
        args, model, init_state_dict, device, args.input_n, args.output_n,
        len(dataset))
    model_name = model_name or f"h36_3d_{args.output_n}frames_ckpt"
    log_dir = _log_dir(args, model_name)
    logger = MetricLogger(log_dir)
    trainer = Trainer(
        model, opt, loss_type=args.loss_type, dim_used=dim_used,
        input_n=args.input_n, output_n=args.output_n,
        input_scale=1e-3 if xyz else 1.0,
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
            test_frames, test_starts, test_gids, action_names, start_epoch,
            test_kind="h36m_xyz" if xyz else "h36m_angle",
            metric_names=_h36m_metric_names(args.loss_type),
            batch_order_fn=batch_order_fn, epoch_callback=epoch_callback)
    finally:
        logger.close()
    if getattr(args, "visualize", False) and xyz:
        first = action_names[0]
        paths = export_h36m_visualizations(trainer, test_sets[first], log_dir,
                                           first)
        print(f"wrote {len(paths)} visualization GIFs to "
              f"{log_dir}/visualization")
    return history, trainer


def run_h36m_autoregressive(args, model: Optional[ConvMixer] = None,
                            model_name: Optional[str] = None,
                            init_state_dict=None, epoch_callback=None):
    """H36M autoregressive training (train_autoreg_mixer_h36m.py:49-192) on
    ``args.dev``: the model sees (input_n_model -> output_n_model) windows
    and is rolled over (input_n_dataset + output_n_dataset) sequences in
    step_window strides; teacher forcing for the first
    n_epochs_teacher_forcing epochs. ``--loss_type angle`` trains on the 48
    expmap dims with the L1 rollout loss and tests the euler and
    joint-angle errors. ``init_state_dict`` (reference layout) replaces the
    seeded init. Returns (history, trainer)."""
    device = resolve_device(getattr(args, "dev", "cuda"))
    dim_used = (H36M_DIM_USED_XYZ if args.loss_type == "mpjpe"
                else H36M_DIM_USED_ANGLE)
    dataset, vald, test_sets = _h36m_splits(
        args, args.input_n_dataset, args.output_n_dataset)
    model, opt = _model_and_optimizer(
        args, model, init_state_dict, device, args.input_n_model,
        args.output_n_model, len(dataset))
    model_name = model_name or f"h36_ar_{args.output_n_dataset}frames_ckpt"
    log_dir = _log_dir(args, model_name)
    logger = MetricLogger(log_dir)
    trainer = AutoregressiveTrainer(
        model, opt, loss_type=args.loss_type, dim_used=dim_used,
        input_n=args.input_n_dataset, output_n=args.output_n_dataset,
        input_n_model=args.input_n_model, output_n_model=args.output_n_model,
        step_window=args.step_window)
    print(f"total number of parameters of the network is: {param_count(model)}")

    test_frames, test_starts, test_gids, action_names = _combine_test_sets(
        test_sets, device)
    try:
        history = _train_and_evaluate(
            args, trainer, logger, log_dir,
            dataset, dataset.frames_on(device), vald, vald.frames_on(device),
            test_frames, test_starts, test_gids, action_names,
            test_kind="ar", metric_names=_h36m_metric_names(args.loss_type),
            teacher_forcing_epochs=args.n_epochs_teacher_forcing,
            epoch_callback=epoch_callback)
    finally:
        logger.close()
    return history, trainer


def _ais_splits(args, input_n: int, output_n: int):
    """(train, validation, {action: test}) AIS corpora of (input_n +
    output_n)-frame windows over the trainer's fixed action splits
    (train_mixer_ais.py:84-111, 295-299)."""
    def corpus(actions):
        return AISDataset(
            args.data_dir, input_n, output_n, args.skip_rate, actions=actions,
            smoothing_alpha=getattr(args, "smoothing_alpha", 0.15),
            canonicalize=getattr(args, "canonicalize", True))

    return (corpus(AIS_TRAIN_ACTIONS), corpus(AIS_VAL_ACTIONS),
            {a: corpus([a]) for a in AIS_TEST_ACTIONS})


def run_ais(args, model: Optional[ConvMixer] = None,
            model_name: Optional[str] = None, init_state_dict=None,
            epoch_callback=None):
    """AIS direct training (train_mixer_ais.py:47-292) on ``args.dev``: the
    ConvMixer on the 33 used dims of 19 keypoints, data in meters (input
    and loss unscaled), the 'simple' grouped test over the two test actions
    with its MPJPE reported in mm (x1000, train_mixer_ais.py:386-388).
    ``init_state_dict`` (reference layout) replaces the seeded init;
    ``epoch_callback`` as in ``_train_and_evaluate``. Returns (history,
    trainer)."""
    device = resolve_device(getattr(args, "dev", "cuda"))
    dataset, vald, test_sets = _ais_splits(args, args.input_n, args.output_n)
    print(f">>> Training dataset length: {len(dataset)}")
    print(f">>> Validation dataset length: {len(vald)}")
    model, opt = _model_and_optimizer(
        args, model, init_state_dict, device, args.input_n, args.output_n,
        len(dataset))
    log_dir = _log_dir(args, model_name or f"ais_3d_{args.output_n}frames_ckpt")
    logger = MetricLogger(log_dir)
    trainer = Trainer(
        model, opt, loss_type=args.loss_type, dim_used=AIS_DIM_USED,
        input_n=args.input_n, output_n=args.output_n, input_scale=1.0,
        loss_scale=1.0)
    print(f"total number of parameters of the network is: {param_count(model)}")
    test_frames, test_starts, test_gids, action_names = _combine_test_sets(
        test_sets, device)
    try:
        history = _train_and_evaluate(
            args, trainer, logger, log_dir,
            dataset, dataset.frames_on(device), vald, vald.frames_on(device),
            test_frames, test_starts, test_gids, action_names,
            test_kind="simple", m1_scale=1000.0,
            epoch_callback=epoch_callback)
    finally:
        logger.close()
    return history, trainer


def run_ais_autoregressive(args, model: Optional[ConvMixer] = None,
                           model_name: Optional[str] = None,
                           init_state_dict=None, epoch_callback=None):
    """AIS autoregressive training (train_autoreg_mixer_ais.py:63-203) on
    ``args.dev``: the H36M autoregressive scheme on the 33 AIS dims, in
    meters; the test metric is the rollout loss x1000 (mm) and the AUC-PCK
    on raw meters (``auc_scale`` 1.0: the reference's /1000 is commented
    out, :266-268, 298-300). ``init_state_dict`` (reference layout)
    replaces the seeded init. Returns (history, trainer)."""
    device = resolve_device(getattr(args, "dev", "cuda"))
    dataset, vald, test_sets = _ais_splits(
        args, args.input_n_dataset, args.output_n_dataset)
    model, opt = _model_and_optimizer(
        args, model, init_state_dict, device, args.input_n_model,
        args.output_n_model, len(dataset))
    log_dir = _log_dir(
        args, model_name or f"ais_ar_{args.output_n_dataset}frames_ckpt")
    logger = MetricLogger(log_dir)
    trainer = AutoregressiveTrainer(
        model, opt, loss_type="mpjpe", dim_used=AIS_DIM_USED,
        input_n=args.input_n_dataset, output_n=args.output_n_dataset,
        input_n_model=args.input_n_model, output_n_model=args.output_n_model,
        step_window=args.step_window, auc_scale=1.0)
    print(f"total number of parameters of the network is: {param_count(model)}")
    test_frames, test_starts, test_gids, action_names = _combine_test_sets(
        test_sets, device)
    try:
        history = _train_and_evaluate(
            args, trainer, logger, log_dir,
            dataset, dataset.frames_on(device), vald, vald.frames_on(device),
            test_frames, test_starts, test_gids, action_names,
            test_kind="ar", m1_scale=1000.0,
            teacher_forcing_epochs=args.n_epochs_teacher_forcing,
            epoch_callback=epoch_callback)
    finally:
        logger.close()
    return history, trainer


def amass_test(trainer: Trainer, corpus, frames: torch.Tensor,
               batch_size: int) -> float:
    """AMASS test MPJPE in mm over the corpus (train_mixer_amass.py:
    153-199): the 18 predicted joints scattered into the 22-joint ground
    truth. The reference divides by a never-incremented ``n_batches`` and
    returns inf; here the divisor is the sample count, the value it
    prints."""
    m1, _, n = trainer.evaluate_grouped(
        frames, corpus.window_starts, np.zeros(len(corpus), np.int64), 1,
        batch_size, "amass22")
    return float(m1[0] / max(n[0], 1.0))


def run_amass(args, model: Optional[MlpMixer] = None,
              model_name: Optional[str] = None, init_state_dict=None):
    """AMASS training (amass/train_mixer_amass.py:34-148,153-199) on
    ``args.dev``: the MlpMixer on 54 dims (joints 4..21), input unscaled
    (meters), train and validation loss x1000, the 22-joint test (one
    group, in batches of ``args.batch_size`` as the reference) every epoch,
    and ``train_state.pt`` + ``model.pt`` every epoch or, with
    ``--epochs_per_dispatch``, every chunk (also to
    ``args.model_path`` when set: a JAX ``.ckpt`` unless the name ends in
    ``.pt``/``.pth``, as ``read_weights`` reads it). ``init_state_dict``
    (reference layout) replaces the seeded init. Returns (history, trainer)."""
    device = resolve_device(getattr(args, "dev", "cuda"))
    dataset, vald, test = (AMASSDataset(args.data_dir, args.input_n,
                                        args.output_n, args.skip_rate, split=s)
                           for s in range(3))
    print(f">>> Training dataset length: {len(dataset)}")
    print(f">>> Validation dataset length: {len(vald)}")
    if model is None:
        model = build_mlp_mixer(
            args, len(AMASS_DIM_USED), args.input_n, args.output_n,
            generator=torch.Generator().manual_seed(getattr(args, "seed", 0)))
    model, opt = _model_and_optimizer(
        args, model, init_state_dict, device, args.input_n, args.output_n,
        len(dataset))
    log_dir = _log_dir(args, model_name or f"amass_3d_{args.output_n}frames_ckpt")
    logger = MetricLogger(log_dir)
    trainer = Trainer(
        model, opt, loss_type="mpjpe", dim_used=AMASS_DIM_USED,
        input_n=args.input_n, output_n=args.output_n, input_scale=1.0,
        loss_scale=1000.0)
    print(f"total number of parameters of the network is: {param_count(model)}")
    try:
        history = _train_and_evaluate(
            args, trainer, logger, log_dir,
            dataset, dataset.frames_on(device), vald, vald.frames_on(device),
            test.frames_on(device), test.window_starts,
            np.zeros(len(test), np.int64), ["amass"], test_kind="amass22",
            test_batch_size=args.batch_size,
            state_copy_path=getattr(args, "model_path", None))
    finally:
        logger.close()
    return history, trainer

"""ConvMixer hyperparameter study, parity with optuna_search/conv_optuna_main.py.

Counterpart of ``motionmixerconv_tpu/sweep/conv_study.py`` on the port's
runners: the same flags, search space, objectives, user attributes and
``results.db``, plus ``--dev`` (default ``cuda``; ``--spread_devices``
places trial i on CUDA device i % N). The trials' ConvMixers (conv_nChan
8, dimPosEmb 192) serve through B3 (``ops/conv_mixer_mc.py``).

An ``Objective`` that a Study (native engine or real optuna) can optimize:
per trial it overwrites the model hyperparameters from the trial's
suggestions (dimPosEmb / channels_conv_blocks / kernel1_x_Time /
kernel1_y_Pose / num_blocks, conv_optuna_main.py:337-348), trains the
ConvMixer on H36M (mpjpe AND angle, two objectives, :328-331) or AIS
(:333-335), and records final + per-action metrics as user attributes
(:203-228).

Run: python -m motionmixerconv_tpu_torch.sweep.conv_study --data_dir ... --study_dir ...
"""

from __future__ import annotations

import argparse
import copy
import os

import torch

from ..models import ConvMixer
from .engine import (
    GridSampler,
    MedianPruner,
    RandomSampler,
    Study,
    TPESampler,
    TrialPruned,
)


def add_sweep_args(parser) -> None:
    """Execution flags shared by every study (--n_jobs /
    --spread_devices / --pruner / --dev); one definition so the studies
    stay in lockstep."""
    parser.add_argument("--n_jobs", default=1, type=int,
                        help="concurrent trials on a thread pool "
                             "(optuna's n_jobs); on one H100 two concurrent "
                             "trials took 1.003-1.037 of the same trials "
                             "run in turn (PERF.md section 5), so it gains "
                             "nothing on one card")
    parser.add_argument("--spread_devices", action="store_true",
                        help="pin trial i to CUDA device i %% N - one sweep "
                             "fans out over every visible card")
    parser.add_argument("--dev", default="cuda", type=str,
                        help="torch device of every trial without "
                             "--spread_devices; 'cuda' (default) raises "
                             "when there is no card")
    parser.add_argument("--pruner", default="none",
                        choices=["none", "median"],
                        help="median: prune trials whose per-epoch primary "
                             "metric is worse than the median of completed "
                             "trials at the same epoch")


def _epoch_reporter(trial, key: str):
    """Per-epoch callback for the runners: report history[key][-1] at each
    epoch and raise TrialPruned when the study's pruner says stop. With no
    pruner configured this still records the learning curve as the trial's
    intermediate values (sqlite + optuna-dashboard export)."""

    def callback(epoch, history):
        trial.report(history[key][-1], epoch)
        if trial.should_prune():
            raise TrialPruned()

    return callback


def _make_pruner(args):
    return MedianPruner() if getattr(args, "pruner", "none") == "median" else None


def parse_args(argv=None) -> argparse.Namespace:
    """Study defaults (conv_optuna_main.py:37-142, trimmed to used flags)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, default="./data")
    parser.add_argument("--study_dir", type=str, default="./studies/conv_study")
    parser.add_argument("--dataset_type", type=str, default="h36m",
                        choices=["h36m", "ais"])
    parser.add_argument("--input_n", type=int, default=10)
    parser.add_argument("--output_n", type=int, default=10)
    parser.add_argument("--skip_rate", type=int, default=1)
    parser.add_argument("--activation", default="gelu", type=str)
    parser.add_argument("--r_se", default=8, type=int)
    parser.add_argument("--n_epochs", default=15, type=int)
    parser.add_argument("--batch_size", default=50, type=int)
    parser.add_argument("--batch_size_test", default=256, type=int)
    parser.add_argument("--use_scheduler", default=True,
                        type=lambda s: s not in ("0", "False", "false"))
    parser.add_argument("--milestones", type=int, nargs="*", default=[15, 25, 35, 40])
    parser.add_argument("--gamma", type=float, default=0.1)
    parser.add_argument("--clip_grad", type=float, default=None)
    parser.add_argument("--actions_to_consider", default="all")
    parser.add_argument("--regularization", default=0.1, type=float)
    parser.add_argument("--lr", default=0.001, type=float)
    parser.add_argument("--mode_conv", default="once", choices=["once", "twice"])
    parser.add_argument("--encoder_n_harmonic_functions", default=0, type=int)
    parser.add_argument("--encoder_omega0", default=0.1, type=float)
    parser.add_argument("--smoothing_alpha", default=0.15, type=float)
    parser.add_argument("--n_trials", default=40, type=int)
    parser.add_argument("--timeout_hours", default=47.0, type=float)
    add_sweep_args(parser)
    parser.add_argument("--sampler", default="grid",
                        choices=["grid", "random", "tpe"])
    parser.add_argument("--seed", default=0, type=int)
    return parser.parse_args(argv)


def overwrite_optuna_params(args, trial):
    """Search space (conv_optuna_main.py:337-348)."""
    args.dimPosEmb = trial.suggest_int("dimPosEmb", 192, 192, step=32)
    args.channels_conv_blocks = trial.suggest_int("channels_conv_blocks", 8, 8, step=4)
    args.kernel1_x_Time = trial.suggest_int("kernel1_x_Time", 1, 9, step=4)
    args.kernel1_y_Pose = trial.suggest_int("kernel1_y_Pose", 1, 29, step=4)
    args.num_blocks = trial.suggest_int("num_blocks", 6, 6, step=2)
    return args, trial


def _build_model(args, pose_dim: int, in_ntp: int, out_ntp: int) -> ConvMixer:
    """The trial's ConvMixer, its init seeded by ``args.seed``."""
    return ConvMixer(
        dimPosIn=pose_dim,
        dimPosOut=pose_dim,
        in_nTP=in_ntp,
        out_nTP=out_ntp,
        num_blocks=args.num_blocks,
        dimPosEmb=args.dimPosEmb,
        conv_nChan=args.channels_conv_blocks,
        conv1_kernel_shape=(args.kernel1_x_Time, args.kernel1_y_Pose),
        encoder_n_harmonic_functions=args.encoder_n_harmonic_functions,
        encoder_omega0=args.encoder_omega0,
        mode_conv=args.mode_conv,
        activation=args.activation,
        regularization=args.regularization,
        use_se=True,
        r_se=args.r_se,
        use_max_pooling=False,
        generator=torch.Generator().manual_seed(getattr(args, "seed", 0)),
    )


def _on_trial_device(args, trial):
    """``args`` with ``dev`` set to the device the engine placed ``trial``
    on (unchanged without placement)."""
    if trial.device is not None:
        args.dev = str(trial.device)
    return args


class Objective:
    """Callable objective (conv_optuna_main.py:23,323-335)."""

    def __init__(self, study_dir: str, base_args=None):
        self.study_dir = study_dir
        self.base_args = base_args

    def _model_name(self, args, loss_type: str) -> str:
        return (
            f"{args.dataset_type}_{loss_type}_in={args.input_n}_out={args.output_n}"
            f"_blocks={args.num_blocks}_emb={args.dimPosEmb}"
            f"_k1x={args.kernel1_x_Time}_k1y={args.kernel1_y_Pose}"
            f"_chan={args.channels_conv_blocks}"
        )

    def _train_h36m(self, args, trial, loss_type: str, pose_dim: int) -> float:
        from ..cli._runner import run_h36m

        args = copy.deepcopy(args)
        args.loss_type = loss_type
        args.delta_x = False
        args.pose_dim = pose_dim
        args.save_path = os.path.join(self.study_dir, f"trial{trial.number}")
        model = _build_model(args, pose_dim, args.input_n, args.output_n)
        model_name = self._model_name(args, loss_type)
        history, _ = run_h36m(
            args, model=model, model_name=model_name,
            # report/prune on the FIRST objective only (optuna pruning is
            # single-objective); the angle phase trains to completion
            epoch_callback=(_epoch_reporter(trial, "test")
                            if loss_type == "mpjpe" else None),
        )

        trial.set_user_attr(f"train_loss_{loss_type}", history["train"][-1])
        trial.set_user_attr(f"val_loss_{loss_type}", history["val"][-1])
        trial.set_user_attr(f"test_loss_{loss_type}", history["test"][-1])
        for metric, values in history["metrics"].items():
            trial.set_user_attr(metric, values[-1])
        for action, (m1, m2) in history.get("per_action", {}).items():
            if loss_type == "mpjpe":
                trial.set_user_attr(f"{action}/mpjpe", m1)
                trial.set_user_attr(f"{action}/auc_pck", m2)
            else:
                trial.set_user_attr(f"{action}/euler_angle", m1)
                trial.set_user_attr(f"{action}/joint_angle", m2)
        return history["test"][-1]

    def _train_ais(self, args, trial, loss_type: str, pose_dim: int) -> float:
        from ..cli._runner import run_ais

        args = copy.deepcopy(args)
        args.loss_type = loss_type
        args.pose_dim = pose_dim
        args.save_path = os.path.join(self.study_dir, f"trial{trial.number}")
        args.conv_nChan = args.channels_conv_blocks
        args.conv1_kernel_shape = (args.kernel1_x_Time, args.kernel1_y_Pose)
        args.hidden_dim = args.dimPosEmb
        model = _build_model(args, pose_dim, args.input_n, args.output_n)
        model_name = self._model_name(args, loss_type)
        history, _ = run_ais(
            args, model=model, model_name=model_name,
            epoch_callback=_epoch_reporter(trial, "test"),
        )
        trial.set_user_attr(f"test_loss_{loss_type}", history["test"][-1])
        for action, (m1, m2) in history.get("per_action", {}).items():
            trial.set_user_attr(f"{action}/mpjpe", m1)
            trial.set_user_attr(f"{action}/auc_pck", m2)
        return history["test"][-1]

    def __call__(self, trial):
        args = copy.deepcopy(self.base_args) if self.base_args else parse_args([])
        args, trial = overwrite_optuna_params(args, trial)
        args = _on_trial_device(args, trial)
        if args.dataset_type == "h36m":
            mpjpe = self._train_h36m(args, trial, "mpjpe", 66)
            angle = self._train_h36m(args, trial, "angle", 48)
            return mpjpe, angle
        return self._train_ais(args, trial, "mpjpe", 33)


def _trial_devices(args):
    """The devices ``optimize`` places trials on: every CUDA device with
    --spread_devices, else ``args.dev`` alone (so that each trial runs on
    a stream of its own, engine.py optimize)."""
    if getattr(args, "spread_devices", False):
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(getattr(args, "dev", "cuda"))]


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.study_dir, exist_ok=True)
    directions = ["minimize", "minimize"] if args.dataset_type == "h36m" else ["minimize"]
    sampler = {
        "grid": GridSampler,
        "random": lambda: RandomSampler(seed=args.seed),
        "tpe": lambda: TPESampler(seed=args.seed),
    }[args.sampler]()
    study = Study(
        study_name=os.path.basename(args.study_dir),
        storage=f"sqlite:///{args.study_dir}/results.db",
        sampler=sampler,
        directions=directions,
        pruner=_make_pruner(args),
    )
    study.optimize(
        Objective(args.study_dir, base_args=args),
        n_trials=args.n_trials,
        timeout=args.timeout_hours * 3600,
        catch=(Exception,),
        n_jobs=args.n_jobs,
        devices=_trial_devices(args),
    )
    print("Number of finished trials:", len(study.trials))
    return study


if __name__ == "__main__":
    main()

"""Autoregressive ConvMixer study, parity with
optuna_search/conv_optuna_autoregressive.py.

Counterpart of ``motionmixerconv_tpu/sweep/autoreg_study.py`` on the port's
rollout runners, with ``conv_study``'s ``--dev`` and placement; its trials
(conv_nChan 4, dimPosEmb 192) serve through B3.

Multi-objective (mpjpe, angle) on H36M or single-objective on AIS, over the
rollout trainers, with the reference's search space
(conv_optuna_autoregressive.py:330-341) and extra rollout-window arguments
(input_n_model / output_n_model / step_window / n_epochs_teacher_forcing,
:68-73).

Run: python -m motionmixerconv_tpu_torch.sweep.autoreg_study --data_dir ... --study_dir ...
"""

from __future__ import annotations

import argparse
import copy
import os

from .conv_study import (
    _build_model,
    _epoch_reporter,
    _make_pruner,
    _on_trial_device,
    _trial_devices,
    add_sweep_args,
)
from .engine import GridSampler, Study


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, default="./data")
    parser.add_argument("--study_dir", type=str, default="./studies/autoreg_study")
    parser.add_argument("--dataset_type", type=str, default="h36m",
                        choices=["h36m", "ais"])
    parser.add_argument("--input_n_dataset", type=int, default=10)
    parser.add_argument("--output_n_dataset", type=int, default=25)
    parser.add_argument("--input_n_model", type=int, default=10)
    parser.add_argument("--output_n_model", type=int, default=5)
    parser.add_argument("--step_window", type=int, default=5)
    parser.add_argument("--n_epochs_teacher_forcing", type=int, default=5)
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
    parser.add_argument("--mode_conv", default="twice", choices=["once", "twice"])
    parser.add_argument("--encoder_n_harmonic_functions", default=0, type=int)
    parser.add_argument("--encoder_omega0", default=0.1, type=float)
    parser.add_argument("--smoothing_alpha", default=0.15, type=float)
    parser.add_argument("--n_trials", default=40, type=int)
    parser.add_argument("--timeout_hours", default=47.0, type=float)
    add_sweep_args(parser)
    parser.add_argument("--seed", default=0, type=int)
    return parser.parse_args(argv)


def overwrite_optuna_params(args, trial):
    """Search space (conv_optuna_autoregressive.py:330-341)."""
    args.dimPosEmb = trial.suggest_int("dimPosEmb", 192, 192, step=32)
    args.channels_conv_blocks = trial.suggest_int("channels_conv_blocks", 4, 4, step=4)
    args.kernel1_x_Time = trial.suggest_int("kernel1_x_Time", 1, 9, step=4)
    args.kernel1_y_Pose = trial.suggest_int("kernel1_y_Pose", 1, 9, step=4)
    args.num_blocks = trial.suggest_int("num_blocks", 6, 6, step=2)
    return args, trial


class Objective:
    def __init__(self, study_dir: str, base_args=None):
        self.study_dir = study_dir
        self.base_args = base_args

    def _train(self, args, trial, loss_type: str, pose_dim: int) -> float:
        args = copy.deepcopy(args)
        args.loss_type = loss_type
        args.pose_dim = pose_dim
        args.save_path = os.path.join(self.study_dir, f"trial{trial.number}")
        args.conv_nChan = args.channels_conv_blocks
        args.conv1_kernel_shape = (args.kernel1_x_Time, args.kernel1_y_Pose)
        args.hidden_dim = args.dimPosEmb
        model = _build_model(args, pose_dim, args.input_n_model, args.output_n_model)
        if args.dataset_type == "h36m":
            from ..cli._runner import run_h36m_autoregressive as run
        else:
            from ..cli._runner import run_ais_autoregressive as run
        history, _ = run(
            args, model=model,
            model_name=f"ar_{loss_type}_trial{trial.number}",
            epoch_callback=(_epoch_reporter(trial, "test")
                            if loss_type == "mpjpe" else None),
        )
        trial.set_user_attr(f"test_loss_{loss_type}", history["test"][-1])
        for metric, values in history.get("metrics", {}).items():
            trial.set_user_attr(metric, values[-1])
        for action, (m1, m2) in history.get("per_action", {}).items():
            trial.set_user_attr(f"{action}/m1", m1)
            trial.set_user_attr(f"{action}/m2", m2)
        return history["test"][-1]

    def __call__(self, trial):
        args = copy.deepcopy(self.base_args) if self.base_args else parse_args([])
        args, trial = overwrite_optuna_params(args, trial)
        args = _on_trial_device(args, trial)
        if args.dataset_type == "h36m":
            mpjpe = self._train(args, trial, "mpjpe", 66)
            angle = self._train(args, trial, "angle", 48)
            return mpjpe, angle
        return self._train(args, trial, "mpjpe", 33)


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.study_dir, exist_ok=True)
    directions = ["minimize", "minimize"] if args.dataset_type == "h36m" else ["minimize"]
    study = Study(
        study_name=os.path.basename(args.study_dir),
        storage=f"sqlite:///{args.study_dir}/results.db",
        sampler=GridSampler(),
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

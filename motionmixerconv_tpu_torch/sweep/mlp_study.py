"""MlpMixer hyperparameter study, parity with optuna_search/optuna_main.py.

Counterpart of ``motionmixerconv_tpu/sweep/mlp_study.py`` on the port's
``run_h36m`` and ``build_mlp_mixer`` (init seeded by ``--seed``), with
``conv_study``'s ``--dev`` and placement; its trials serve through B4.

The reference script searches hidden_dim / num_blocks / tokens_mlp_dim /
channels_mlp_dim / lr / regularization with the TPE default sampler and
optimizes validation loss (optuna_main.py:168-191,245) — but is broken as
shipped (it reads ``args.user`` before parsing, :42). This is the working
equivalent on the native engine's TPESampler with the same search space.

Run: python -m motionmixerconv_tpu_torch.sweep.mlp_study --data_dir ... --study_dir ...
"""

from __future__ import annotations

import argparse
import copy
import os

import torch

from .conv_study import (
    _epoch_reporter,
    _make_pruner,
    _on_trial_device,
    _trial_devices,
    add_sweep_args,
)
from .engine import TPESampler, Study


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, default="./data")
    parser.add_argument("--study_dir", type=str, default="./studies/mlp_study")
    parser.add_argument("--loss_type", type=str, default="mpjpe",
                        choices=["mpjpe", "angle"])
    parser.add_argument("--input_n", type=int, default=10)
    parser.add_argument("--output_n", type=int, default=25)
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
    parser.add_argument("--n_trials", default=40, type=int)
    parser.add_argument("--timeout_hours", default=47.0, type=float)
    add_sweep_args(parser)
    parser.add_argument("--seed", default=0, type=int)
    return parser.parse_args(argv)


class Objective:
    def __init__(self, study_dir: str, base_args=None):
        self.study_dir = study_dir
        self.base_args = base_args

    def __call__(self, trial):
        from ..cli._runner import build_mlp_mixer, run_h36m

        args = copy.deepcopy(self.base_args) if self.base_args else parse_args([])
        # search space (optuna_main.py:170-190)
        args.hidden_dim = trial.suggest_int("hidden_dim", 10, 100)
        args.num_blocks = trial.suggest_int("num_blocks", 1, 7)
        args.tokens_mlp_dim = trial.suggest_int("tokens_mlp_dim", 10, 100)
        args.channels_mlp_dim = trial.suggest_int("channels_mlp_dim", 10, 100)
        args.lr = trial.suggest_float("lr", 1e-4, 1e-2)
        args.regularization = trial.suggest_categorical(
            "regularization", [-1, 0, 0.1]
        )
        args.pose_dim = 66 if args.loss_type == "mpjpe" else 48
        args.delta_x = False
        args.save_path = os.path.join(self.study_dir, f"trial{trial.number}")
        args = _on_trial_device(args, trial)

        model = build_mlp_mixer(
            args, args.pose_dim, args.input_n, args.output_n,
            generator=torch.Generator().manual_seed(args.seed))
        history, _ = run_h36m(
            args, model=model, model_name=f"mlp_trial{trial.number}",
            # report the metric this study optimizes (val, optuna_main.py:245)
            epoch_callback=_epoch_reporter(trial, "val"),
        )
        trial.set_user_attr("train_loss", history["train"][-1])
        trial.set_user_attr("test_loss", history["test"][-1])
        # the reference optimizes the validation loss (optuna_main.py:245)
        return history["val"][-1]


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.study_dir, exist_ok=True)
    study = Study(
        study_name=os.path.basename(args.study_dir),
        storage=f"sqlite:///{args.study_dir}/results.db",
        sampler=TPESampler(seed=args.seed),
        directions=["minimize"],
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

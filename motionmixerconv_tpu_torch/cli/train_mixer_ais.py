"""AIS-lab training CLI (ConvMixer) on the card.

Counterpart of ``motionmixerconv_tpu/cli/train_mixer_ais.py``: the same
flags and defaults (the reference trainer h36m/train_mixer_ais.py is driven
only by its Optuna study; these are the study's defaults: 33 used dims of
19 keypoints, smoothing_alpha 0.15, the fixed action splits of
train_mixer_ais.py:84-111), a ConvMixer with a (kernel1_x, kernel1_y)
kernel. ``--dev`` defaults to ``cuda`` and raises without a card; ``--dev
cpu`` runs on the CPU. ``--epochs_per_dispatch K`` runs K epochs with one
host read and checkpoints once a chunk.

Usage: python -m motionmixerconv_tpu_torch.cli.train_mixer_ais \\
    --data_dir D --save_path S
"""

from __future__ import annotations

import argparse

from ._runner import run_ais
from .train_mixer_h36m import _bool


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, default="./data",
                        help="directory with the {action}.json files")
    parser.add_argument("--save_path", type=str, default="./runs")
    parser.add_argument("--input_n", type=int, default=10)
    parser.add_argument("--output_n", type=int, default=10)
    parser.add_argument("--skip_rate", type=int, default=2)
    parser.add_argument("--smoothing_alpha", type=float, default=0.15)
    parser.add_argument("--canonicalize", default=True, type=_bool,
                        help="remove global rotation/translation (local-"
                             "movement variant); disable for global movement")
    parser.add_argument("--activation", default="mish", type=str)
    parser.add_argument("--r_se", default=8, type=int)
    parser.add_argument("--n_epochs", default=20, type=int)
    parser.add_argument("--batch_size", default=50, type=int)
    parser.add_argument("--dev", default="cuda", type=str,
                        help="torch device to train on; 'cuda' (default) "
                             "raises when there is no card")
    parser.add_argument("--use_scheduler", default=True, type=_bool)
    parser.add_argument("--milestones", type=int, nargs="*",
                        default=[15, 25, 35, 40])
    parser.add_argument("--gamma", type=float, default=0.1)
    parser.add_argument("--clip_grad", type=float, default=None)
    parser.add_argument("--batch_size_test", type=int, default=256)
    parser.add_argument("--loss_type", type=str, default="mpjpe",
                        choices=["mpjpe"])
    parser.add_argument("--hidden_dim", default=50, type=int)
    parser.add_argument("--num_blocks", default=4, type=int)
    parser.add_argument("--regularization", default=0.1, type=float)
    parser.add_argument("--pose_dim", default=33, type=int)
    parser.add_argument("--lr", default=0.001, type=float)
    parser.add_argument("--conv_nChan", default=1, type=int)
    parser.add_argument("--kernel1_x", default=1, type=int)
    parser.add_argument("--kernel1_y", default=3, type=int)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--epochs_per_dispatch", type=int, default=1,
                        help="whole epochs (train + val + test) per host "
                             "read; checkpoints once per chunk")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    args.conv1_kernel_shape = (args.kernel1_x, args.kernel1_y)
    print(args)
    history, _ = run_ais(args, model_name=f"ais_3d_{args.output_n}frames_ckpt")
    print(">>> Training finished")
    return history


if __name__ == "__main__":
    main()

"""AIS-lab autoregressive training CLI on the card.

Counterpart of ``motionmixerconv_tpu/cli/train_autoreg_mixer_ais.py``: the
same flags and defaults (h36m/train_autoreg_mixer_ais.py is driven only by
its Optuna study; these are the study's defaults): a 10 -> 5 frame
ConvMixer with (5,5) kernels and no harmonic encoding, rolled out over 25
output frames in strides of 5, teacher forcing for the first
n_epochs_teacher_forcing epochs. ``--dev`` defaults to ``cuda`` and raises
without a card; ``--dev cpu`` runs on the CPU. ``--epochs_per_dispatch K``
runs K epochs with one host read (a chunk never straddles the
teacher-forcing boundary) and checkpoints once a chunk.

Usage: python -m motionmixerconv_tpu_torch.cli.train_autoreg_mixer_ais \\
    --data_dir D --save_path S
"""

from __future__ import annotations

import argparse

from ._runner import run_ais_autoregressive
from .train_mixer_h36m import _bool


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, default="./data",
                        help="directory with the {action}.json files")
    parser.add_argument("--save_path", type=str, default="./runs")
    parser.add_argument("--input_n_dataset", type=int, default=10)
    parser.add_argument("--output_n_dataset", type=int, default=25)
    parser.add_argument("--input_n_model", type=int, default=10)
    parser.add_argument("--output_n_model", type=int, default=5)
    parser.add_argument("--step_window", type=int, default=5)
    parser.add_argument("--n_epochs_teacher_forcing", type=int, default=10)
    parser.add_argument("--skip_rate", type=int, default=2)
    parser.add_argument("--smoothing_alpha", type=float, default=0.15)
    parser.add_argument("--canonicalize", default=True, type=_bool)
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
    parser.add_argument("--kernel1_x", default=5, type=int)
    parser.add_argument("--kernel1_y", default=5, type=int)
    parser.add_argument("--encoder_n_harmonic_functions", type=int, default=0,
                        help="harmonic encoding is off for autoregressive "
                             "training (reference parity, "
                             "train_autoreg_mixer_h36m.py:535)")
    parser.add_argument("--encoder_omega0", type=float, default=0.0)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--epochs_per_dispatch", type=int, default=1,
                        help="whole epochs (train + val + test) per host "
                             "read; a chunk never straddles the "
                             "teacher-forcing boundary")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    args.conv1_kernel_shape = (args.kernel1_x, args.kernel1_y)
    print(args)
    history, _ = run_ais_autoregressive(
        args, model_name=f"ais_ar_{args.output_n_dataset}frames_ckpt")
    print(">>> Training finished")
    return history


if __name__ == "__main__":
    main()

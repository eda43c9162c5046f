"""H3.6M autoregressive training CLI on the card.

Counterpart of ``motionmixerconv_tpu/cli/train_autoreg_mixer_h36m.py``: the
same flag surface (h36m/train_autoreg_mixer_h36m.py:415-560). The model sees
(input_n_model -> output_n_model) windows and is rolled out over
(input_n_dataset + output_n_dataset) sequences in step_window strides, with
teacher forcing for the first n_epochs_teacher_forcing epochs. The
two-stage parser's mpjpe defaults build the autoregressive ConvMixer
(conv_nChan 8, dimPosEmb 192, (5,5) kernels, BatchNorm, 4 blocks, mish, no
harmonics), which ``Predictor`` serves through kernel B3. ``--dev``
defaults to ``cuda`` and raises without a card; ``--dev cpu`` runs on the
CPU.

``--epochs_per_dispatch K`` runs K epochs with one host read (a chunk
never straddles the teacher-forcing boundary) and checkpoints once a
chunk. ``--loss_type angle`` raises NotImplementedError naming its ROADMAP
item (A9).

Usage: python -m motionmixerconv_tpu_torch.cli.train_autoreg_mixer_h36m \\
    --loss_type mpjpe --data_dir D --save_path S
"""

from __future__ import annotations

import argparse

from ._runner import run_h36m_autoregressive
from .train_mixer_h36m import _bool


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--data_dir", type=str, default="./data")
    parser.add_argument("--save_path", type=str, default="./runs")
    parser.add_argument("--model_path", type=str, default="./checkpoints")
    parser.add_argument("--input_n_dataset", type=int, default=10)
    parser.add_argument("--output_n_dataset", type=int, default=25)
    parser.add_argument("--input_n_model", type=int, default=10)
    parser.add_argument("--output_n_model", type=int, default=5)
    parser.add_argument("--step_window", type=int, default=5)
    # the reference CLI never defines this flag (train_autoreg_mixer_h36m.py
    # crashes at :122 when run directly); the Optuna driver's default is 5
    # (conv_optuna_autoregressive.py:73), adopted as the JAX package does
    parser.add_argument("--n_epochs_teacher_forcing", type=int, default=5)
    parser.add_argument("--skip_rate", type=int, default=1, choices=[1, 5])
    parser.add_argument("--num_worker", default=4, type=int,
                        help="unused (the corpus is resident on the device)")
    parser.add_argument("--activation", default="mish", type=str)
    parser.add_argument("--r_se", default=8, type=int)
    parser.add_argument("--n_epochs", default=50, type=int)
    parser.add_argument("--batch_size", default=50, type=int)
    parser.add_argument("--dev", default="cuda", type=str,
                        help="torch device to train on; 'cuda' (default) "
                             "raises when there is no card")
    parser.add_argument("--use_scheduler", default=True, type=_bool)
    parser.add_argument("--milestones", type=int, nargs="*",
                        default=[15, 25, 35, 40])
    parser.add_argument("--gamma", type=float, default=0.1)
    parser.add_argument("--clip_grad", type=float, default=None)
    parser.add_argument("--actions_to_consider", default="all")
    parser.add_argument("--batch_size_test", type=int, default=50)
    parser.add_argument("--loss_type", type=str, default="mpjpe",
                        choices=["mpjpe", "angle"])
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
    return parser


def parse_args(argv=None) -> argparse.Namespace:
    parser = build_parser()
    args, _ = parser.parse_known_args(argv)
    stage2 = argparse.ArgumentParser(parents=[parser])
    # stage-2 defaults mirror train_autoreg_mixer_h36m.py:486-510; the
    # reference feeds channels_mlp_dim into ConvMixer's conv_nChan (:541)
    if args.loss_type == "mpjpe":
        stage2.add_argument("--hidden_dim", default=192, type=int)
        stage2.add_argument("--num_blocks", default=4, type=int)
        stage2.add_argument("--regularization", default=-1.0, type=float)
        stage2.add_argument("--pose_dim", default=66, type=int)
        stage2.add_argument("--lr", default=0.001, type=float)
        stage2.add_argument("--conv_nChan", default=8, type=int)
    else:
        stage2.add_argument("--hidden_dim", default=60, type=int)
        stage2.add_argument("--num_blocks", default=3, type=int)
        stage2.add_argument("--regularization", default=0.0, type=float)
        stage2.add_argument("--pose_dim", default=48, type=int)
        stage2.add_argument("--lr", default=1e-2, type=float)
        stage2.add_argument("--conv_nChan", default=60, type=int)
    stage2.add_argument("--kernel1_x", default=5, type=int,
                        help="conv1 kernel over time (reference autoreg uses (5,5))")
    stage2.add_argument("--kernel1_y", default=5, type=int)
    return stage2.parse_args(argv)


def _refuse_unported(args) -> None:
    todo = []
    if args.loss_type == "angle":
        todo.append("--loss_type angle (ROADMAP queue A item 9)")
    if todo:
        raise NotImplementedError("not ported yet: " + ", ".join(todo))


def main(argv=None):
    args = parse_args(argv)
    _refuse_unported(args)
    args.conv1_kernel_shape = (args.kernel1_x, args.kernel1_y)
    print(args)
    history, _ = run_h36m_autoregressive(
        args, model_name=f"h36_ar_{args.output_n_dataset}frames_ckpt")
    print(">>> Training finished",
          {k: v for k, v in history.items() if k != "per_action"})
    return history


if __name__ == "__main__":
    main()

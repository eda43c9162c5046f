"""H3.6M direct-prediction training CLI on the card.

Counterpart of ``motionmixerconv_tpu/cli/train_mixer_h36m.py``: the same
flag surface (h36m/train_mixer_h36m.py:472-607), including the two-stage
parser whose per-loss defaults differ (mpjpe: hidden 50 / blocks 4 / lr
1e-3; angle: hidden 60 / blocks 3 / lr 1e-2). ``--dev`` defaults to
``cuda`` and raises without a card; ``--dev cpu`` runs on the CPU.

The default ``--loss_type angle`` trains on the 48 expmap dims with the
L1 loss and reports the euler and joint-angle errors; ``mpjpe`` trains on
the 66 xyz dims. ``--model_type mlp`` trains an MlpMixer of ``--pose_dim``
dims (``build_mlp_mixer``, as the JAX CLI does). ``--epochs_per_dispatch
K`` runs K epochs with one host read and checkpoints once a chunk; on the
card every step and evaluation batch replays a captured CUDA graph
whatever K. ``--visualize`` raises NotImplementedError naming its ROADMAP
item (A16).

Usage: python -m motionmixerconv_tpu_torch.cli.train_mixer_h36m \\
    --fused_encoder --data_dir D --save_path S
"""

from __future__ import annotations

import argparse

from ._runner import run_h36m


def _bool(s: str) -> bool:
    return s not in ("0", "False", "false")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--data_dir", type=str, default="./data",
                        help="path to the unzipped dataset directories")
    parser.add_argument("--save_path", type=str, default="./runs",
                        help="root path for the logging")
    parser.add_argument("--model_path", type=str, default="./checkpoints",
                        help="directory with the models checkpoints")
    parser.add_argument("--input_n", type=int, default=10)
    parser.add_argument("--output_n", type=int, default=25)
    parser.add_argument("--skip_rate", type=int, default=1, choices=[1, 5])
    parser.add_argument("--num_worker", default=4, type=int,
                        help="unused (the corpus is resident on the device)")
    parser.add_argument("--activation", default="mish", type=str)
    parser.add_argument("--r_se", default=8, type=int)
    parser.add_argument("--n_epochs", default=2, type=int)
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
    parser.add_argument("--batch_size_test", type=int, default=256)
    parser.add_argument("--visualize_from", type=str, default="test",
                        choices=["train", "val", "test"])
    parser.add_argument("--loss_type", type=str, default="angle",
                        choices=["mpjpe", "angle"])
    parser.add_argument("--model_type", type=str, default="conv",
                        choices=["conv", "mlp"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--epochs_per_dispatch", type=int, default=1,
                        help="whole epochs (train + val + test) per host "
                             "read; checkpoints once per chunk")
    parser.add_argument("--visualize", action="store_true",
                        help="export prediction-vs-gt GIFs (not ported)")
    parser.add_argument("--resume", type=str, default=None,
                        help="train_state.pt to resume training from")
    parser.add_argument("--fused_encoder", action="store_true",
                        help="run the harmonic encoder through the fused "
                             "CUDA kernels (forward and backward; same "
                             "parameters and numerics as the plain encoder)")
    parser.add_argument("--harmonic_impl", default="direct",
                        choices=("direct", "doubling"),
                        help="harmonic-encoder trig: 'direct' = reference "
                             "numerics, 'doubling' = normalized "
                             "angle-doubling recurrence")
    parser.add_argument("--embed_dtype", default="f32",
                        choices=("f32", "bf16"),
                        help="storage dtype of the materialized harmonic "
                             "embedding (not with --fused_encoder)")
    return parser


def parse_args(argv=None) -> argparse.Namespace:
    parser = build_parser()
    args, _ = parser.parse_known_args(argv)
    stage2 = argparse.ArgumentParser(parents=[parser])
    if args.loss_type == "mpjpe":
        stage2.add_argument("--hidden_dim", default=50, type=int)
        stage2.add_argument("--num_blocks", default=4, type=int)
        stage2.add_argument("--tokens_mlp_dim", default=20, type=int)
        stage2.add_argument("--channels_mlp_dim", default=50, type=int)
        stage2.add_argument("--regularization", default=0.1, type=float)
        stage2.add_argument("--pose_dim", default=66, type=int)
        stage2.add_argument("--delta_x", type=bool, default=False)
        stage2.add_argument("--lr", default=0.001, type=float)
    else:
        stage2.add_argument("--hidden_dim", default=60, type=int)
        stage2.add_argument("--num_blocks", default=3, type=int)
        stage2.add_argument("--tokens_mlp_dim", default=40, type=int)
        stage2.add_argument("--channels_mlp_dim", default=60, type=int)
        stage2.add_argument("--regularization", default=0.0, type=float)
        stage2.add_argument("--pose_dim", default=48, type=int)
        stage2.add_argument("--delta_x", type=bool, default=False)
        stage2.add_argument("--lr", default=1e-2, type=float)
    args = stage2.parse_args(argv)
    if args.loss_type == "angle" and args.delta_x:
        raise ValueError("Delta_x and loss type angle cant be used together.")
    return args


def _refuse_unported(args) -> None:
    if args.visualize:
        raise NotImplementedError(
            "not ported yet: --visualize (ROADMAP queue A item 16)")


def main(argv=None):
    args = parse_args(argv)
    _refuse_unported(args)
    print(args)
    history, _ = run_h36m(args, model_name=f"h36_3d_{args.output_n}frames_ckpt")
    print(">>> Training finished",
          {k: v for k, v in history.items() if k != "per_action"})
    return history


if __name__ == "__main__":
    main()

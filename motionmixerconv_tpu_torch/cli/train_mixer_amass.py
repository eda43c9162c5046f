"""AMASS training CLI (MlpMixer) on the card.

Counterpart of ``motionmixerconv_tpu/cli/train_mixer_amass.py``: the same
flag surface (amass/train_mixer_amass.py:203-267; hidden 128, 5 blocks,
tokens 20, channels 128, pose_dim 54, gelu, batch 200) and the two-stage
parser. ``--dev`` defaults to ``cuda`` and raises without a card; ``--dev
cpu`` runs on the CPU. ``--epochs_per_dispatch`` > 1 raises naming ROADMAP
item A19. ``--model_path`` names an extra copy of ``train_state.pt``; unset
by default (the JAX CLI's default points at its own ``.ckpt``).

Usage: python -m motionmixerconv_tpu_torch.cli.train_mixer_amass \\
    --data_dir D --save_path S
"""

from __future__ import annotations

import argparse

from ._runner import run_amass


def _bool(s: str) -> bool:
    return s not in ("0", "False", "false")


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--data_dir", type=str, default="../data_amass/")
    parser.add_argument("--save_path", "--root", dest="save_path", type=str,
                        default="./runs")
    parser.add_argument("--input_n", type=int, default=10)
    parser.add_argument("--output_n", type=int, default=25)
    parser.add_argument("--skip_rate", type=int, default=1, choices=[1, 5])
    parser.add_argument("--num_worker", default=4, type=int,
                        help="unused (the corpus is resident on the device)")
    parser.add_argument("--activation", default="gelu", type=str)
    parser.add_argument("--r_se", default=8, type=int)
    parser.add_argument("--n_epochs", default=50, type=int)
    parser.add_argument("--batch_size", default=200, type=int)
    parser.add_argument("--dev", default="cuda", type=str,
                        help="torch device to train on; 'cuda' (default) "
                             "raises when there is no card")
    parser.add_argument("--use_scheduler", default=True, type=_bool)
    parser.add_argument("--milestones", type=int, nargs="*",
                        default=[15, 25, 35, 40])
    parser.add_argument("--gamma", type=float, default=0.1)
    parser.add_argument("--clip_grad", type=float, default=None)
    parser.add_argument("--model_path", type=str, default=None,
                        help="also write train_state.pt here every epoch")
    parser.add_argument("--batch_size_test", type=int, default=256)
    parser.add_argument("--loss_type", type=str, default="mpjpe",
                        choices=["mpjpe"])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--epochs_per_dispatch", type=int, default=1,
                        help="whole epochs per dispatch; only 1 is ported")

    args, _ = parser.parse_known_args(argv)
    stage2 = argparse.ArgumentParser(parents=[parser])
    stage2.add_argument("--hidden_dim", default=128, type=int)
    stage2.add_argument("--num_blocks", default=5, type=int)
    stage2.add_argument("--tokens_mlp_dim", default=20, type=int)
    stage2.add_argument("--channels_mlp_dim", default=128, type=int)
    stage2.add_argument("--regularization", default=0.1, type=float)
    stage2.add_argument("--pose_dim", default=54, type=int)
    stage2.add_argument("--lr", default=0.001, type=float)
    return stage2.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    print(args)
    history, _ = run_amass(args,
                           model_name=f"amass_3d_{args.output_n}frames_ckpt")
    print(">>> Training finished")
    return history


if __name__ == "__main__":
    main()

"""AMASS evaluation CLI: the 22-joint test MPJPE of a trained MlpMixer.

Counterpart of ``motionmixerconv_tpu/cli/test_mixer_amass.py`` (reference
amass/test_mixer_amass.py:20-60): the 18 predicted joints are scattered
into the 22-joint ground truth, MPJPE x1000, divided by the sample count
(the reference divides by a never-incremented counter and returns inf).
``--model_path`` is a torch ``.pt``: a reference state_dict, the trainer's
``model.pt``, or its ``train_state.pt``; or, under any other name, the JAX
package's ``.ckpt`` (``train/state.py``). Stored training args (a
``train_state.pt``'s, a ``.ckpt``'s meta) fill the architecture flags
(explicit flags win). ``--dev`` defaults to ``cuda``.

Usage: python -m motionmixerconv_tpu_torch.cli.test_mixer_amass \\
    --data_dir D --model_path S/amass_3d_25frames_ckpt/train_state.pt
"""

from __future__ import annotations

import argparse

from ..data import AMASSDataset
from ..data.constants import AMASS_DIM_USED
from ..models.torch_io import read_weights
from ..serving import resolve_device
from ..train import Trainer, make_optimizer
from ..train.state import load_weights
from ._runner import amass_test, build_mlp_mixer

# filled from a checkpoint's stored training args; explicit flags win
ARCH_META_KEYS = (
    "input_n", "output_n", "skip_rate", "activation", "r_se", "hidden_dim",
    "num_blocks", "tokens_mlp_dim", "channels_mlp_dim", "regularization",
    "pose_dim",
)


def parse_args(argv=None, meta=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, default="../data_amass/")
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--input_n", type=int, default=10)
    parser.add_argument("--output_n", type=int, default=25)
    parser.add_argument("--skip_rate", type=int, default=1)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--activation", default="gelu", type=str)
    parser.add_argument("--r_se", default=8, type=int)
    parser.add_argument("--hidden_dim", default=128, type=int)
    parser.add_argument("--num_blocks", default=5, type=int)
    parser.add_argument("--tokens_mlp_dim", default=20, type=int)
    parser.add_argument("--channels_mlp_dim", default=128, type=int)
    parser.add_argument("--regularization", default=0.1, type=float)
    parser.add_argument("--pose_dim", default=54, type=int)
    parser.add_argument("--dev", default="cuda", type=str,
                        help="torch device; 'cuda' (default) raises when "
                             "there is no card")
    if meta:
        parser.set_defaults(**{k: meta[k] for k in ARCH_META_KEYS
                               if k in meta})
    return parser.parse_args(argv)


def main(argv=None) -> float:
    args = parse_args(argv)
    state_dict, meta = read_weights(args.model_path)
    if meta:
        args = parse_args(argv, meta=meta)
    device = resolve_device(args.dev)
    model = build_mlp_mixer(args, args.pose_dim, args.input_n, args.output_n)
    load_weights(model, state_dict)
    model = model.to(device)
    test = AMASSDataset(args.data_dir, args.input_n, args.output_n,
                        args.skip_rate, split=2)
    # the scatter evaluation through a Trainer that never steps
    trainer = Trainer(
        model, make_optimizer(model.parameters(), lr=1e-3),
        loss_type="mpjpe", dim_used=AMASS_DIM_USED, input_n=args.input_n,
        output_n=args.output_n, input_scale=1.0, loss_scale=1000.0)
    loss = amass_test(trainer, test, test.frames_on(device), args.batch_size)
    print(f"overall average loss in mm is: {loss:.4f}")
    return loss


if __name__ == "__main__":
    main()

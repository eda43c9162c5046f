"""Pretrained H3.6M evaluation CLI on the card.

Counterpart of ``motionmixerconv_tpu/cli/test_mixer_h36m.py`` (reference
h36m/test_mixer_h36m.py:17-124): per-action evaluation at the eval-horizon
frames [1, 3, 7, 9, 13, 17, 21, 24], with the final headline metric at the
last horizon the checkpoint predicts (frame 24 ~ 1000 ms at output_n 25),
velocity (delta_x) decoding by default, and the full-skeleton 32-joint
MPJPE with equal-joint re-insertion. The per-action horizon average is the
JAX CLI's: its sums run on over the actions.

``--model_path`` is a torch ``.pt``/``.pth`` (a reference-layout MlpMixer
state_dict, or a trainer's ``train_state.pt``) or, under any other name,
the JAX package's ``.ckpt`` (``train/state.py``). Stored training args (a
``train_state.pt``'s, a ``.ckpt``'s meta) fill the architecture flags
(explicit flags win; ``model_type conv`` rebuilds a ConvMixer). ``--dev``
defaults to ``cuda`` and raises without a card.

Usage: python -m motionmixerconv_tpu_torch.cli.test_mixer_h36m \\
    --data_dir D --model_path M.pt
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..data import H36MDataset
from ..data.constants import H36M_DIM_USED_XYZ, define_actions
from ..data.windows import batch_starts
from ..models.torch_io import read_weights
from ..serving import resolve_device
from ..train.loop import Trainer
from ..train.state import load_weights
from ._runner import build_conv_mixer, build_mlp_mixer

EVAL_FRAMES = [1, 3, 7, 9, 13, 17, 21, 24]  # test_mixer_h36m.py:20

# architecture/eval-semantics keys filled from a checkpoint's stored
# training args; explicit flags still win, and keys with no flag here (the
# conv-model ones) ride along for build_conv_mixer's getattr defaults
ARCH_META_KEYS = (
    "input_n", "output_n", "skip_rate", "pose_dim", "activation",
    "hidden_dim", "num_blocks", "tokens_mlp_dim", "channels_mlp_dim",
    "regularization", "r_se", "delta_x", "model_type", "loss_type",
    "conv_nChan", "conv1_kernel_shape", "mode_conv",
    "encoder_n_harmonic_functions", "encoder_omega0", "fused_encoder",
    "harmonic_impl", "embed_dtype",
)


def test_pretrained(model: torch.nn.Module, args, device: torch.device):
    """(overall 32-joint MPJPE, final horizon MPJPE) of ``model`` over the
    test split of ``args.actions_to_consider``; prints as the JAX CLI."""
    # the reference hardcodes output_n=25 (all 8 horizons); for shorter
    # checkpoints keep the horizons that exist and headline the last one
    frames_avail = [f for f in EVAL_FRAMES if f < args.output_n]
    if not frames_avail:
        raise ValueError(
            f"output_n={args.output_n} leaves no eval horizon (the shortest "
            f"is frame {EVAL_FRAMES[0] + 1}); this checkpoint predicts too "
            "few frames for the per-horizon evaluation")
    idx_eval = len(frames_avail) - 1
    eval_frames = torch.as_tensor(frames_avail, device=device)
    model.eval()
    # the trainer's evaluation forward: window gather, dim_used slice,
    # delta encoding and decoding, and the 32-joint MPJPE
    trainer = Trainer(model, None, loss_type="mpjpe",
                      dim_used=H36M_DIM_USED_XYZ, input_n=args.input_n,
                      output_n=args.output_n, input_scale=1.0 / 1000.0,
                      delta_x=args.delta_x)

    @torch.no_grad()
    def step(frames, starts, w):
        """(horizon sums (n_eval,), 32-joint sum, weight sum) of a batch."""
        pred, seq_gt, per32 = trainer.h36m_xyz_outputs(frames, starts)
        b = pred.shape[0]
        # per-horizon-frame MPJPE (test_mixer_h36m.py:83-88)
        per_frame = torch.linalg.norm(
            (seq_gt - pred).reshape(b, args.output_n, -1, 3), dim=-1).mean(-1)
        horizon = per_frame.index_select(1, eval_frames)
        return torch.cat([(horizon * w[:, None]).sum(0),
                          (per32 * w).sum()[None], w.sum()[None]])

    accum32, n_total = 0.0, 0.0
    t3d_all = []
    t3d = np.zeros(len(frames_avail))
    n_horizon = 0.0
    for action in define_actions(args.actions_to_consider):
        ds = H36MDataset(args.data_dir, args.input_n, args.output_n,
                         args.skip_rate, actions=[action], split=2)
        frames = ds.frames_on(device)
        rows = [step(frames,
                     torch.as_tensor(starts, dtype=torch.long).to(device),
                     torch.as_tensor(w).to(device))
                for starts, w in batch_starts(ds, args.batch_size_test,
                                              shuffle=False)]
        a32, an = 0.0, 0.0
        for row in torch.stack(rows).cpu().numpy():  # one read an action
            t3d += row[:-2]
            n_horizon += float(row[-1])
            a32 += float(row[-2])
            an += float(row[-1])
        accum32 += a32
        n_total += an
        print(f"loss at test subject for action : {action} is: {a32 / an:.3f}")
        t3d_all.append(t3d[idx_eval] / n_horizon)

    print(f"overall average loss in mm is: {accum32 / n_total:.4f}")
    final = float(np.mean(t3d_all))
    print(f"overall final loss in mm is: {final:.4f}")
    return accum32 / n_total, final


def parse_args(argv=None, meta=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, default="./data")
    parser.add_argument("--model_path", type=str, required=True,
                        help="torch .pt/.pth (a reference state_dict, "
                             "model.pt or train_state.pt) or a JAX .ckpt")
    parser.add_argument("--input_n", type=int, default=10)
    parser.add_argument("--output_n", type=int, default=25)
    parser.add_argument("--skip_rate", type=int, default=1)
    parser.add_argument("--actions_to_consider", default="all")
    parser.add_argument("--batch_size_test", type=int, default=256)
    parser.add_argument("--pose_dim", type=int, default=66)
    parser.add_argument("--delta_x", default=True,
                        type=lambda s: s not in ("0", "False", "false"))
    parser.add_argument("--activation", default="gelu", type=str)
    parser.add_argument("--hidden_dim", default=50, type=int)
    parser.add_argument("--num_blocks", default=4, type=int)
    parser.add_argument("--tokens_mlp_dim", default=20, type=int)
    parser.add_argument("--channels_mlp_dim", default=50, type=int)
    parser.add_argument("--regularization", default=0.1, type=float)
    parser.add_argument("--r_se", default=8, type=int)
    parser.add_argument("--dev", default="cuda", type=str,
                        help="torch device; 'cuda' (default) raises when "
                             "there is no card")
    if meta:
        parser.set_defaults(**{k: meta[k] for k in ARCH_META_KEYS
                               if k in meta})
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    state_dict, meta = read_weights(args.model_path)
    if meta:
        # the checkpoint's training args as defaults: a bare --model_path
        # evaluates the trained configuration
        args = parse_args(argv, meta=meta)
    if getattr(args, "loss_type", "mpjpe") != "mpjpe":
        raise ValueError(
            "this CLI evaluates xyz-space checkpoints; the given checkpoint "
            f"was trained with --loss_type {args.loss_type}")
    device = resolve_device(args.dev)
    if getattr(args, "model_type", "mlp") == "conv":
        model = build_conv_mixer(args, args.pose_dim, args.pose_dim,
                                 args.input_n, args.output_n)
    else:
        model = build_mlp_mixer(args, args.pose_dim, args.input_n,
                                args.output_n)
    load_weights(model, state_dict)
    return test_pretrained(model.to(device), args, device)


if __name__ == "__main__":
    main()

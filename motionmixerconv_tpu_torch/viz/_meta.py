"""Shared checkpoint-meta resolution for the viz consumers.

Counterpart of ``motionmixerconv_tpu/viz/_meta.py``. galleries.py and
live.py both load a trained H36M checkpoint after the fact; the
architecture must come from the checkpoint's stored training args (a
``train_state.pt``'s or a JAX ``.ckpt``'s meta), not CLI defaults —
otherwise a non-default trained config fails to load or, worse, silently
mis-renders. One guard set, one model dispatch for both.
"""

from __future__ import annotations

import torch


def h36m_xyz_model(args) -> torch.nn.Module:
    """The H36M xyz model ``args`` describe: an MlpMixer with
    ``model_type mlp``, else a ConvMixer, on the 66 used dims."""
    from ..cli._runner import build_conv_mixer, build_mlp_mixer
    from ..data.constants import H36M_DIM_USED_XYZ

    dim = len(H36M_DIM_USED_XYZ)
    if getattr(args, "model_type", "conv") == "mlp":
        return build_mlp_mixer(args, dim, args.input_n, args.output_n)
    return build_conv_mixer(args, dim, dim, args.input_n, args.output_n)


def load_h36m_xyz_model(checkpoint: str, args) -> torch.nn.Module:
    """``h36m_xyz_model(args)`` holding the weights of ``checkpoint`` (a
    ``.pt``/``.pth`` or a JAX ``.ckpt``), on the CPU."""
    from ..models.torch_io import read_weights
    from ..train.state import load_weights

    model = h36m_xyz_model(args)
    load_weights(model, read_weights(checkpoint)[0])
    return model


def resolve_h36m_eval_args(checkpoint: str, data_dir: str, save_path: str,
                           overrides: dict | None = None):
    """(args, model) for evaluating/rendering an H36M xyz checkpoint; the
    model holds the checkpoint's weights, on the CPU.

    args start from the training CLI's defaults, are overlaid with the
    checkpoint's stored training args (meta), then with ``overrides``
    (explicit caller flags). Raises with a clear message for angle-loss
    checkpoints (48-dim models cannot be rendered as xyz skeletons).
    """
    from ..cli.train_mixer_h36m import parse_args
    from ..models.torch_io import read_weights
    from ..train.state import load_weights

    args = parse_args([
        "--data_dir", data_dir, "--save_path", save_path,
        "--loss_type", "mpjpe",
    ])
    state_dict, meta = read_weights(checkpoint)
    if meta:
        args.__dict__.update({k: v for k, v in meta.items()
                              if k not in ("data_dir", "save_path")})
    if overrides:
        args.__dict__.update(overrides)
    if args.loss_type != "mpjpe":
        raise ValueError(
            "xyz-skeleton rendering needs an mpjpe checkpoint; this one was "
            f"trained with --loss_type {args.loss_type} (48-dim angle model)")
    model = h36m_xyz_model(args)
    load_weights(model, state_dict)
    return args, model

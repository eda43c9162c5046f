"""Weights into the port: JAX-package variables and reference ``.pt`` files.

``state_dict_from_jax`` is this package's own copy of the JAX package's
``export_conv_mixer`` and ``export_mlp_mixer``
(``motionmixerconv_tpu/models/torch_io.py``): it turns a flax ConvMixer's or
MlpMixer's variables, given as numpy arrays, into the reference torch
state_dict that the port's modules load strictly.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

Flat = Dict[str, np.ndarray]


def _linear_out(out: Flat, prefix: str, p: dict) -> None:
    out[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _se_out(out: Flat, prefix: str, p: dict, seq_name: str) -> None:
    """SE weights under the reference Sequential's name: ``excitation``
    (MlpMixer) or ``excitationBlock`` (ConvMixer)."""
    out[f"{prefix}.{seq_name}.0.weight"] = np.ascontiguousarray(
        np.asarray(p["fc1"]["kernel"]).T)
    out[f"{prefix}.{seq_name}.2.weight"] = np.ascontiguousarray(
        np.asarray(p["fc2"]["kernel"]).T)


def _layernorm_out(out: Flat, prefix: str, p: dict) -> None:
    out[f"{prefix}.weight"] = np.asarray(p["scale"])
    out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _reg_out(out: Flat, prefix: str, reg_params, reg_stats) -> None:
    """BatchNorm regularization, with the ``num_batches_tracked`` counter
    strict loading requires (0: unused unless BN momentum is None)."""
    if reg_params is None:
        return
    bn_p = reg_params["BatchNorm_0"]
    bn_s = reg_stats["BatchNorm_0"]
    out[f"{prefix}.weight"] = np.asarray(bn_p["scale"])
    out[f"{prefix}.bias"] = np.asarray(bn_p["bias"])
    out[f"{prefix}.running_mean"] = np.asarray(bn_s["mean"])
    out[f"{prefix}.running_var"] = np.asarray(bn_s["var"])
    out[f"{prefix}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def _conv2d_out(out: Flat, prefix: str, p: dict) -> None:
    w = np.asarray(p["kernel"])  # (kh, kw, in, out)
    out[f"{prefix}.weight"] = np.ascontiguousarray(w.transpose(3, 2, 0, 1))
    out[f"{prefix}.bias"] = np.asarray(p["bias"])


def export_conv_mixer_arrays(variables: Dict[str, Any], num_blocks: int,
                             n_harmonic_functions: int = 0,
                             omega0: float = 0.1) -> Flat:
    """flax ConvMixer variables (numpy leaves) -> reference state_dict arrays.

    ``encoder.frequencies`` is emitted only when harmonics are on, and
    ``se2`` repeats ``se`` in 'twice' mode (the reference's alias)."""
    p = variables["params"]
    bs = variables.get("batch_stats", {})
    out: Flat = {}
    if n_harmonic_functions > 0:
        out["encoder.frequencies"] = (
            omega0 * (2.0 ** np.arange(n_harmonic_functions))
        ).astype(np.float32)
    _linear_out(out, "encoder.embed_mlp", p["encoder"]["embed_mlp"])
    _linear_out(out, "encoder.channelUpscaling", p["encoder"]["channelUpscaling"])
    for i in range(num_blocks):
        bp = p[f"Mixer_Block_{i}"]
        bbs = bs.get(f"Mixer_Block_{i}", {})
        tp = f"Mixer_Block.{i}"
        _layernorm_out(out, f"{tp}.LN1", bp["LN1"])
        _conv2d_out(out, f"{tp}.conv1.conv", bp["conv1"]["conv"])
        _reg_out(out, f"{tp}.conv1.reg", bp["conv1"].get("reg"),
                 bbs.get("conv1", {}).get("reg"))
        if "conv2" in bp:
            _layernorm_out(out, f"{tp}.LN2", bp["LN2"])
            _conv2d_out(out, f"{tp}.conv2.conv", bp["conv2"]["conv"])
            _reg_out(out, f"{tp}.conv2.reg", bp["conv2"].get("reg"),
                     bbs.get("conv2", {}).get("reg"))
        if "se" in bp:
            _se_out(out, f"{tp}.se", bp["se"], "excitationBlock")
            if "conv2" in bp:
                _se_out(out, f"{tp}.se2", bp["se"], "excitationBlock")
    _layernorm_out(out, "LN", p["LN"])
    w = np.asarray(p["conv_out"]["kernel"])  # (T, P)
    out["conv_out.weight"] = np.ascontiguousarray(w.T)[:, :, None, None]
    out["conv_out.bias"] = np.asarray(p["conv_out"]["bias"])
    w = np.asarray(p["project_channels"]["kernel"])  # (C, 1)
    out["project_channels.weight"] = np.ascontiguousarray(w.T)[:, :, None, None]
    out["project_channels.bias"] = np.asarray(p["project_channels"]["bias"])
    _linear_out(out, "fc_out", p["fc_out"])
    return out


def export_mlp_mixer_arrays(variables: Dict[str, Any],
                            num_blocks: int) -> Flat:
    """flax MlpMixer variables (numpy leaves) -> reference state_dict
    arrays: ``conv`` as the (H, 1, 1, D) Conv2d, ``conv_out`` as the
    (P, T, 1) Conv1d, BatchNorm running stats from ``batch_stats``."""
    p = variables["params"]
    bs = variables.get("batch_stats", {})
    out: Flat = {}
    w = np.asarray(p["conv"]["kernel"])  # (D, H)
    out["conv.weight"] = np.ascontiguousarray(w.T)[:, None, None, :]
    out["conv.bias"] = np.asarray(p["conv"]["bias"])
    for i in range(num_blocks):
        bp = p[f"Mixer_Block_{i}"]
        bbs = bs.get(f"Mixer_Block_{i}", {})
        tp = f"Mixer_Block.{i}"
        for ln in ("LN1", "LN2"):
            if ln in bp:
                _layernorm_out(out, f"{tp}.{ln}", bp[ln])
        for mb in ("mlp_block_token_mixing", "mlp_block_channel_mixing"):
            if mb in bp:
                _linear_out(out, f"{tp}.{mb}.fc1", bp[mb]["fc1"])
                _linear_out(out, f"{tp}.{mb}.fc2", bp[mb]["fc2"])
                for reg in ("reg1", "reg2"):
                    _reg_out(out, f"{tp}.{mb}.{reg}", bp[mb].get(reg),
                             bbs.get(mb, {}).get(reg))
        if "se" in bp:
            _se_out(out, f"{tp}.se", bp["se"], "excitation")
    _layernorm_out(out, "LN", p["LN"])
    _linear_out(out, "fc_out", p["fc_out"])
    w = np.asarray(p["conv_out"]["kernel"])  # (T, P)
    out["conv_out.weight"] = np.ascontiguousarray(w.T)[:, :, None]
    out["conv_out.bias"] = np.asarray(p["conv_out"]["bias"])
    return out


def state_dict_from_jax(variables: Dict[str, Any], num_blocks: int,
                        n_harmonic_functions: int = 0,
                        omega0: float = 0.1) -> Dict[str, torch.Tensor]:
    """flax ConvMixer or MlpMixer variables -> the port's state_dict (CPU).
    The family is read off the tree: only the ConvMixer has an
    ``encoder``; the harmonic arguments apply to it alone."""
    if "encoder" in variables["params"]:
        arrays = export_conv_mixer_arrays(variables, num_blocks,
                                          n_harmonic_functions, omega0)
    else:
        arrays = export_mlp_mixer_arrays(variables, num_blocks)
    return {k: torch.from_numpy(np.array(v)) for k, v in arrays.items()}


def read_weights(path: str) -> Tuple[Dict[str, torch.Tensor], Optional[dict]]:
    """(state_dict, training-args meta) of a torch ``.pt``/``.pth`` file,
    read onto the CPU with ``weights_only``: a reference state_dict has no
    meta (None); the trainers' ``train_state.pt`` holds both."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and {"model", "meta"} <= set(payload):
        return payload["model"], payload["meta"]
    return payload, None

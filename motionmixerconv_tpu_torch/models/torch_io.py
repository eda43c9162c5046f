"""Weights between the port and the JAX package, and reference ``.pt`` files.

``state_dict_from_jax`` is this package's own copy of the JAX package's
``export_conv_mixer`` and ``export_mlp_mixer``
(``motionmixerconv_tpu/models/torch_io.py``): it turns a flax ConvMixer's or
MlpMixer's variables, given as numpy arrays, into the reference torch
state_dict that the port's modules load strictly. ``jax_from_state_dict``
is the inverse, the port's copy of ``convert_conv_mixer`` and
``convert_mlp_mixer``: a reference state_dict into the flax variable tree
(``se2``, which repeats ``se``, and ``encoder.frequencies``, a constant
present only with harmonics, are not read).
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
    """(state_dict, training-args meta) of a checkpoint, read onto the CPU.
    A torch ``.pt``/``.pth`` file with ``weights_only``: a reference
    state_dict has no meta (None); the trainers' ``train_state.pt`` holds
    both. Any other name is the JAX package's ``.ckpt``
    (``train/state.py``), whose meta is None where it stored none and whose
    state_dict lacks ``encoder.frequencies`` (load it with
    ``train.state.load_weights``)."""
    from ..train.state import is_torch_file, read_jax_checkpoint

    if not is_torch_file(path):
        ck = read_jax_checkpoint(path)
        return ck.state_dict(), ck.meta
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and {"model", "meta"} <= set(payload):
        return payload["model"], payload["meta"]
    return payload, None


# ------------------------------------------------ reference layout -> flax


def _linear(sd: Flat, prefix: str) -> dict:
    return {"kernel": np.ascontiguousarray(sd[f"{prefix}.weight"].T),
            "bias": sd[f"{prefix}.bias"]}


def _conv2d(sd: Flat, prefix: str) -> dict:
    w = sd[f"{prefix}.weight"]  # (out, in, kh, kw)
    return {"kernel": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
            "bias": sd[f"{prefix}.bias"]}


def _layernorm(sd: Flat, prefix: str) -> dict:
    return {"scale": sd[f"{prefix}.weight"], "bias": sd[f"{prefix}.bias"]}


def _se(sd: Flat, prefix: str, seq_name: str) -> dict:
    return {"fc1": {"kernel": np.ascontiguousarray(
                sd[f"{prefix}.{seq_name}.0.weight"].T)},
            "fc2": {"kernel": np.ascontiguousarray(
                sd[f"{prefix}.{seq_name}.2.weight"].T)}}


def _reg(sd: Flat, prefix: str, params: dict, batch_stats: dict,
         key: str) -> None:
    """BatchNorm regularization, where there is one (regularization -1)."""
    if f"{prefix}.weight" in sd:
        params[key] = {"BatchNorm_0": {"scale": sd[f"{prefix}.weight"],
                                       "bias": sd[f"{prefix}.bias"]}}
        batch_stats[key] = {"BatchNorm_0": {
            "mean": sd[f"{prefix}.running_mean"],
            "var": sd[f"{prefix}.running_var"]}}


def _mlp_block(sd: Flat, prefix: str, batch_stats_out: dict,
               key: str) -> dict:
    p: dict = {"fc1": _linear(sd, f"{prefix}.fc1"),
               "fc2": _linear(sd, f"{prefix}.fc2")}
    bs: dict = {}
    _reg(sd, f"{prefix}.reg1", p, bs, "reg1")
    _reg(sd, f"{prefix}.reg2", p, bs, "reg2")
    if bs:
        batch_stats_out[key] = bs
    return p


def convert_mlp_mixer_arrays(sd: Flat, num_blocks: int) -> Dict[str, Any]:
    """Reference MlpMixer state_dict arrays -> flax variables ({'params'}
    and, with BatchNorm, {'batch_stats'})."""
    params: dict = {}
    batch_stats: dict = {}
    w = sd["conv.weight"]  # (H, 1, 1, D)
    params["conv"] = {"kernel": np.ascontiguousarray(w[:, 0, 0, :].T),
                      "bias": sd["conv.bias"]}
    for i in range(num_blocks):
        tp = f"Mixer_Block.{i}"
        bp: dict = {}
        bbs: dict = {}
        for ln in ("LN1", "LN2"):
            if f"{tp}.{ln}.weight" in sd:
                bp[ln] = _layernorm(sd, f"{tp}.{ln}")
        for mb in ("mlp_block_token_mixing", "mlp_block_channel_mixing"):
            if f"{tp}.{mb}.fc1.weight" in sd:
                bp[mb] = _mlp_block(sd, f"{tp}.{mb}", bbs, mb)
        if f"{tp}.se.excitation.0.weight" in sd:
            bp["se"] = _se(sd, f"{tp}.se", "excitation")
        params[f"Mixer_Block_{i}"] = bp
        if bbs:
            batch_stats[f"Mixer_Block_{i}"] = bbs
    params["LN"] = _layernorm(sd, "LN")
    params["fc_out"] = _linear(sd, "fc_out")
    w = sd["conv_out.weight"]  # (P, T, 1)
    params["conv_out"] = {"kernel": np.ascontiguousarray(w[:, :, 0].T),
                          "bias": sd["conv_out.bias"]}
    out: Dict[str, Any] = {"params": params}
    if batch_stats:
        out["batch_stats"] = batch_stats
    return out


def convert_conv_mixer_arrays(sd: Flat, num_blocks: int) -> Dict[str, Any]:
    """Reference ConvMixer state_dict arrays -> flax variables."""
    params: dict = {}
    batch_stats: dict = {}
    params["encoder"] = {
        "embed_mlp": _linear(sd, "encoder.embed_mlp"),
        "channelUpscaling": _linear(sd, "encoder.channelUpscaling")}
    for i in range(num_blocks):
        tp = f"Mixer_Block.{i}"
        bp: dict = {"LN1": _layernorm(sd, f"{tp}.LN1")}
        bbs: dict = {}
        for conv in ("conv1", "conv2"):
            if f"{tp}.{conv}.conv.weight" not in sd:
                continue
            if conv == "conv2":
                bp["LN2"] = _layernorm(sd, f"{tp}.LN2")
            cb: dict = {"conv": _conv2d(sd, f"{tp}.{conv}.conv")}
            cbs: dict = {}
            _reg(sd, f"{tp}.{conv}.reg", cb, cbs, "reg")
            bp[conv] = cb
            if cbs:
                bbs[conv] = cbs
        if f"{tp}.se.excitationBlock.0.weight" in sd:
            bp["se"] = _se(sd, f"{tp}.se", "excitationBlock")
        params[f"Mixer_Block_{i}"] = bp
        if bbs:
            batch_stats[f"Mixer_Block_{i}"] = bbs
    params["LN"] = _layernorm(sd, "LN")
    w = sd["conv_out.weight"]  # (P, T, 1, 1)
    params["conv_out"] = {"kernel": np.ascontiguousarray(w[:, :, 0, 0].T),
                          "bias": sd["conv_out.bias"]}
    w = sd["project_channels.weight"]  # (1, C, 1, 1)
    params["project_channels"] = {
        "kernel": np.ascontiguousarray(w[:, :, 0, 0].T),
        "bias": sd["project_channels.bias"]}
    params["fc_out"] = _linear(sd, "fc_out")
    out: Dict[str, Any] = {"params": params}
    if batch_stats:
        out["batch_stats"] = batch_stats
    return out


def jax_from_state_dict(state_dict, num_blocks: int) -> Dict[str, Any]:
    """The port's (reference-layout) state_dict -> flax ConvMixer or
    MlpMixer variables as float32 numpy arrays; the family is read off the
    keys (only the ConvMixer has an encoder)."""
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
              else np.asarray(v)) for k, v in state_dict.items()}
    if "encoder.embed_mlp.weight" in sd:
        return convert_conv_mixer_arrays(sd, num_blocks)
    return convert_mlp_mixer_arrays(sd, num_blocks)

"""Training checkpoints in the port's own format, with exact resume.

Counterpart of ``motionmixerconv_tpu/train/state.py``. A checkpoint holds
the model's state_dict, the optimizer's (Adam moments and the schedule's
position), the epoch, the RNG states that drive dropout, and the training
args as meta, so ``--resume`` continues the same trajectory. Beside it the
weights alone go to a reference-layout ``.pt`` state_dict, which
``Predictor.from_checkpoint`` serves. Reading and writing the JAX
package's ``.ckpt`` is checkpoint interchange, a later port.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
from torch import nn

from .optim import Optimizer


def _save(obj, path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu_state_dict(model: nn.Module) -> dict:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def save_checkpoint(path: str, model: nn.Module, optimizer: Optimizer,
                    epoch: int, meta: Optional[dict] = None,
                    weights_path: Optional[str] = None) -> None:
    """Write the full training state to ``path`` and, with
    ``weights_path``, the reference-layout weights beside it."""
    device = next(model.parameters()).device
    payload = {
        "model": _cpu_state_dict(model),
        "optimizer": optimizer.state_dict(),
        "epoch": int(epoch),
        "rng_cpu": torch.get_rng_state(),
        "rng_cuda": (torch.cuda.get_rng_state(device)
                     if device.type == "cuda" else None),
        "meta": dict(meta) if meta is not None else None,
    }
    _save(payload, path)
    if weights_path is not None:
        _save(payload["model"], weights_path)


def restore_checkpoint(path: str, model: nn.Module,
                       optimizer: Optimizer) -> int:
    """Load ``path`` into ``model`` and ``optimizer`` (built with the same
    architecture and settings), restore the RNG states, and return the
    epoch the checkpoint finished."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"], strict=True)
    optimizer.load_state_dict(payload["optimizer"])
    torch.set_rng_state(payload["rng_cpu"])
    device = next(model.parameters()).device
    if payload["rng_cuda"] is not None and device.type == "cuda":
        torch.cuda.set_rng_state(payload["rng_cuda"], device)
    return int(payload["epoch"])

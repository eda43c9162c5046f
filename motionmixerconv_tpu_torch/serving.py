"""Serving API: batched prediction from a trained ConvMixer or MlpMixer on
one device, or its bulk batches spread over several.

Counterpart of ``motionmixerconv_tpu/serving.py``. ``Predictor`` keeps the
model on its device and routes batches of at most ``fused_max_batch`` rows
to the model's fused kernel (a ConvMixer's B2 ``ops/conv_mixer.py`` at
conv_nChan 1 or B3 ``ops/conv_mixer_mc.py`` above; an MlpMixer's B4
``ops/mlp_mixer.py``) and larger ones to the plain model forward, or,
with a ``mesh``, to replicas of it on the mesh's devices. It runs on the
card unless the caller passes ``device="cpu"``; with no card the default
raises.

A model with a compute ``dtype`` (bf16) is routed as the JAX Predictor
routes it: the fused kernels read only its float32 parameters and compute
in float32, so batches of at most ``fused_max_batch`` rows get float32
answers, and larger ones the model's own bf16 forward.
"""

from __future__ import annotations

import copy
import warnings
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .models.mixer_conv import ConvMixer
from .models.mixer_mlp import MlpMixer
from .parallel.mesh import DataMesh


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device with no card raises.

    On the card it also pins full float32 for the plain forward's cuDNN
    convolutions and cuBLAS matmuls, process-wide: PyTorch lets cuDNN run
    ``Conv2d`` in TF32 by default, and the JAX reference computes in float32.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch sees no CUDA device; "
                "pass device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def model_io(model: nn.Module) -> Tuple[int, int, int]:
    """(input frames, output frames, input dims) of a ConvMixer or an
    MlpMixer."""
    if isinstance(model, MlpMixer):
        return model.seq_len, model.pred_len, model.input_size
    return model.in_nTP, model.out_nTP, model.dimPosIn


def _make_fused(model: nn.Module):
    """The model's fused kernel; NotImplementedError where there is none
    or the shape lies outside it."""
    if isinstance(model, ConvMixer):
        from .ops.conv_mixer import make_fused_conv_mixer

        return make_fused_conv_mixer(model)
    if isinstance(model, MlpMixer):
        from .ops.mlp_mixer import make_fused_mlp_mixer

        return make_fused_mlp_mixer(model)
    raise NotImplementedError(f"no fused kernel for {type(model).__name__}")


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """(B, T, D) array or tensor -> contiguous float32 tensor on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))
    return x.to(device=device, dtype=torch.float32).contiguous()


class Predictor:
    """Device-resident model server.

    Args:
        model: a port ConvMixer or MlpMixer ((B, input_n, D) -> (B,
            output_n, D)); the predictor works on its own copy.
        state_dict: reference-layout weights, loaded with ``strict=True``
            (``train.state.load_weights``: one read from a JAX ``.ckpt``
            takes ``encoder.frequencies`` from the model); None keeps the
            model's own.
        device: where the model lives and predictions run ("cuda" default).
        use_fused: route small batches to the fused kernel. Shapes it does
            not take fall back to the plain forward with a visible warning
            (``fused_fallback_reason``).
        fused_max_batch: largest batch routed to the fused kernel.
        mesh: a one-process ``parallel.DataMesh`` (``make_mesh(devices)``):
            a batch of more than ``fused_max_batch`` rows is padded to a
            multiple of ``len(mesh.devices)``, split into contiguous
            chunks, each run by a replica (``replicate_to``) on its own
            device and stream, and gathered on ``device`` without the
            padding rows; no collective. Smaller batches stay on the fused
            kernel of ``device``.
    """

    def __init__(self, model: nn.Module, state_dict=None, *, device="cuda",
                 use_fused: bool = True, fused_max_batch: int = 128,
                 mesh=None):
        if mesh is not None and not isinstance(mesh, DataMesh):
            raise TypeError(f"mesh must be a parallel.DataMesh, not "
                            f"{type(mesh).__name__}")
        if mesh is not None and mesh.group is not None:
            raise ValueError(
                "Predictor(mesh=) spreads a batch over one process's "
                "devices: make_mesh(devices) outside a process group")
        self.mesh = mesh
        self._replicas: list = []
        self.device = resolve_device(device)
        model = copy.deepcopy(model)
        if state_dict is not None:
            from .train.state import load_weights

            load_weights(model, state_dict)
        self.model = model.to(self.device).eval()
        self.fused_max_batch = fused_max_batch
        self._fused = None
        self.fused_fallback_reason: Optional[str] = None
        if use_fused:
            try:
                self._fused = _make_fused(self.model)
            except NotImplementedError as e:
                self.fused_fallback_reason = str(e)
                warnings.warn(
                    f"serving: fused kernel unavailable "
                    f"({self.fused_fallback_reason}); all batches use the "
                    "plain forward", stacklevel=2)
        if mesh is not None:
            self._replicas = [
                (r, torch.cuda.Stream(r.device) if r.device.type == "cuda"
                 else None)
                for r in (self.replicate_to(d) for d in mesh.devices)]

    @property
    def device_name(self) -> str:
        if self.device.type == "cuda":
            return torch.cuda.get_device_name(self.device)
        return str(self.device)

    def replicate_to(self, device) -> "Predictor":
        """A copy of this predictor on ``device``, with its own parameters
        and (when active) its own packed fused weights; a single-device
        predictor (the mesh's bulk path stays with this one)."""
        clone = copy.copy(self)
        clone.mesh, clone._replicas = None, []
        clone.device = resolve_device(device)
        clone.model = copy.deepcopy(self.model).to(clone.device).eval()
        if self._fused is not None:
            clone._fused = _make_fused(clone.model)
        return clone

    @classmethod
    def from_checkpoint(cls, model: Optional[nn.Module], path: str,
                        model_factory: Optional[Callable[[], nn.Module]] = None,
                        **kw) -> "Predictor":
        """Serve a checkpoint, routed by name as the JAX Predictor routes
        it: a torch ``.pt``/``.pth`` (a reference state_dict or the
        trainers' ``train_state.pt``), or else the JAX package's ``.ckpt``
        (``train/state.py``), loaded into ``model`` strictly.
        ``model=None`` rebuilds the trained architecture from the stored
        training args of a ``train_state.pt`` or a ``.ckpt`` with meta; a
        file without them takes ``model_factory()``."""
        from .models.torch_io import read_weights

        state_dict, meta = read_weights(path)
        if model is None:
            if meta:
                from .cli._runner import model_from_checkpoint_meta

                model = model_from_checkpoint_meta(meta)
            elif model_factory is not None:
                model = model_factory()
            else:
                raise ValueError(
                    f"{path}: the checkpoint carries no architecture "
                    "(no training-args meta); pass the model or a "
                    "model_factory")
        return cls(model, state_dict, **kw)

    @torch.inference_mode()
    def predict(self, x) -> torch.Tensor:
        """(B, input_n, D) -> (B, output_n, D) on the predictor's device."""
        x = as_tensor(x, self.device)
        if self._fused is not None and x.shape[0] <= self.fused_max_batch:
            return self._fused(x)
        if self.mesh is not None:
            return self._predict_spread(x)
        return self.model(x)

    def _predict_spread(self, x: torch.Tensor) -> torch.Tensor:
        """The mesh's bulk path: pad to a multiple of the replicas, one
        contiguous chunk a replica on its own stream, gathered here."""
        b, n = x.shape[0], len(self._replicas)
        bp = -(-b // n) * n
        if bp != b:
            x = torch.cat([x, x.new_zeros((bp - b, *x.shape[1:]))])
        outs = []
        for (rep, stream), chunk in zip(self._replicas, x.chunk(n)):
            if stream is None:  # a CPU replica
                outs.append((rep.model(chunk.to(rep.device)), None))
                continue
            stream.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(stream):
                y = rep.model(chunk.to(rep.device, non_blocking=True))
            if chunk.device == rep.device:
                chunk.record_stream(stream)
            outs.append((y, stream))
        gathered = []
        for y, stream in outs:
            if stream is not None:  # the chunk's stream, then its reader's
                torch.cuda.current_stream(y.device).wait_stream(stream)
                torch.cuda.current_stream(self.device).wait_stream(stream)
                y.record_stream(torch.cuda.current_stream(y.device))
            gathered.append(y.to(self.device))
        return torch.cat(gathered)[:b]

    @torch.inference_mode()
    def predict_autoregressive(self, x, horizon: int,
                               step_window: Optional[int] = None
                               ) -> torch.Tensor:
        """Closed-loop rollout to an arbitrary horizon: reuse the last
        input_n - step frames, append the prediction. ``step_window``
        defaults to the model's output length."""
        from .train.autoregressive import autoregressive_rollout

        in_n, out_n, _ = model_io(self.model)
        step = step_window or out_n
        n_steps = -(-horizon // step)  # ceil
        total = in_n + n_steps * step
        x = as_tensor(x, self.device)
        pad = x.new_zeros((x.shape[0], total - in_n, x.shape[2]))
        seq = torch.cat([x, pad], dim=1)
        _, pred = autoregressive_rollout(
            self.model, seq, input_n_model=in_n, output_n_model=out_n,
            step_window=step, teacher_forcing=False,
            loss_per_sample=lambda p, g: p.new_zeros(p.shape[0]),
        )
        return pred[:, :horizon]

"""Training checkpoints: the port's own format, with exact resume, and the
JAX package's ``.ckpt``.

Counterpart of ``motionmixerconv_tpu/train/state.py``. A ``train_state.pt``
holds the model's state_dict, the optimizer's (Adam moments and the
schedule's position), the epoch, the RNG states that drive dropout, and the
training args as meta, so ``--resume`` continues the same trajectory.
Beside it the weights alone go to a reference-layout ``.pt`` state_dict,
which ``Predictor.from_checkpoint`` serves.

The JAX package's ``.ckpt`` is a pickle of ``{state, variables, epoch[,
meta]}``, where ``state`` and ``variables`` are flax msgpack blobs of its
``TrainState`` (``step``, ``params``, ``batch_stats``, ``opt_state``,
``rng``) and of ``{params, batch_stats}``. ``read_jax_checkpoint`` reads
one through a restricted unpickler (builtins and numpy arrays and scalars
only: any other class raises and is named) and ``train/flax_msgpack.py``;
``restore_checkpoint`` takes either format by its name (``.pt``/``.pth``
are torch, anything else is the JAX format, as the JAX package routes
files) and restores the weights, BatchNorm statistics, Adam's moments and
count, the schedule's position and the epoch. ``save_jax_checkpoint``
writes the port's model, optimizer, epoch and meta as a ``.ckpt`` that the
JAX package's ``load_variables``, ``load_checkpoint_meta`` and
``restore_checkpoint`` read, with the ``opt_state`` of its
``make_optimizer`` chain (``[clip_by_global_norm,] add_decayed_weights,
adam(schedule)``).

Divergence, kept: the JAX state's ``rng`` (a uint32[2] threefry key) has no
counterpart in torch's generators. The port writes ``PRNGKey(seed)`` of
the run's seed, ``[0, seed]``, and ignores the key on reading, so a run
resumed across packages draws other dropout masks than an unbroken one.
"""

from __future__ import annotations

import os
import pickle
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from . import flax_msgpack
from .optim import Optimizer


def is_torch_file(path: str) -> bool:
    """``.pt``/``.pth`` files are torch's; anything else is the JAX
    package's ``.ckpt`` (JAX ``serving.py`` routes files the same way)."""
    return str(path).endswith((".pt", ".pth"))


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
    architecture and settings) and return the epoch the checkpoint
    finished. A ``train_state.pt`` also restores the RNG states; a JAX
    ``.ckpt`` leaves them (its key has no torch counterpart)."""
    if not is_torch_file(path):
        return restore_jax_checkpoint(path, model, optimizer)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(payload["model"], strict=True)
    optimizer.load_state_dict(payload["optimizer"])
    torch.set_rng_state(payload["rng_cpu"])
    device = next(model.parameters()).device
    if payload["rng_cuda"] is not None and device.type == "cuda":
        torch.cuda.set_rng_state(payload["rng_cuda"], device)
    return int(payload["epoch"])


# ------------------------------------------------------ the JAX .ckpt


# what a JAX .ckpt's pickle may name: builtins beyond pickle's own opcodes,
# and numpy arrays, dtypes and scalars (numpy 1 and 2 module paths)
_NUMPY = ("numpy.core.multiarray", "numpy._core.multiarray")
_ALLOWED = ({("builtins", n) for n in ("complex", "set", "frozenset",
                                        "bytearray", "slice", "range")}
            | {("numpy", n) for n in ("ndarray", "dtype")}
            | {(m, n) for m in _NUMPY for n in ("_reconstruct", "scalar")}
            | {(m, "_frombuffer")
               for m in ("numpy.core.numeric", "numpy._core.numeric")})


class ForeignClassError(pickle.UnpicklingError):
    """A checkpoint's pickle names a class a JAX ``.ckpt`` never holds."""


class _CheckpointUnpickler(pickle.Unpickler):
    """Admits builtins and numpy arrays and scalars; any other class
    raises, named. A ``.ckpt`` is a pickle, and unpickling a foreign class
    can run its code."""

    def find_class(self, module, name):
        if (module, name) in _ALLOWED:
            return super().find_class(module, name)
        raise ForeignClassError(
            f"the checkpoint's pickle names {module}.{name}; a JAX .ckpt "
            "holds only builtins and numpy arrays, so it is not loaded")


@dataclass
class JaxCheckpoint:
    """A JAX ``.ckpt``: the TrainState tree (``step``, ``params``,
    ``batch_stats``, ``opt_state``, ``rng``), the model variables
    (``params`` and, where not empty, ``batch_stats``), the epoch and the
    training-args meta (None where it has none), numpy leaves."""

    state: dict
    variables: dict
    epoch: int
    meta: Optional[dict]

    @property
    def num_blocks(self) -> int:
        return sum(k.startswith("Mixer_Block_")
                   for k in self.variables["params"])

    def state_dict(self) -> dict:
        """The variables as the port's (reference-layout) state_dict on the
        CPU, without ``encoder.frequencies``: a constant of the model's
        configuration, which ``load_weights`` takes from the model."""
        from ..models.torch_io import state_dict_from_jax

        return state_dict_from_jax(self.variables, self.num_blocks)


def read_jax_checkpoint(path: str) -> JaxCheckpoint:
    """Read a JAX package ``.ckpt``; ValueError for a file that is not
    one (or whose msgpack the port cannot decode), ForeignClassError for a
    pickle naming a foreign class."""
    with open(path, "rb") as f:
        try:
            payload = _CheckpointUnpickler(f).load()
        except ForeignClassError as e:
            raise ForeignClassError(f"{path}: {e}") from None
        except (pickle.UnpicklingError, EOFError, ValueError, TypeError,
                IndexError, KeyError) as e:
            raise ValueError(f"{path}: not a pickled checkpoint ({e})") from e
    if not (isinstance(payload, dict)
            and {"state", "variables", "epoch"} <= set(payload)):
        raise ValueError(f"{path}: not a JAX .ckpt (a pickle of {{state, "
                         "variables, epoch[, meta]}})")
    state = flax_msgpack.msgpack_restore(payload["state"])
    raw = flax_msgpack.msgpack_restore(payload["variables"])
    variables = {"params": raw["params"]}
    if raw.get("batch_stats"):
        variables["batch_stats"] = raw["batch_stats"]
    meta = payload.get("meta")
    return JaxCheckpoint(state, variables, int(payload["epoch"]),
                         dict(meta) if meta is not None else None)


def load_weights(model: nn.Module, state_dict: dict) -> None:
    """Load ``state_dict`` into ``model`` strictly; a state_dict read from
    a JAX ``.ckpt`` lacks ``encoder.frequencies``, which the model's own
    buffer supplies."""
    own = model.state_dict()
    missing = {k: own[k] for k in own
               if k.endswith("encoder.frequencies") and k not in state_dict}
    model.load_state_dict({**state_dict, **missing}, strict=True)


def _param_names(model: nn.Module) -> dict:
    """id(parameter) -> the first state_dict key that holds it (``se2``
    repeats ``se``)."""
    names: dict = {}
    for k, v in model.state_dict(keep_vars=True).items():
        if isinstance(v, nn.Parameter):
            names.setdefault(id(v), k)
    return names


def _adam_index(opt_state: dict) -> str:
    """The chain element that holds adam: the last of ``make_optimizer``'s
    ``[clip,] [decay,] adam`` chain."""
    return str(len(opt_state) - 1)


def restore_jax_checkpoint(path: str, model: nn.Module,
                           optimizer: Optimizer) -> int:
    """A JAX ``.ckpt`` into ``model`` (parameters and BatchNorm statistics)
    and ``optimizer`` (Adam's first and second moments and its count, the
    schedule's position); returns the epoch it finished. The rng key is
    ignored (module docstring)."""
    from ..models.torch_io import state_dict_from_jax

    ck = read_jax_checkpoint(path)
    load_weights(model, ck.state_dict())
    adam_state = ck.state["opt_state"][_adam_index(ck.state["opt_state"])]["0"]
    steps = int(adam_state["count"])
    moments = {}
    for key in ("mu", "nu"):
        tree = {"params": adam_state[key],
                "batch_stats": ck.variables.get("batch_stats", {})}
        moments[key] = state_dict_from_jax(tree, ck.num_blocks)
    names = _param_names(model)
    adam = optimizer.adam.state_dict()
    state = {}
    for i, p in enumerate(optimizer.params):
        name = names[id(p)]
        state[i] = {"step": torch.tensor(float(steps)),
                    "exp_avg": moments["mu"][name].reshape(p.shape),
                    "exp_avg_sq": moments["nu"][name].reshape(p.shape)}
    adam["state"] = state
    optimizer.load_state_dict({"adam": adam, "scheduler": (
        {"last_epoch": steps, "_last_lr": [optimizer.lr_at(steps)]}
        if optimizer.milestones is not None else None)})
    return ck.epoch


def _jax_params(model: nn.Module, values: dict) -> dict:
    """The flax params tree of ``values`` (id(parameter) -> tensor): the
    model's state_dict with each parameter replaced by its value, float32
    numpy leaves."""
    from ..models.torch_io import jax_from_state_dict

    sd = {k: values.get(id(v), v)
          for k, v in model.state_dict(keep_vars=True).items()}
    return _f32(jax_from_state_dict(sd, model.num_blocks)["params"])


def _f32(tree: dict) -> dict:
    return {k: _f32(v) if isinstance(v, dict) else np.asarray(v, np.float32)
            for k, v in tree.items()}


def save_jax_checkpoint(path: str, model: nn.Module, optimizer: Optimizer,
                        epoch: int, meta: Optional[dict] = None,
                        seed: int = 0) -> None:
    """Write ``model``, ``optimizer``, ``epoch`` and ``meta`` as the JAX
    package's ``.ckpt``: ``state`` (TrainState: ``step`` the optimizer's
    steps, int32; the float32 params and batch_stats; ``opt_state`` of the
    ``make_optimizer`` chain the optimizer's settings give; ``rng``
    ``PRNGKey(seed)``), ``variables`` and ``epoch``."""
    from ..models.torch_io import jax_from_state_dict

    variables = jax_from_state_dict(model.state_dict(), model.num_blocks)
    params = _f32(variables["params"])
    batch_stats = _f32(variables.get("batch_stats", {}))
    steps = optimizer.steps
    mu, nu = {}, {}
    for p in optimizer.params:
        st = optimizer.adam.state.get(p, {})
        zeros = torch.zeros_like(p, device="cpu")
        mu[id(p)] = st.get("exp_avg", zeros).detach().cpu()
        nu[id(p)] = st.get("exp_avg_sq", zeros).detach().cpu()
    count = np.asarray(steps, np.int32)
    adam = {"0": {"count": count, "mu": _jax_params(model, mu),
                  "nu": _jax_params(model, nu)},
            "1": {"count": count} if optimizer.milestones is not None else {}}
    chain = [{}] * ((optimizer.clip_grad is not None)
                    + bool(optimizer.weight_decay)) + [adam]
    state = {"step": np.asarray(steps, np.int32),
             "params": params,
             "batch_stats": batch_stats,
             "opt_state": {str(i): s for i, s in enumerate(chain)},
             "rng": np.asarray([(seed >> 32) & 0xffffffff, seed & 0xffffffff],
                               np.uint32)}
    payload = {
        "state": flax_msgpack.msgpack_serialize(state),
        "variables": flax_msgpack.msgpack_serialize(
            {"params": params, "batch_stats": batch_stats}),
        "epoch": int(epoch),
    }
    if meta is not None:
        payload["meta"] = dict(meta)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)

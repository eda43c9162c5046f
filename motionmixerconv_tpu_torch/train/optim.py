"""The reference's optimizer setup: Adam with coupled L2, MultiStepLR and an
optional global-norm clip.

Counterpart of ``motionmixerconv_tpu/train/optim.py``:

- ``torch.optim.Adam(lr, weight_decay=wd)`` folds the decay into the
  gradient before the moment updates (L2, not AdamW), as
  ``add_decayed_weights`` -> ``adam`` does in optax;
- the reference steps ``MultiStepLR`` once per epoch; here it steps once
  per batch with boundaries at ``milestone * steps_per_epoch``, the JAX
  package's per-step schedule, so the lr changes at the same step;
- ``clip_grad_norm_`` runs on the raw gradients before the step.

On a CUDA device Adam is ``capturable`` and reads its lr from a device
tensor, so that a step can be captured in a CUDA graph (``train/graphs.py``)
and replayed: ``update`` is the step's device work, ``advance`` the
schedule's host work between steps, which writes the lr tensor only at a
milestone. The schedule is MultiStepLR's own arithmetic on a Python float
(``lr * gamma ** count`` at each milestone), on the CPU and the card alike.
"""

from __future__ import annotations

from collections import Counter
from typing import Iterable, Optional, Sequence

import torch


class Optimizer:
    """Adam + the per-batch MultiStepLR + the optional clip, stepped as one.

    ``state_dict``/``load_state_dict`` cover Adam's moments and the
    schedule's position, so a resumed run continues the same trajectory;
    a state written on the CPU loads on the card and the other way round.
    ``generation`` counts the loads, which replace Adam's state tensors (a
    captured step that reads the old ones is stale).
    """

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 weight_decay: float = 1e-5, use_scheduler: bool = True,
                 milestones: Sequence[int] = (15, 25, 35, 40),
                 gamma: float = 0.1, steps_per_epoch: int = 1,
                 clip_grad: Optional[float] = None):
        self.params = list(params)
        self.capturable = self.params[0].device.type == "cuda"
        self.base_lr = float(lr)
        self.weight_decay = weight_decay
        self._lr = float(lr)
        self._lr_t = (torch.tensor(self._lr, device=self.params[0].device)
                      if self.capturable else None)
        self.adam = torch.optim.Adam(
            self.params, lr=self._lr_t if self.capturable else self._lr,
            weight_decay=weight_decay, capturable=self.capturable)
        self.milestones = (Counter(int(m) * steps_per_epoch
                                   for m in milestones)
                           if use_scheduler else None)
        self.gamma = gamma
        self.clip_grad = clip_grad
        self.steps = 0
        self.generation = 0
        self._schedule()  # MultiStepLR's own first step, at step 0

    @property
    def lr(self) -> float:
        """The learning rate the next step uses."""
        return self._lr

    def lr_at(self, steps: int) -> float:
        """The learning rate after ``steps`` steps: MultiStepLR's product
        over the milestones passed (optax's piecewise-constant schedule at
        count ``steps``)."""
        lr = self.base_lr
        for m, n in (self.milestones or {}).items():
            if m <= steps:
                lr *= self.gamma ** n
        return lr

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def update(self) -> None:
        """The device work of a step: the clip and Adam's update."""
        if self.clip_grad is not None:
            torch.nn.utils.clip_grad_norm_(self.params, self.clip_grad)
        self.adam.step()

    def advance(self) -> None:
        """The host work after a step: the schedule's position and lr."""
        self.steps += 1
        self._schedule()

    def step(self) -> None:
        self.update()
        self.advance()

    def _schedule(self) -> None:
        if self.milestones is not None and self.steps in self.milestones:
            self._lr = self.lr_at(self.steps)
            self._set_lr()

    def _set_lr(self) -> None:
        for group in self.adam.param_groups:
            group["lr"] = self._lr_t if self.capturable else self._lr
        if self.capturable:
            self._lr_t.fill_(self._lr)

    def state_dict(self) -> dict:
        adam = self.adam.state_dict()
        for group in adam["param_groups"]:
            group["lr"] = self._lr  # a float, whichever the device
        return {"adam": adam,
                "scheduler": ({"last_epoch": self.steps,
                               "_last_lr": [self._lr]}
                              if self.milestones is not None else None)}

    def load_state_dict(self, sd: dict) -> None:
        adam = dict(sd["adam"])
        adam["param_groups"] = [dict(g, capturable=self.capturable)
                                for g in adam["param_groups"]]
        self.adam.load_state_dict(adam)
        self._lr = float(adam["param_groups"][0]["lr"])
        if self.milestones is not None:
            # MultiStepLR's state_dict keys, so older checkpoints load too
            self.steps = int(sd["scheduler"]["last_epoch"])
            self._lr = float(sd["scheduler"]["_last_lr"][0])
        self._set_lr()
        self.generation += 1


def make_optimizer(params, lr: float, weight_decay: float = 1e-5,
                   use_scheduler: bool = True,
                   milestones: Sequence[int] = (15, 25, 35, 40),
                   gamma: float = 0.1, steps_per_epoch: int = 1,
                   clip_grad: Optional[float] = None) -> Optimizer:
    """Adam + coupled L2 + optional MultiStepLR + optional global-norm clip
    over ``params`` (the JAX package's ``make_optimizer`` arguments)."""
    return Optimizer(params, lr, weight_decay, use_scheduler, milestones,
                     gamma, steps_per_epoch, clip_grad)

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
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

import torch


class Optimizer:
    """Adam + the per-batch MultiStepLR + the optional clip, stepped as one.

    ``state_dict``/``load_state_dict`` cover Adam's moments and the
    schedule's position, so a resumed run continues the same trajectory.
    """

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 weight_decay: float = 1e-5, use_scheduler: bool = True,
                 milestones: Sequence[int] = (15, 25, 35, 40),
                 gamma: float = 0.1, steps_per_epoch: int = 1,
                 clip_grad: Optional[float] = None):
        self.params = list(params)
        self.adam = torch.optim.Adam(self.params, lr=lr,
                                     weight_decay=weight_decay)
        self.scheduler = torch.optim.lr_scheduler.MultiStepLR(
            self.adam, [int(m) * steps_per_epoch for m in milestones],
            gamma) if use_scheduler else None
        self.clip_grad = clip_grad

    @property
    def lr(self) -> float:
        """The learning rate the next step uses."""
        return float(self.adam.param_groups[0]["lr"])

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    def step(self) -> None:
        if self.clip_grad is not None:
            torch.nn.utils.clip_grad_norm_(self.params, self.clip_grad)
        self.adam.step()
        if self.scheduler is not None:
            self.scheduler.step()

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(),
                "scheduler": (self.scheduler.state_dict()
                              if self.scheduler is not None else None)}

    def load_state_dict(self, sd: dict) -> None:
        self.adam.load_state_dict(sd["adam"])
        if self.scheduler is not None:
            self.scheduler.load_state_dict(sd["scheduler"])


def make_optimizer(params, lr: float, weight_decay: float = 1e-5,
                   use_scheduler: bool = True,
                   milestones: Sequence[int] = (15, 25, 35, 40),
                   gamma: float = 0.1, steps_per_epoch: int = 1,
                   clip_grad: Optional[float] = None) -> Optimizer:
    """Adam + coupled L2 + optional MultiStepLR + optional global-norm clip
    over ``params`` (the JAX package's ``make_optimizer`` arguments)."""
    return Optimizer(params, lr, weight_decay, use_scheduler, milestones,
                     gamma, steps_per_epoch, clip_grad)

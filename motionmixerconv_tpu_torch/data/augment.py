"""Masking augmentations (PyTorch).

Counterpart of ``motionmixerconv_tpu/data/augment.py``: the reference's
defined-but-unused augmentations (h36m/utils/utils_mixer.py:180-202),
random frame zeroing and random joint-triplet zeroing. The draws come from
an explicit ``torch.Generator`` in place of the JAX key (the reference
draws from Python's global ``random``); ``idx`` takes the drawn indices
themselves, so a caller can replay another package's draws exactly.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _draw(n: int, high: int, generator: Optional[torch.Generator],
          idx, device) -> torch.Tensor:
    if idx is None:
        idx = torch.randint(0, high, (n,), generator=generator)
    elif not isinstance(idx, torch.Tensor):
        idx = torch.tensor(np.asarray(idx))
    return idx.to(device=device, dtype=torch.long)


def mask_sequence(seq: torch.Tensor, mframes: int,
                  generator: Optional[torch.Generator] = None,
                  idx=None) -> torch.Tensor:
    """Zero ``mframes`` time steps of (B, T, D) ``seq``, drawn with
    replacement (utils_mixer.py:180-187), or the steps ``idx``. Returns a
    new tensor."""
    idx = _draw(mframes, seq.shape[1], generator, idx, seq.device)
    out = seq.clone()
    out[:, idx, :] = 0.0
    return out


def mask_joints(seq: torch.Tensor, mjoints: int,
                generator: Optional[torch.Generator] = None,
                idx=None) -> torch.Tensor:
    """Zero ``mjoints`` xyz joint triplets of (B, T, D) ``seq`` (D a
    multiple of 3), drawn with replacement (utils_mixer.py:191-202, which
    samples triplet starts from range(0, 66, 3)), or the joints ``idx``.
    Returns a new tensor."""
    j = _draw(mjoints, seq.shape[2] // 3, generator, idx, seq.device)
    cols = (j[:, None] * 3 + torch.arange(3, device=seq.device)).reshape(-1)
    out = seq.clone()
    out[:, :, cols] = 0.0
    return out

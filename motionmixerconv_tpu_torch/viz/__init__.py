"""Skeleton GIFs, the live prediction viewer, the raw AIS viewer and the
result galleries.

Counterpart of ``motionmixerconv_tpu/viz``. matplotlib and Pillow are
imported only where a frame is drawn or a GIF written, so the package
imports on a machine without them (the card's): evaluation and predictions
run on the card, rendering on the host.

- ``gif``       — ``visualize_batch``, ``visualize_batch_ais``
- ``live``      — ``pose_animation``, ``predict_windows``; ``python -m
  motionmixerconv_tpu_torch.viz.live``
- ``galleries`` — ``h36m_galleries``, ``study_tables``; ``python -m
  motionmixerconv_tpu_torch.viz.galleries``
- ``ais_raw``   — ``python -m motionmixerconv_tpu_torch.viz.ais_raw``
"""

from .gif import visualize_batch, visualize_batch_ais
from .live import pose_animation

__all__ = ["visualize_batch", "visualize_batch_ais", "pose_animation"]

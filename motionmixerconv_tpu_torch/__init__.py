"""MotionMixerConv on PyTorch and CUDA: the port of ``motionmixerconv_tpu``.

The JAX package beside it is the unchanged reference. This package imports
``torch`` and never ``jax``. Its hot kernels are hand-written CUDA C++ for
Hopper (``csrc/``), built at first use; each has a plain PyTorch version
that serves CPU tensors.

- ``models``   — PoseEncoder, ConvEncoder, ConvMixer and MlpMixer with the
  reference state_dict names
- ``ops``      — activations and the CUDA kernels' wrappers
- ``data``     — H36M, AMASS, AIS and CMU constants, synthetic corpora,
  windows, the datasets, the SRNN normalization and masking augmentations
- ``geometry`` — rotations, H36M, CMU and SMPL forward kinematics, DCT, the
  AMASS skeleton graph
- ``metrics``  — losses and evaluation metrics
- ``train``    — optimizer, checkpoints (``train_state.pt`` and the JAX
  ``.ckpt``), the Trainer, the autoregressive trainer and rollout
- ``logging``  — MetricLogger
- ``cli``      — ``python -m motionmixerconv_tpu_torch.cli.train_mixer_h36m``,
  ``train_autoreg_mixer_h36m``, ``train_mixer_amass``, ``train_mixer_ais``,
  ``train_autoreg_mixer_ais``, ``test_mixer_h36m``, ``test_mixer_amass``
- ``sweep``    — the studies: ``python -m motionmixerconv_tpu_torch.sweep.
  conv_study``, ``mlp_study``, ``autoreg_study``, ``optuna_export``,
  ``analysis``
- ``parity_runs`` — full-schedule convergence runs held to the recorded
  reference runs (``python -m motionmixerconv_tpu_torch.parity_runs``)
- ``serving``  — Predictor; ``serving_server`` — micro-batching HTTP server
- ``viz``      — skeleton GIFs and viewers: ``python -m
  motionmixerconv_tpu_torch.viz.galleries``, ``viz.live``, ``viz.ais_raw``
  (evaluation on the card; matplotlib renders on the host)
- ``profiling`` — the card's ceilings, ``profile_trace``
  (``MMC_PROFILE_DIR`` traces a run's first epoch or chunk), the
  program's spans (``span``, ``snapshot``)
- ``_native``  — the C++ CSV reader the H3.6M and CMU corpora are read
  through, built with ``g++`` into ``build/native/`` at first use
"""

from . import geometry, metrics  # lightweight subpackages
from .serving import Predictor

__version__ = "0.1.0"

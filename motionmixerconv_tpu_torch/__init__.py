"""MotionMixerConv on PyTorch and CUDA: the port of ``motionmixerconv_tpu``.

The JAX package beside it is the unchanged reference. This package imports
``torch`` and never ``jax``. Its hot kernels are hand-written CUDA C++ for
Hopper (``csrc/``), built at first use; each has a plain PyTorch version
that serves CPU tensors.

- ``models``   — PoseEncoder, ConvMixer and MlpMixer with the reference
  state_dict names
- ``ops``      — activations and the CUDA kernels' wrappers
- ``data``     — H36M and AMASS constants, synthetic corpora, windows, the
  datasets
- ``geometry`` — rotations, H36M and SMPL forward kinematics
- ``metrics``  — losses and evaluation metrics
- ``train``    — optimizer, checkpoints, the Trainer, the autoregressive rollout
- ``logging``  — MetricLogger
- ``cli``      — ``python -m motionmixerconv_tpu_torch.cli.train_mixer_h36m``,
  ``train_autoreg_mixer_h36m``, ``train_mixer_amass``, ``test_mixer_amass``
- ``serving``  — Predictor; ``serving_server`` — micro-batching HTTP server
"""

__version__ = "0.1.0"

"""Activations and the wrappers of the hand-written CUDA kernels
(``conv_mixer``: fused ConvMixer core; ``harmonic``: fused harmonic
encoder forward and backward). Kernels are built by ``_build`` at first use."""

"""Command-line entry points (``python -m motionmixerconv_tpu_torch.cli.<name>``)."""

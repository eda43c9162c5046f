"""The multi-channel ConvBlock kernels' backward calls a training step: the
kernels' own device count (``ops/conv_block_mc.py`` ``device_launches``,
graph replays included; a backward call's first kernel counts it) over the
program's ``train.step`` spans, untraced and traced, both over the whole
process (set-up's steps, the window, the step after it). Every ConvBlock
of two or more channels that a step differentiates through the kernels
adds one: the autoregressive step's five rollout forwards of eight
ConvBlocks hold forty. None where the program has no such kernels, where
they never ran a backward (a model of one channel), or where no step was
counted."""


def read(run):
    import torch

    if not torch.cuda.is_available():
        return None
    try:
        from motionmixerconv_tpu_torch import profiling
        from motionmixerconv_tpu_torch.ops import conv_block_mc
    except ImportError:  # a program without the kernels
        return None
    # no backward through the wrapper (a capture goes through it too): the
    # kernels never ran, and reading their counter would load the library
    if not hasattr(profiling, "snapshot") \
            or conv_block_mc.LAUNCHES_BWD.value == 0:
        return None
    snap = profiling.snapshot()
    steps = sum(snap[b].get("train.step", {}).get("count", 0)
                for b in ("untraced", "traced"))
    bwd = conv_block_mc.device_launches()[1]
    if steps <= 0 or bwd <= 0:
        return None
    return bwd / steps

"""The single-channel ConvBlock kernel's backward launches a training step:
the kernel's own device count (``ops/conv_block.py`` ``device_launches``,
graph replays included) over the program's ``train.step`` spans, untraced
and traced, both over the whole process (set-up's steps, the window, the
step after it). Every single-channel ConvBlock of a step that runs through
the kernel adds one: the flagship's four mixer blocks hold eight. None
where the program has no such kernel, where it never ran a backward (a
model of wider blocks), or where no step was counted."""


def read(run):
    import torch

    if not torch.cuda.is_available():
        return None
    try:
        from motionmixerconv_tpu_torch import profiling
        from motionmixerconv_tpu_torch.ops import conv_block
    except ImportError:  # a program without the kernel
        return None
    # no backward through the wrapper (a capture goes through it too): the
    # kernel never ran, and reading its counter would load the library
    if not hasattr(profiling, "snapshot") or conv_block.LAUNCHES_BWD.value == 0:
        return None
    snap = profiling.snapshot()
    steps = sum(snap[b].get("train.step", {}).get("count", 0)
                for b in ("untraced", "traced"))
    bwd = conv_block.device_launches()[1]
    if steps <= 0 or bwd <= 0:
        return None
    return bwd / steps

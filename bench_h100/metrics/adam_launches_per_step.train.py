"""The Adam kernel's launches a training step: the kernel's own device
count (``ops/adam.py`` ``device_launches``, graph replays included) over
the program's ``train.step`` spans, untraced and traced, both over the
whole process (set-up's steps, the window, the step after it). A step whose
update is one launch reads 1.0; a model of more tensors than one launch
describes reads more. None where the program has no such kernel, where it
never launched (the CPU), or where no step was counted."""


def read(run):
    import torch

    if not torch.cuda.is_available():
        return None
    try:
        from motionmixerconv_tpu_torch import profiling
        from motionmixerconv_tpu_torch.ops import adam
    except ImportError:  # a program without the kernel
        return None
    # no launch through the wrapper (a capture goes through it too): the
    # kernel never ran, and reading its counter would load the library
    if not hasattr(profiling, "snapshot") or adam.LAUNCHES.value == 0:
        return None
    snap = profiling.snapshot()
    steps = sum(snap[b].get("train.step", {}).get("count", 0)
                for b in ("untraced", "traced"))
    launches = adam.device_launches()
    if steps <= 0 or launches <= 0:
        return None
    return launches / steps

"""The share of the epochs' and evaluations' host time spent outside their
steps and host reads: the program's ``train.epoch`` and ``eval.pass``
spans, less the ``train.step``, ``eval.step`` and ``read`` spans inside
them, over the two less their one-time work (the step graphs' eager
warm-ups, the first of which builds the kernels, and their captures),
among the spans recorded with no profiler recording. That is the phases'
host work before the first launch (the shuffle, the batches' copy, the
evaluation stacks' keys) and after the read; the read before it has
drained the device's queue, so the device is idle throughout. None where
no phase ran or the program keeps no spans."""


def read(run):
    from motionmixerconv_tpu_torch import profiling

    if not hasattr(profiling, "snapshot"):  # a program without spans
        return None
    spans = profiling.snapshot()["untraced"]

    def total(name):
        return spans.get(name, {}).get("total_ns", 0)

    phases = total("train.epoch") + total("eval.pass")
    once = total("train.eager") + total("eval.eager") + total("capture")
    if phases - once <= 0:
        return None
    inside = total("train.step") + total("eval.step") + total("read")
    return (phases - inside) / (phases - once) * 100.0

"""The host's microseconds in one training step's graph launch: the
program's ``train.launch`` spans (``graph.replay()`` in
``train/graphs.py``), total over count, among the spans recorded with no
profiler recording (the window's untraced epochs, set-up's steps and
evaluations, the step after the window). Where the host sets the pace this
is the launch's own cost; where the device does, and the launch queue is
full, it is the device's step time. None where no graph was launched (the
CPU) or the program keeps no spans."""


def read(run):
    from motionmixerconv_tpu_torch import profiling

    if not hasattr(profiling, "snapshot"):  # a program without spans
        return None
    launch = profiling.snapshot()["untraced"].get("train.launch")
    if not launch or launch["count"] <= 0:
        return None
    return launch["total_ns"] / launch["count"] / 1e3

"""A training step's own host microseconds outside its launch or eager
body: the self time of the program's ``train.step`` spans (one batch of
``StepGraph.run``: the batch's select and copies into the graph's inputs,
and the schedule's advance) over their count, among the spans recorded
with no profiler recording. None where no step ran or the program keeps
no spans."""


def read(run):
    from motionmixerconv_tpu_torch import profiling

    if not hasattr(profiling, "snapshot"):  # a program without spans
        return None
    step = profiling.snapshot()["untraced"].get("train.step")
    if not step or step["count"] <= 0:
        return None
    return step["self_ns"] / step["count"] / 1e3

"""The nodes of the training step's captured CUDA graph: the count the
program records at each capture (``train/graphs.py``, read from the
graph through the driver's ``cuGraphGetNodes``), over the training graphs
the process captured. Each node is a kernel, a copy or a memset that the
host's launch hands to the device, so the count sets the launch's cost
where the host paces the step. None where no training graph was captured
(the CPU) or the program keeps no such count."""


def read(run):
    from motionmixerconv_tpu_torch import profiling

    if not hasattr(profiling, "graph_nodes"):  # a program without the count
        return None
    train = profiling.graph_nodes().get("train")
    if not train or train["graphs"] <= 0:
        return None
    return train["nodes"] / train["graphs"]

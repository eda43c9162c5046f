"""B1's share of its roofline in the flagship's training steps.

The frozen bound of one forward (``b1_work``) and one dW+db backward
(``b1_bwd_work``) at R = batch x input frames rows, over the mean device
time of one call of each, from the kernels' events in the traced epoch's
training span. Per-call means hold where the profiler loses records.
"""

from bench_h100.work import yardsticks

FWD = ("harmonic_dense_fwd_kernel", "harmonic_dense_sum_kernel")
DW = ("harmonic_dense_bwd_dw_kernel", "harmonic_dense_bwd_finish_kernel")


def _call_s(trace, names):
    """Mean seconds of one call: each kernel's mean over its events, summed
    over the kernels of the call that ran; None if the first never ran."""
    total = 0.0
    for i, name in enumerate(names):
        s, n = trace.op_stats((name,), span="train")
        if n == 0:
            if i == 0:
                return None
            continue
        total += s / n
    return total


def read(run):
    t = run.trace
    launches = run.counters.get("b1_launches")
    if t is None or not launches or min(launches) <= 0:
        return None
    fwd, dw = _call_s(t, FWD), _call_s(t, DW)
    if fwd is None or dw is None:
        return None
    c = run.config
    rows = c["batch_size"] * c["input_n_model"]
    shape = (rows, c["pose_dim"], c["encoder_n_harmonic_functions"],
             c["hidden_dim"])
    least_ms = (yardsticks.bound(*yardsticks.b1_work(*shape))[0]
                + yardsticks.bound(*yardsticks.b1_bwd_work(*shape))[0])
    return least_ms / 1e3 / (fwd + dw) * 100.0

"""The share of one traced training epoch (train, validation and test) in
which no operation ran on the device, from the profiler's device events.
The tracer's own work lengthens the epoch (CUPTI records each kernel of
each replayed graph), so the share reads above an untraced epoch's."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return (1.0 - t.busy_s / t.window_s) * 100.0

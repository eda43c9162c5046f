"""The share of the training window spent in evaluation: the benchmark's
host-clock spans around ``validate`` and ``evaluate_grouped``, each ending
in a host read, over the window (the traced epoch left out)."""


def read(run):
    c = run.counters
    if c["epochs"] <= 0 or c["window_s"] <= 0:
        return None
    return c["eval_s"] / c["window_s"] * 100.0

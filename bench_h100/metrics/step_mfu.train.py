"""The training window's model FLOPs over the card's float32 peak.

FLOPs: every epoch's training samples times a step's forward and backward
per sample, plus its validation and test samples times their forwards,
counted at set-up on the reference on the meta device (matmuls and
convolutions only). Time: the window's host clock, the traced epoch left
out. The float32 peak, as the port pins TF32 off.
"""

from bench_h100.work import yardsticks


def read(run):
    c = run.counters
    peak = yardsticks.PEAK_FLOPS_F32.get(run.device_kind)
    if not peak or c["epochs"] <= 0 or c["window_s"] <= 0:
        return None
    flops = c["epochs"] * (c["n_train"] * c["train_flops_per_sample"]
                           + c["n_eval"] * c["eval_flops_per_sample"])
    return flops / (c["window_s"] * peak) * 100.0

"""The trace's reduction and every per-layer reader's arithmetic, on a
canned trace and canned counters."""

from types import SimpleNamespace

import pytest

from bench_h100 import harness, tracing
from bench_h100.work import yardsticks as y


class Ev:
    def __init__(self, dev, name, start_us, dur_us, annotation=False):
        self._d, self._n = dev, name
        self._s, self._t = int(start_us * 1000), int(dur_us * 1000)
        self._a = annotation

    def device_type(self):
        return f"DeviceType.{self._d}"

    def is_user_annotation(self):
        return self._a

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t


EVENTS = [
    Ev("CPU", "bench.train", 0, 100),
    Ev("CPU", "cudaGraphLaunch", 0, 30),
    Ev("CPU", "aten::copy_", 45, 10),
    Ev("CUDA", "harmonic_dense_fwd_kernel", 10, 20),
    Ev("CUDA", "harmonic_dense_sum_kernel", 25, 10),   # overlaps the last
    Ev("CUDA", "harmonic_dense_bwd_dw_kernel", 50, 15),
    Ev("CUDA", "ProfilerStep", 0, 200, annotation=True),
    Ev("CPU", "bench.eval", 100, 100),
    Ev("CUDA", "harmonic_dense_fwd_kernel", 120, 40),
]


def test_summarize():
    t = tracing.summarize(EVENTS, 250e-6)
    # busy: [10, 35] + [50, 65] + [120, 160] microseconds
    assert t.busy_s == pytest.approx(80e-6)
    assert t.window_s == 250e-6
    assert t.op_stats(("harmonic_dense_fwd_kernel",)) == pytest.approx((60e-6, 2))
    assert t.op_stats(("harmonic_dense_fwd_kernel",), span="train") == \
        pytest.approx((20e-6, 1))
    assert t.op_stats(("harmonic_dense_fwd_kernel",), span="eval") == \
        pytest.approx((40e-6, 1))
    # gaps: 35-50 while aten::copy_ (45..55) had not started: the graph
    # launch (0..30) had ended, so no operation; 65-120 with none either
    names = dict(t.idle_gaps)
    assert sum(names.values()) == pytest.approx(70e-6)
    top = t.breakdown()
    assert top["device_ops"][0] == ["harmonic_dense_fwd_kernel", pytest.approx(60e-6)]
    assert len(top["device_ops"]) == 3


def test_gap_named_by_the_host_operation_running():
    evs = [Ev("CPU", "cudaStreamSynchronize", 0, 100),
           Ev("CUDA", "k", 0, 10), Ev("CUDA", "k", 60, 10)]
    assert tracing.summarize(evs, 1e-4).idle_gaps == [
        ("cudaStreamSynchronize", pytest.approx(50e-6))]


def _config():
    return harness.resolve(harness.load_benchmark(), "flagship.train").config


def read(name, **kw):
    run = SimpleNamespace(config=_config(), counters={}, trace=None,
                          device_kind=y.H100)
    for k, v in kw.items():
        setattr(run, k, v)
    return harness.metric_module(name).read(run)


def test_b1_roofline():
    t = tracing.summarize(EVENTS, 250e-6)
    got = read("b1_roofline.train", trace=t,
               counters={"b1_launches": [2, 1]})
    fwd = 20e-6 + 10e-6  # the train span's mean forward call, with its sum
    dw = 15e-6
    shape = (500, 66, 64, 50)
    least = y.bound(*y.b1_work(*shape))[0] + y.bound(*y.b1_bwd_work(*shape))[0]
    assert got == pytest.approx(least / 1e3 / (fwd + dw) * 100)
    assert read("b1_roofline.train", trace=t,
                counters={"b1_launches": [0, 0]}) is None
    assert read("b1_roofline.train", counters={"b1_launches": [2, 1]}) is None


def test_step_mfu_and_eval_share():
    c = {"epochs": 3, "window_s": 2.0, "eval_s": 0.5, "n_train": 100,
         "n_eval": 40, "train_flops_per_sample": 3e9,
         "eval_flops_per_sample": 1e9}
    want = 3 * (100 * 3e9 + 40 * 1e9) / (2.0 * 67e12) * 100
    assert read("step_mfu.train", counters=c) == pytest.approx(want)
    assert read("step_mfu.train", counters=c, device_kind="cpu") is None
    assert read("eval_share.train", counters=c) == pytest.approx(25.0)


def test_idle_shares():
    t = tracing.summarize([Ev("CUDA", "k", 0, 30)], 120e-6)
    name = "device_idle_share.train"
    assert read(name, trace=t) == pytest.approx(75.0)
    assert read(name, trace=tracing.summarize([], 1.0)) is None

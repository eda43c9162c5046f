"""The readers of the program's spans (``graph_launch_us.train``,
``step_host_us.train``, ``epoch_host_share.train``) on canned snapshots:
their arithmetic on the untraced bucket alone, None where a count or a
total is 0 and where the program keeps no spans (a parent commit's)."""

from types import SimpleNamespace

import pytest

from bench_h100 import harness
from motionmixerconv_tpu_torch import profiling

NAMES = ("graph_launch_us.train", "step_host_us.train",
         "epoch_host_share.train")
RUN = SimpleNamespace(config={}, counters={}, trace=None, device_kind="x")


def _span(count, total_ns, self_ns):
    return {"count": count, "total_ns": total_ns, "self_ns": self_ns}


UNTRACED = {
    "train.epoch": _span(3, 3_000_000, 90_000),
    "eval.pass": _span(6, 600_000, 30_000),
    "train.batches": _span(3, 60_000, 60_000),
    "eval.stack": _span(6, 12_000, 12_000),
    "train.step": _span(1500, 2_700_000, 45_000),
    "train.launch": _span(1494, 2_600_000, 2_600_000),
    "train.eager": _span(3, 50_000, 50_000),
    "capture": _span(1, 5_000, 5_000),
    "eval.step": _span(60, 500_000, 3_000),
    "read": _span(9, 72_000, 72_000),
}
# a traced epoch's spans, which no reader may take
TRACED = {k: _span(v["count"], 50 * v["total_ns"], 50 * v["self_ns"])
          for k, v in UNTRACED.items()}


def _read(name, monkeypatch, untraced, traced=None):
    monkeypatch.setattr(profiling, "snapshot", lambda: {
        "untraced": untraced, "traced": traced or {}})
    return harness.metric_module(name).read(RUN)


def test_readers_take_the_untraced_spans(monkeypatch):
    got = {n: _read(n, monkeypatch, UNTRACED, TRACED) for n in NAMES}
    assert got["graph_launch_us.train"] == pytest.approx(2_600_000 / 1494 / 1e3)
    assert got["step_host_us.train"] == pytest.approx(45_000 / 1500 / 1e3)
    # the eager warm-ups and the capture are one-time work: out of the base
    assert got["epoch_host_share.train"] == pytest.approx(
        (3_600_000 - 2_700_000 - 500_000 - 72_000)
        / (3_600_000 - 50_000 - 5_000) * 100)


@pytest.mark.parametrize("name", NAMES)
def test_readers_find_nothing_to_read(name, monkeypatch):
    """None with no spans at all, with only traced spans, and where the
    program has no ``snapshot`` (nothing to read, and no raise)."""
    assert _read(name, monkeypatch, {}) is None
    assert _read(name, monkeypatch, {}, TRACED) is None
    monkeypatch.delattr(profiling, "snapshot")
    assert harness.metric_module(name).read(RUN) is None


def test_no_launch_on_the_cpu(monkeypatch):
    """The CPU's steps run eagerly: no launch to time, but a step's own
    host work and the phases' share are read."""
    cpu = {k: v for k, v in UNTRACED.items()
           if k not in ("train.launch", "capture")}
    assert _read("graph_launch_us.train", monkeypatch, cpu) is None
    assert _read("step_host_us.train", monkeypatch, cpu) is not None
    assert _read("epoch_host_share.train", monkeypatch, cpu) is not None

"""The reader of ``adam_launches_per_step.train`` where it finds nothing to
read: no card, a program without the Adam kernel (a parent commit's), a
kernel that never launched; and its ratio on canned counts."""

import sys

import torch

from bench_h100 import harness


def _read():
    return harness.metric_module("adam_launches_per_step.train").read(None)


def test_none_without_a_card():
    assert not torch.cuda.is_available()
    assert _read() is None


def test_none_where_the_program_has_no_kernel(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setitem(sys.modules, "motionmixerconv_tpu_torch.ops.adam",
                        None)
    ops = sys.modules.get("motionmixerconv_tpu_torch.ops")
    if ops is not None and hasattr(ops, "adam"):
        monkeypatch.delattr(ops, "adam")
    assert _read() is None


def test_none_before_a_launch_then_launches_over_steps(monkeypatch):
    from motionmixerconv_tpu_torch import profiling
    from motionmixerconv_tpu_torch.ops import adam

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(adam, "device_launches", lambda: 600)
    monkeypatch.setattr(profiling, "snapshot", lambda: {
        "untraced": {"train.step": {"count": 400}},
        "traced": {"train.step": {"count": 200}}})
    monkeypatch.setattr(adam.LAUNCHES, "value", 0)
    assert _read() is None
    monkeypatch.setattr(adam.LAUNCHES, "value", 3)
    assert _read() == 1.0

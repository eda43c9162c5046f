"""The reader of ``conv_block_mc_bwd_per_step.train`` where it finds
nothing to read: no card, a program without the multi-channel ConvBlock
kernels (a parent commit's), kernels that never ran a backward; and its
ratio on canned counts."""

import sys

import torch

from bench_h100 import harness


def _read():
    return harness.metric_module("conv_block_mc_bwd_per_step.train").read(
        None)


def test_none_without_a_card():
    assert not torch.cuda.is_available()
    assert _read() is None


def test_none_where_the_program_has_no_kernel(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setitem(
        sys.modules, "motionmixerconv_tpu_torch.ops.conv_block_mc", None)
    ops = sys.modules.get("motionmixerconv_tpu_torch.ops")
    if ops is not None and hasattr(ops, "conv_block_mc"):
        monkeypatch.delattr(ops, "conv_block_mc")
    assert _read() is None


def test_none_before_a_backward_then_calls_over_steps(monkeypatch):
    from motionmixerconv_tpu_torch import profiling
    from motionmixerconv_tpu_torch.ops import conv_block_mc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(conv_block_mc, "device_launches",
                        lambda: (4800, 2400))
    monkeypatch.setattr(profiling, "snapshot", lambda: {
        "untraced": {"train.step": {"count": 40}},
        "traced": {"train.step": {"count": 20}}})
    monkeypatch.setattr(conv_block_mc.LAUNCHES_BWD, "value", 0)
    assert _read() is None
    monkeypatch.setattr(conv_block_mc.LAUNCHES_BWD, "value", 3)
    assert _read() == 40.0
    monkeypatch.setattr(conv_block_mc, "device_launches", lambda: (4800, 0))
    assert _read() is None

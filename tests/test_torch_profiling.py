"""The port's ``profiling`` module on the CPU, against the JAX package's.

The card's ceilings (NVIDIA's H100 data sheet), the physical-ceiling check
held to the JAX check's decisions on the same multiples of each package's
own ceilings (the cases of ``tests/test_bench_checks.py`` re-run against
the H100), ``profile_trace`` (a no-op for None, a parsable Chrome trace
JSON otherwise), the throughput meter, and the runners' traced first epoch
or first chunk under ``MMC_PROFILE_DIR``: epoch 0 of the per-epoch path
(the H36M and AMASS runners, which share it), the first chunk of the fused
path, one trace file a run.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from motionmixerconv_tpu import profiling as jax_profiling
from motionmixerconv_tpu_torch import profiling
from motionmixerconv_tpu_torch.cli import _runner
from motionmixerconv_tpu_torch.cli import train_mixer_amass, train_mixer_h36m
from motionmixerconv_tpu_torch.data import fixtures
from motionmixerconv_tpu_torch.profiling import (PEAK_BYTES, PEAK_FLOPS,
                                                 PEAK_FLOPS_F32,
                                                 check_physical_ceilings,
                                                 peak_flops_for)
from motionmixerconv_tpu_torch.train import Trainer

KIND = "NVIDIA H100 80GB HBM3"
JAX_KIND = "TPU v5 lite"


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, as the suite's workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_card_tables():
    """The H100's data-sheet ceilings, keyed by torch's device name, and no
    TPU entry."""
    assert PEAK_FLOPS_F32 == {KIND: 67e12}
    assert PEAK_BYTES == {KIND: 3.35e12}
    assert PEAK_FLOPS == {KIND: 989e12}
    assert all(not k.startswith("TPU") for k in
               (*PEAK_FLOPS, *PEAK_FLOPS_F32, *PEAK_BYTES))


class TestCeilings:
    """``tests/test_bench_checks.py``'s ``TestCeilings``, against the H100."""

    def test_f32_run_gated_by_f32_peak(self):
        flops = (PEAK_FLOPS_F32[KIND] + PEAK_FLOPS[KIND]) / 2
        with pytest.raises(RuntimeError, match="float32 peak"):
            check_physical_ceilings(
                "fabricated", device_kind=KIND, dtype="float32",
                flops_per_s=flops)

    def test_bf16_run_allows_full_tensor_core_rate(self):
        flops = (PEAK_FLOPS_F32[KIND] + PEAK_FLOPS[KIND]) / 2
        check_physical_ceilings(
            "ok", device_kind=KIND, dtype="bfloat16", flops_per_s=flops)
        with pytest.raises(RuntimeError, match="bfloat16 peak"):
            check_physical_ceilings(
                "fab", device_kind=KIND, dtype="bfloat16",
                flops_per_s=PEAK_FLOPS[KIND] * 1.01)

    def test_bandwidth_roof(self):
        roof = PEAK_BYTES[KIND]
        check_physical_ceilings(
            "ok", device_kind=KIND, bytes_per_s=roof * 1.04)
        with pytest.raises(RuntimeError, match="HBM bytes/s"):
            check_physical_ceilings(
                "fab", device_kind=KIND, bytes_per_s=roof * 1.10)

    def test_bytes_breach_tolerated_when_not_strict(self):
        roof = PEAK_BYTES[KIND]
        assert check_physical_ceilings(
            "fused-model", device_kind=KIND, bytes_per_s=roof * 1.10,
            strict_bytes=False) is True
        assert check_physical_ceilings(
            "ok", device_kind=KIND, bytes_per_s=roof * 0.5,
            strict_bytes=False) is False
        with pytest.raises(RuntimeError, match="float32 peak"):
            check_physical_ceilings(
                "fab", device_kind=KIND, dtype="float32",
                flops_per_s=PEAK_FLOPS[KIND], strict_bytes=False)

    def test_unknown_device_checks_nothing(self):
        check_physical_ceilings(
            "cpu-run", device_kind="cpu", dtype="float32",
            flops_per_s=1e30, bytes_per_s=1e30)

    def test_peak_table_selection(self):
        assert peak_flops_for(KIND, np.float32) == PEAK_FLOPS_F32[KIND]
        assert peak_flops_for(KIND, "bfloat16") == PEAK_FLOPS[KIND]
        assert peak_flops_for(KIND, "float16") == PEAK_FLOPS[KIND]
        assert peak_flops_for("nope", "float32") is None
        with pytest.raises(ValueError, match="no peak-FLOP/s ceiling"):
            peak_flops_for(KIND, np.float64)


def _outcome(mod, kind, **kw):
    """("returned", value) or ("raised", the roof it names)."""
    try:
        return "returned", mod.check_physical_ceilings("x", device_kind=kind,
                                                       **kw)
    except RuntimeError as e:
        return "raised", "FLOP/s" if "FLOP/s" in str(e) else "bytes/s"


# (dtype, FLOP/s as a multiple of the dtype's peak, bytes/s as a multiple
# of the roof, strict_bytes)
CASES = [
    ("float32", 0.5, None, True), ("float32", 1.0, None, True),
    ("float32", 1.01, None, True), ("bfloat16", 0.99, None, True),
    ("bfloat16", 1.01, None, True), (None, None, 1.04, True),
    (None, None, 1.05, True), (None, None, 1.06, True),
    (None, None, 1.06, False), ("float32", 1.5, 1.5, False),
]


@pytest.mark.parametrize("dtype,flops,nbytes,strict", CASES)
def test_same_decisions_as_the_jax_check(dtype, flops, nbytes, strict):
    """The port's check decides as the JAX package's does on the same
    multiples of each package's own ceilings (the FLOP roof strict, 5%
    slack on the bytes roof, ``strict_bytes=False`` returning True)."""
    outcomes = []
    for mod, kind in ((jax_profiling, JAX_KIND), (profiling, KIND)):
        kw = {"strict_bytes": strict}
        if flops is not None:
            kw.update(dtype=dtype,
                      flops_per_s=flops * mod.peak_flops_for(kind, dtype))
        if nbytes is not None:
            kw["bytes_per_s"] = nbytes * mod.PEAK_BYTES[kind]
        outcomes.append(_outcome(mod, kind, **kw))
    assert outcomes[0] == outcomes[1]


def test_profile_trace_none_is_a_no_op(tmp_path):
    ran = []
    with profiling.profile_trace(None):
        ran.append(torch._C._autograd._profiler_enabled())
    with profiling.profile_trace(""):
        ran.append(torch._C._autograd._profiler_enabled())
    assert ran == [False, False]
    assert os.listdir(tmp_path) == []


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    d = tmp_path / "prof"
    with profiling.profile_trace(str(d)):
        assert torch._C._autograd._profiler_enabled()
        torch.ones(16, 16) @ torch.ones(16, 16)
    assert not torch._C._autograd._profiler_enabled()
    (name,) = os.listdir(d)
    assert name.endswith(".json")
    events = json.load(open(d / name))["traceEvents"]
    assert any(e.get("cat") == "cpu_op" and "mm" in e.get("name", "")
               for e in events)


def test_profile_dir_from_env(monkeypatch):
    monkeypatch.delenv("MMC_PROFILE_DIR", raising=False)
    assert profiling.profile_dir_from_env() is None
    monkeypatch.setenv("MMC_PROFILE_DIR", "")
    assert profiling.profile_dir_from_env() is None
    monkeypatch.setenv("MMC_PROFILE_DIR", "/x/y")
    assert profiling.profile_dir_from_env() == "/x/y"


def test_throughput_meter():
    m = profiling.ThroughputMeter()
    m.add(100)
    m.add(50)
    time.sleep(0.01)
    rate = m.seq_per_sec
    assert 0 < rate <= 150 / 0.01
    m.reset()
    assert m.seq_per_sec == 0.0


@pytest.fixture(scope="module")
def h36m_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("h36m_prof"))
    fixtures.make_h36m_corpus(d, n_frames=340, seed=3)
    return d


@pytest.fixture(scope="module")
def amass_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("amass_prof"))
    fixtures.make_amass_corpus(d, n_frames=300, seed=4)
    return d


def _traced(monkeypatch, methods):
    """Record, for each call of the Trainer ``methods``, its epoch (the
    seed, or the chunk's first epoch) and whether a profiler was on."""
    calls = []
    for name in methods:
        fn = getattr(Trainer, name)

        def rec(self, *a, _fn=fn, _name=name, **k):
            epoch = k.get("seed") if _name == "train_epoch" else a[3][0]
            calls.append((epoch, torch._C._autograd._profiler_enabled()))
            return _fn(self, *a, **k)
        monkeypatch.setattr(Trainer, name, rec)
    return calls


H36M_TINY = ["--loss_type", "mpjpe", "--dev", "cpu", "--skip_rate", "5",
             "--num_blocks", "1", "--hidden_dim", "8", "--batch_size", "1024",
             "--actions_to_consider", "walking", "--batch_size_test", "512"]


@pytest.mark.parametrize("epd,n_epochs,want", [
    (1, 2, [(0, True), (1, False)]),      # the per-epoch path: epoch 0
    (2, 4, [(0, True), (2, False)]),      # the fused path: the first chunk
])
def test_runner_traces_the_first_epoch_or_chunk(h36m_dir, tmp_path,
                                                monkeypatch, epd, n_epochs,
                                                want):
    prof = tmp_path / "prof"
    monkeypatch.setenv("MMC_PROFILE_DIR", str(prof))
    calls = _traced(monkeypatch, ["train_epoch" if epd == 1
                                  else "run_epochs_fused"])
    args = train_mixer_h36m.parse_args([
        *H36M_TINY, "--data_dir", h36m_dir, "--save_path",
        str(tmp_path / "run"), "--n_epochs", str(n_epochs),
        "--epochs_per_dispatch", str(epd)])
    args.encoder_n_harmonic_functions = 4  # a small embedding on the CPU
    _runner.run_h36m(args)
    assert calls == want
    (name,) = os.listdir(prof)
    events = json.load(open(prof / name))["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_amass_runner_traces_epoch_zero(amass_dir, tmp_path, monkeypatch):
    """run_amass runs its epochs through ``_train_and_evaluate``, so the
    per-epoch path's trace covers it: epoch 0 traced, epoch 1 not."""
    prof = tmp_path / "prof"
    monkeypatch.setenv("MMC_PROFILE_DIR", str(prof))
    calls = _traced(monkeypatch, ["train_epoch"])
    train_mixer_amass.main([
        "--dev", "cpu", "--data_dir", amass_dir,
        "--save_path", str(tmp_path / "am"), "--n_epochs", "2",
        "--skip_rate", "5", "--num_blocks", "1", "--hidden_dim", "8",
        "--channels_mlp_dim", "8", "--batch_size", "1024"])
    assert calls == [(0, True), (1, False)]
    assert len(os.listdir(prof)) == 1
    assert _runner.profile_trace is profiling.profile_trace

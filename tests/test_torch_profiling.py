"""The port's ``profiling`` module on the CPU, against the JAX package's.

The card's ceilings (NVIDIA's H100 data sheet), the physical-ceiling check
held to the JAX check's decisions on the same multiples of each package's
own ceilings (the cases of ``tests/test_bench_checks.py`` re-run against
the H100), ``profile_trace`` (a no-op for None, a parsable Chrome trace
JSON otherwise), the runners' traced first epoch or first chunk under
``MMC_PROFILE_DIR``: epoch 0 of the per-epoch path (the H36M and AMASS
runners, which share it), the first chunk of the fused path, one trace
file a run; and the program's spans: total and self time, parents per
thread, the traced and untraced buckets, the trainers' spans on the CPU
and the CLIs' per-epoch reading of them (the card's captured epoch is
``tests/test_torch_card.py``'s).
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from motionmixerconv_tpu import profiling as jax_profiling
from motionmixerconv_tpu_torch import profiling
from motionmixerconv_tpu_torch.cli import _runner
from motionmixerconv_tpu_torch.cli import train_mixer_amass, train_mixer_h36m
from motionmixerconv_tpu_torch.data import WindowedCorpus, fixtures
from motionmixerconv_tpu_torch.data.constants import H36M_DIM_USED_XYZ
from motionmixerconv_tpu_torch.models import ConvMixer
from motionmixerconv_tpu_torch.profiling import (PEAK_BYTES, PEAK_FLOPS,
                                                 PEAK_FLOPS_F32,
                                                 check_physical_ceilings,
                                                 peak_flops_for)
from motionmixerconv_tpu_torch.train import (AutoregressiveTrainer, Trainer,
                                             make_optimizer)

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


# ------------------------------------------------------------ the spans

def _untraced():
    return profiling.snapshot()["untraced"]


def test_nested_spans_total_and_self():
    """A span's self time is its total less its children's totals, exactly;
    each total holds its own sleeps."""
    profiling.reset()
    with profiling.span("outer"):
        time.sleep(0.01)
        for _ in range(2):
            with profiling.span("inner"):
                time.sleep(0.005)
    u = _untraced()
    assert u["inner"]["count"] == 2 and u["outer"]["count"] == 1
    assert u["inner"]["total_ns"] >= 10_000_000
    assert u["inner"]["self_ns"] == u["inner"]["total_ns"]
    assert u["outer"]["total_ns"] >= 20_000_000
    assert u["outer"]["self_ns"] == (u["outer"]["total_ns"]
                                     - u["inner"]["total_ns"])
    assert u["outer"]["self_ns"] >= 10_000_000


def test_parents_are_kept_per_thread():
    """A span another thread opens while this one holds a span open is not
    this span's child: the parent's self time stays its total."""
    profiling.reset()
    opened, done = threading.Event(), threading.Event()

    def other():
        opened.wait(timeout=30)
        with profiling.span("other"):
            time.sleep(0.005)
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with profiling.span("parent"):
        opened.set()
        assert done.wait(timeout=30)
    t.join(timeout=30)
    assert not t.is_alive()
    u = _untraced()
    assert u["other"]["count"] == 1
    assert u["parent"]["self_ns"] == u["parent"]["total_ns"]
    assert u["parent"]["total_ns"] >= u["other"]["total_ns"]


def test_spans_from_many_threads_lose_no_update():
    """Sixteen threads, more than the cores, each opening nested spans
    while the interpreter switches threads every microsecond: every count
    arrives, and each parent's self time is its total less its children's,
    summed over the threads."""
    profiling.reset()
    n_threads, n_spans = 16, 300
    errors = []

    def work():
        try:
            for _ in range(n_spans):
                with profiling.span("p"):
                    with profiling.span("c"):
                        pass
                    profiling.add("s", 2, 10, [("l", 2, 4)])
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors
    u = _untraced()
    n = n_threads * n_spans
    assert {k: v["count"] for k, v in u.items()} == {
        "p": n, "c": n, "s": 2 * n, "l": 2 * n}
    assert (u["s"]["total_ns"], u["s"]["self_ns"]) == (10 * n, 6 * n)
    assert u["p"]["self_ns"] == (u["p"]["total_ns"] - u["c"]["total_ns"]
                                 - u["s"]["total_ns"])


def test_spans_under_a_profiler_land_in_traced_and_on_its_timeline():
    """Under ``torch.profiler.profile`` a span goes to the traced bucket
    and is an ``mmc.`` event of the profiler's; outside it, untraced, and
    no profiler is left recording."""
    from torch.profiler import ProfilerActivity, profile

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.recording()
        with profiling.span("inside"):
            torch.ones(4) + 1
    assert not profiling.recording()
    with profiling.span("outside"):
        pass
    snap = profiling.snapshot()
    assert set(snap["traced"]) == {"inside"}
    assert set(snap["untraced"]) == {"outside"}
    assert "mmc.inside" in {e.name for e in prof.events()}
    assert "mmc.outside" not in {e.name for e in prof.events()}


def test_snapshot_is_a_copy_and_reset_clears():
    profiling.reset()
    with profiling.span("a"):
        pass
    snap = profiling.snapshot()
    assert set(snap) == {"untraced", "traced"}
    assert set(snap["untraced"]["a"]) == {"count", "total_ns", "self_ns"}
    snap["untraced"]["a"]["count"] = 99
    assert _untraced()["a"]["count"] == 1
    profiling.reset()
    assert profiling.snapshot() == {"untraced": {}, "traced": {}}


def _bucket(**spans):
    """A snapshot bucket from name=(count, total_ns, self_ns)."""
    return {k.replace("__", "."): dict(zip(("count", "total_ns", "self_ns"),
                                           v))
            for k, v in spans.items()}


def test_epoch_numbers():
    """The three numbers of the epochs' spans, and over a change since an
    earlier snapshot; None where nothing was counted."""
    now = _bucket(train__epoch=(2, 1000_000, 0), eval__pass=(2, 200_000, 0),
                  train__step=(10, 800_000, 100_000),
                  train__launch=(8, 600_000, 600_000),
                  eval__step=(4, 100_000, 0), read=(4, 60_000, 60_000))
    got = profiling.epoch_numbers(now)
    assert got["graph_launch_us"] == pytest.approx(600_000 / 8 / 1e3)
    assert got["step_host_us"] == pytest.approx(100_000 / 10 / 1e3)
    assert got["epoch_host_share"] == pytest.approx(
        (1_200_000 - 800_000 - 100_000 - 60_000) / 1_200_000 * 100)
    before = _bucket(train__epoch=(1, 400_000, 0), eval__pass=(1, 100_000, 0),
                     train__step=(5, 380_000, 60_000),
                     train__launch=(4, 300_000, 300_000),
                     eval__step=(2, 50_000, 0), read=(2, 30_000, 30_000))
    got = profiling.epoch_numbers(now, before)
    assert got["graph_launch_us"] == pytest.approx(300_000 / 4 / 1e3)
    assert got["step_host_us"] == pytest.approx(40_000 / 5 / 1e3)
    assert got["epoch_host_share"] == pytest.approx(
        (700_000 - 420_000 - 50_000 - 30_000) / 700_000 * 100)
    # eager warm-ups and captures (one-time work) leave the base
    once = dict(now, **_bucket(train__eager=(3, 150_000, 150_000),
                               capture=(1, 50_000, 50_000)))
    assert profiling.epoch_numbers(once)["epoch_host_share"] == pytest.approx(
        (1_200_000 - 800_000 - 100_000 - 60_000) / 1_000_000 * 100)
    assert profiling.epoch_numbers({}) == {
        "graph_launch_us": None, "step_host_us": None,
        "epoch_host_share": None}


TINY = dict(num_blocks=1, dimPosIn=66, dimPosEmb=8, dimPosOut=66, in_nTP=10,
            out_nTP=25, conv_nChan=1, conv1_kernel_shape=(1, 3),
            activation="mish", use_se=True, r_se=4,
            encoder_n_harmonic_functions=4)
TINY_AR = dict(TINY, out_nTP=5, conv_nChan=2, conv1_kernel_shape=(3, 3),
               regularization=-1.0, use_se=False,
               encoder_n_harmonic_functions=0)
SPAN_BATCH = 16


def _span_trainer(autoreg: bool):
    """A tiny trainer on the CPU and its frames."""
    model = ConvMixer(**(TINY_AR if autoreg else TINY),
                      generator=torch.Generator().manual_seed(2))
    common = dict(loss_type="mpjpe", dim_used=H36M_DIM_USED_XYZ, input_n=10,
                  output_n=25)
    opt = make_optimizer(model.parameters(), lr=1e-3)
    if autoreg:
        tr = AutoregressiveTrainer(model, opt, input_n_model=10,
                                   output_n_model=5, step_window=5, **common)
    else:
        tr = Trainer(model, opt, input_scale=1e-3, **common)
    frames = np.random.RandomState(5).randn(300, 96).astype(np.float32) * 300
    return tr, frames


@pytest.mark.parametrize("call", ["train_epoch", "train_epoch_ar", "validate",
                                  "evaluate_grouped", "evaluate_ar"])
def test_trainer_spans_on_the_cpu(call):
    """One call of each epoch path records its phase span, its batch
    span, one step span a batch each holding one eager child (the CPU has
    no graph: no launch, no capture) and one read; each phase's self time
    is its total less its children's."""
    tr, frames = _span_trainer(call.endswith("_ar"))
    corpus = WindowedCorpus(frames, np.arange(0, 2 * SPAN_BATCH + 5) * 3, 35)
    tframes = torch.from_numpy(frames)
    profiling.reset()
    if call == "train_epoch":
        tr.train_epoch(corpus, tframes, SPAN_BATCH, seed=1)
    elif call == "train_epoch_ar":
        tr.train_epoch_ar(corpus, tframes, SPAN_BATCH, seed=1,
                          teacher_forcing=False)
    elif call == "validate":
        tr.validate(corpus, tframes, SPAN_BATCH)
    elif call == "evaluate_grouped":
        tr.evaluate_grouped(tframes, corpus.window_starts,
                            np.arange(len(corpus)) % 3, 3, SPAN_BATCH,
                            "h36m_xyz")
    else:
        tr.evaluate_ar(corpus, tframes, SPAN_BATCH, kind="test")
    snap = profiling.snapshot()
    assert snap["traced"] == {}
    u = snap["untraced"]
    kind, phase, prep = (("train", "train.epoch", "train.batches")
                         if call.startswith("train") else
                         ("eval", "eval.pass", "eval.stack"))
    n_batches = 3
    assert {k: v["count"] for k, v in u.items()} == {
        phase: 1, prep: 1, f"{kind}.step": n_batches,
        f"{kind}.eager": n_batches, "read": 1}
    step, eager = u[f"{kind}.step"], u[f"{kind}.eager"]
    assert step["self_ns"] == step["total_ns"] - eager["total_ns"]
    assert u[phase]["self_ns"] == (u[phase]["total_ns"] - u[prep]["total_ns"]
                                   - step["total_ns"] - u["read"]["total_ns"])
    assert 0 < u[phase]["self_ns"] < u[phase]["total_ns"]


def test_run_epochs_fused_spans_on_the_cpu():
    """``run_epochs_fused``: two epochs' batches at once, their train and
    evaluation steps, and one read for the chunk; no phase span."""
    tr, frames = _span_trainer(False)
    corpus = WindowedCorpus(frames, np.arange(0, 2 * SPAN_BATCH + 5) * 3, 35)
    tframes = torch.from_numpy(frames)
    profiling.reset()
    tr.run_epochs_fused(corpus, tframes, SPAN_BATCH, [0, 1], corpus, tframes,
                        tframes, corpus.window_starts,
                        np.zeros(len(corpus), np.int64), 1, "h36m_xyz",
                        SPAN_BATCH)
    u = _untraced()
    assert {k: v["count"] for k, v in u.items()} == {
        "train.batches": 1, "train.step": 6, "train.eager": 6,
        "eval.stack": 4, "eval.step": 12, "eval.eager": 12, "read": 1}


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


@pytest.mark.parametrize("traced", [False, True])
def test_runner_logs_each_epochs_spans(h36m_dir, tmp_path, monkeypatch,
                                       traced):
    """The per-epoch path logs each epoch's ``perf/step_host_us`` and
    ``perf/epoch_host_share`` beside ``perf/epoch_s`` (no
    ``perf/graph_launch_us`` on the CPU, which replays no graph), except
    for an epoch traced under ``MMC_PROFILE_DIR``."""
    if traced:
        monkeypatch.setenv("MMC_PROFILE_DIR", str(tmp_path / "prof"))
    else:
        monkeypatch.delenv("MMC_PROFILE_DIR", raising=False)
    args = train_mixer_h36m.parse_args([
        *H36M_TINY, "--data_dir", h36m_dir, "--save_path",
        str(tmp_path / "run"), "--n_epochs", "2"])
    args.encoder_n_harmonic_functions = 4
    _runner.run_h36m(args)
    (run_dir,) = os.listdir(tmp_path / "run")
    with open(tmp_path / "run" / run_dir / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    logged = {}
    for r in rows:
        if r["tag"].startswith("perf/"):
            logged.setdefault(r["tag"], {})[r["step"]] = r["value"]
    epochs = [1] if traced else [0, 1]
    assert sorted(logged["perf/epoch_s"]) == [0, 1]
    assert "perf/graph_launch_us" not in logged
    assert sorted(logged["perf/step_host_us"]) == epochs
    assert sorted(logged["perf/epoch_host_share"]) == epochs
    assert all(v > 0 for v in logged["perf/step_host_us"].values())
    assert all(0 < v < 100 for v in logged["perf/epoch_host_share"].values())

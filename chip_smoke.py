#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py

Phases, one line each: [1] device and settings, [2] kernel build from
``motionmixerconv_tpu_torch/csrc``, [3] the fused ConvMixer core (B2)
against its plain version, 100 launches of each case bit-identical, each
launch plan checked against the library and the card's shared memory, [4] the harmonic encoder forward (B1) against its
plain version at 500, 1280 and 2560 rows, twice for bit-identity, with the
wrapper's launch plans checked against the library, [5] the flagship H36M
ConvMixer served end to end over HTTP (launch counts reset just before and
read just after), [6] serving times and B2's at 1, 7, 32 and 128 samples,
[7] the harmonic encoder backward
(B1-bwd) against its plain version, twice for bit-identity, [8] one flagship
training step with the fused encoder and with the plain one, each float32
gradient held to a float64 step of the same weights and inputs, [9] the training
CLI (``--loss_type mpjpe --fused_encoder --epochs_per_dispatch 2``, 2 epochs
at the defaults as one chunk, every step and evaluation batch a replay of a
captured CUDA graph) on a synthetic H36M corpus, B1's device launches in
that run counted from profiler traces of each of its training and
evaluation calls (at least one of each a train step), the history held to
the same run in chunks of one epoch, its checkpoint served through B2 (launch
counts reset just before and read just after), [10] training times, B1-fwd
and B1-bwd times at 500 and 2560 rows with the profiler's device time of
each of their kernels and cuBLAS's f32 products on a precomputed embedding
as yardsticks, the direct trainer's graph path held to its eager path
(``scan=False``) step by step from one init, dropout masks drawn anew by
each replay, and both paths' samples/s, step ms, kernels a step and idle
share,
[11] the multi-channel ConvMixer core (B3) against its plain version at the
autoregressive and study shapes and two wider ones that only its clusters
take, twice for bit-identity, each launch plan checked against the library,
and its times at 1, 7, 32 and 128 samples, [12] the
autoregressive training CLI (``--loss_type mpjpe --epochs_per_dispatch 2``,
one teacher-forcing and one closed-loop epoch at the default widths, a
chunk each), its history held to chunks of one epoch, its ``train_state.pt``
rebuilt and served through B3 in process and over HTTP (launch counts reset
just before and read just after) and the served latency, [13]
autoregressive training times and its teacher-forcing and closed-loop
graphs held to the eager steps, [14] the
fused MlpMixer forward (B4) against its plain version at the AMASS default,
a BatchNorm + max-pool, a channel-only, a token-only, a long-window
(activations in device scratch) and a wide shape (weights read in place),
100 launches of each case bit-identical, [15] the AMASS training CLI (2 epochs at its default
widths on a synthetic corpus as one chunk, held to chunks of one epoch),
its ``train_state.pt`` served through B4 in process and over HTTP with
``--arch auto`` (launch counts reset just before the CLI and read just after
the serving), [16] B4, serving and AMASS training times, the graph path
held to the eager one. Then one JSON line with every kernel's numbers, the card's
name and power limit, and the result line. Any failure exits non-zero; with
no CUDA device, or with the port's package missing beside this script, it
exits at once and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import shutil
import statistics
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
TOL_B2 = 1e-4    # f32, kernel and plain version sum in different orders
TOL_B1 = 1e-4    # f32, an 8448-term contraction summed in different orders
TOL_E2E = 1e-4   # kernel path against the plain nn.Module forward
# B1-bwd against its plain version, relative to the largest reference value:
# dW and db are sums over R rows, dx a sum over 64 harmonics dominated by
# f_63 ~ 9e17, all in f32 in different orders
TOL_B1_BWD = 1e-5
# one training step: the loss, fused encoder against plain, relative; each
# parameter's gradient of the fused and of the plain float32 step, each
# against a float64 step of the same weights and inputs, relative to the
# reference gradient's largest element floored at STEP_FLOOR of the tree's
# largest
TOL_STEP = 1e-4
STEP_FLOOR = 1e-2
# gradients whose exact value is 0, held instead to their own sum's
# rounding, sqrt(n) 2^-24 sum|terms| over the n upstream terms summed:
# encoder.channelUpscaling.bias (the next LayerNorm removes a uniform
# shift), a 25,000-term f32 sum of rounding noise
ROUNDING_FLOOR = ("encoder.channelUpscaling.bias",)
# graph against eager (phases 10, 13, 16): steps of each step graph, and
# the tolerances: losses and evaluations relative, parameters relative to
# each tensor's largest magnitude (the same kernels in the same order but
# for cuDNN's and index_add_'s atomics)
GRAPH_STEPS = 20
TOL_GRAPH_LOSS = 1e-5
TOL_GRAPH_PARAM = 1e-4
TOL_GRAPH_EVAL = 1e-5
TOL_EPD = 1e-4  # --epochs_per_dispatch 2 against 1, relative, per epoch
EPD2 = ["--epochs_per_dispatch", "2"]  # the training CLIs' epochs as a chunk
# B1's kernels counted in phase 9's profiler traces of the training CLI's
# own run (at least one of each a train step), and the trainer methods each
# of whose calls that run takes in a trace of its own
B1_IN_RUN = ("harmonic_dense_fwd_kernel", "harmonic_dense_bwd_dw_kernel")
TRACED_METHODS = ("_train_sums", "_eval_sums")
# the graph-against-eager trainers' schedule: a milestone half way
GRAPH_SCHEDULE = dict(milestones=[1], steps_per_epoch=GRAPH_STEPS // 2)
B1_BWD_ROWS = (500, 2560)  # a train step at batch 50; the 256-row bulk batch
B1_FWD_ROWS = (500, 1280, 2560)
B1_SHAPE = (66, 64, 50)  # the flagship encoder's D, n, E
# the kernels of a B1 call, by the names the profiler shows: the forward's
# main kernel and the sum of its harmonic groups; dW, its finishing sum (and
# db), dx and the sum of dx's groups
B1_FWD_KERNELS = ("harmonic_dense_fwd_kernel", "harmonic_dense_sum_kernel")
B1_BWD_KERNELS = ("harmonic_dense_bwd_dw_kernel",
                  "harmonic_dense_bwd_finish_kernel",
                  "harmonic_dense_bwd_dx_kernel", "harmonic_dense_sum_kernel")
TRAIN_BATCH = 50
CORPUS_FRAMES = 400  # frames per synthetic H36M sequence (~24,900 train windows)
TRAIN_ARGV = ["--loss_type", "mpjpe"]  # the training CLI at its defaults
B2_BATCHES = (1, 7, 32, 128)
B2_REPEATS = 100  # launches of each B2 case that must all equal the first
TOL_B3 = 1e-4    # f32, the convolutions' C*kh*kw-term sums in different orders
B3_BATCHES = (1, 7, 32, 128)
B3_REPEATS = 100  # launches of each B3 case that must all equal the first
# the autoregressive CLI on the card: one teacher-forcing epoch, then one
# closed-loop epoch, at the CLI's default widths
AR_ARGV = ["--loss_type", "mpjpe", "--n_epochs", "2",
           "--n_epochs_teacher_forcing", "1", "--skip_rate", "5"]
BULK_ROWS = 256
TOL_B4 = 1e-4    # f32, the MLPs' sums (up to 128 terms) in different orders
B4_BATCHES = (1, 7, 32, 128)
B4_REPEATS = 100  # launches of each B4 case that must all equal the first
# the AMASS CLI's synthetic corpus: every AMASS_SPLITS directory, 3 subjects
# x 4 recordings of 600 frames at 50 fps (~25,500 train windows at skip 1)
AMASS_CORPUS = dict(n_subjects=3, n_acts=4, n_frames=600)
AMASS_ARGV = ["--n_epochs", "2"]  # the AMASS CLI at its defaults
DEVICE = "cuda:0"  # the one card the script needs
# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores, HBM3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# the flagship: mmc-serve's defaults (bench.py's H36M ConvMixer shape)
FLAGSHIP = dict(
    num_blocks=4, dimPosIn=66, dimPosEmb=50, dimPosOut=66, in_nTP=10,
    out_nTP=25, conv_nChan=1, conv1_kernel_shape=(1, 3), conv1_stride=(1, 1),
    conv1_padding=(0, 1), mode_conv="twice", activation="mish",
    regularization=0.1, use_se=True, r_se=8, encoder_n_harmonic_functions=64,
    encoder_omega0=0.1)

# the autoregressive CLI's default model (train_autoreg_mixer_h36m.py mpjpe
# defaults, bench.py:112-119) and the ConvMixer study's fixed shape
# (bench.py:120-126); both serve through B3
AUTOREG = dict(
    num_blocks=4, dimPosIn=66, dimPosEmb=192, dimPosOut=66, in_nTP=10,
    out_nTP=5, conv_nChan=8, conv1_kernel_shape=(5, 5), conv1_stride=(1, 1),
    conv1_padding=None, mode_conv="twice", activation="mish",
    regularization=-1.0, use_se=True, r_se=8, use_max_pooling=False,
    encoder_n_harmonic_functions=0, encoder_omega0=0.1)
STUDY = dict(AUTOREG, num_blocks=6, out_nTP=10, conv1_kernel_shape=(5, 9),
             mode_conv="once", activation="gelu", regularization=0.1)
# widths whose planes outgrow one block's shared memory: B3 takes them as
# clusters of blocks, each holding a slice of the columns
B3_WIDE = {"conv_nChan 8 dimPosEmb 256": dict(AUTOREG, dimPosEmb=256),
           "conv_nChan 12 dimPosEmb 192": dict(AUTOREG, conv_nChan=12)}

# the AMASS CLI's default MlpMixer (train_mixer_amass.py, bench.py's AMASS
# shape) and the variants B4 takes
AMASS_MLP = dict(
    num_classes=54, num_blocks=5, hidden_dim=128, tokens_mlp_dim=20,
    channels_mlp_dim=128, seq_len=10, pred_len=25, activation="gelu",
    regularization=0.1, input_size=54, r_se=8, use_se=True)
B4_SHAPES = {
    "amass": (AMASS_MLP, B4_BATCHES),
    "bn+maxpool": (dict(AMASS_MLP, regularization=-1.0, use_max_pooling=True,
                        activation="mish"), B4_BATCHES),
    "channel_only": (dict(AMASS_MLP, mlp_block_type="channel_only"),
                     B4_BATCHES),
    "token_only": (dict(AMASS_MLP, mlp_block_type="token_only"), B4_BATCHES),
    # activations beyond one block's shared memory: the scratch path
    "long_window": (dict(AMASS_MLP, seq_len=240, pred_len=60, num_blocks=2),
                    (1, 7)),
    # a matrix beyond the shared weight buffer: weights read in place
    "wide": (dict(AMASS_MLP, hidden_dim=300, channels_mlp_dim=260,
                  num_blocks=1), (1, 7)),
}


def warm_batchnorm(torch, model, gen):
    """``model`` with random BatchNorm affines and running stats, so that the
    folded inference affine is not the identity."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.2, 0.2, generator=gen)
                m.running_mean.uniform_(-0.5, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return model


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 50, trials: int = 7) -> float:
    """Median over trials of the CUDA-event time per call of ``fn``."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def queued_ms(torch, fn, reps: int = 50, trials: int = 7) -> float:
    """Median over trials of the CUDA-event time per call of ``fn``, with
    the calls enqueued while the stream is held by a spin kernel: the
    events then time the launches back to back on the device, not the
    host's pace of enqueueing them (which bounds ``cuda_ms`` for a kernel
    shorter than its Python call)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(reps * 200_000)  # ~0.1 ms a call to enqueue it
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_ms(torch, fn, reps: int = 50) -> float:
    """Host time per call to enqueue ``fn`` (no synchronisation inside)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def host_median_ms(fn, reps: int = 30) -> float:
    """Median host-clock time of ``fn``, which ends in a host copy."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def device_us(torch, fn, kernel: str, reps: int = 20):
    """Mean device time per launch (microseconds) of the kernel whose name
    holds ``kernel``, from a torch.profiler trace of ``reps`` calls of
    ``fn``; None where the trace shows no device time for it."""
    from torch.profiler import ProfilerActivity, profile

    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace that misses the kernel is taken again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and kernel in e.name]
        if times and sum(times) > 0:
            return sum(times) / len(times)
    return None


def profile_train(torch, run, steps: int, batch: int) -> dict:
    """Times of a trainer's steps: ``run(lo, hi)`` runs steps lo..hi-1 as
    one slice of an epoch and ends in a host read. The first ``steps``
    warm it up (eager warm-up calls and the capture on the graph path);
    the host clock times the next ``steps`` (step ms, samples/s); a
    torch.profiler trace of ``steps`` more gives the device kernels per
    step, their device time per step, the device's idle share and the
    kernels that take most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run(0, steps)
    t0 = time.perf_counter()
    run(steps, 2 * steps)
    host_ms = (time.perf_counter() - t0) / steps * 1e3
    out = {"step_ms": host_ms, "samples_per_s": batch / host_ms * 1e3}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(2 * steps, 3 * steps)
        wall_us = (time.perf_counter() - t0) * 1e6
    # device events, less the user-annotation ranges (e.g. Optimizer.step)
    # that the profiler also draws on the device timeline
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us = sum(by_name.values())
    out.update(profiled_ms=wall_us / steps / 1e3,
               kernels=len(kernels) / steps,
               busy_ms=busy_us / steps / 1e3 if kernels else None,
               idle=1 - busy_us / wall_us if kernels else None,
               top=[(n, us / steps) for n, us in
                    sorted(by_name.items(), key=lambda kv: -kv[1])[:5]])
    return out


def train_times(torch, trainer, frames, starts, w, teacher_forcing,
                steps: int = 20) -> dict:
    """``profile_train`` of ``trainer`` on (3 steps, B) ``starts``/``w``,
    on the graph path (scan=True) and op by op (scan=False); on the graph
    path also the host ms to enqueue one replay of the captured step."""
    batch = starts.shape[1]
    times = {scan: profile_train(
        torch, lambda lo, hi: trainer._train_sums(
            frames, starts[lo:hi], w[lo:hi], teacher_forcing, scan).cpu(),
        steps, batch) for scan in (True, False)}
    graph = next(r.graph for k, r in trainer._graphs.items()
                 if k[:2] == ("train", teacher_forcing))
    times[True]["replay_ms"] = host_ms(torch, graph.replay, reps=steps)
    return times


def fmt_times(times: dict) -> str:
    parts = []
    for scan, t in times.items():
        dev = ("device time not measured" if t["busy_ms"] is None else
               f"{t['kernels']:.0f} kernels/step, device busy "
               f"{t['busy_ms']:.3f} ms/step, idle share {t['idle']:.3f}; top "
               + "; ".join(f"{n[:50]} {us:.1f} us" for n, us in t["top"]))
        replay = (f", the host's enqueue of one replay {t['replay_ms']:.3f} ms"
                  if "replay_ms" in t else "")
        parts.append(f"{'graph' if scan else 'eager (scan=False)'}: "
                     f"{t['samples_per_s']:.1f} samples/s, step "
                     f"{t['step_ms']:.3f} ms (profiled {t['profiled_ms']:.3f})"
                     f"{replay}, {dev}")
    return " | ".join(parts)


def random_batches(torch, dev, seed: int, rows: int, width: int,
                   scale: float, seq_len: int, steps: int, batch: int):
    """A random (rows, width) corpus on the card and (steps, batch) window
    starts into it with unit weights."""
    gen = torch.Generator().manual_seed(seed)
    frames = (torch.randn(rows, width, generator=gen) * scale).to(dev)
    starts = torch.randint(0, rows - seq_len, (steps, batch),
                           generator=gen).to(dev)
    return frames, starts, torch.ones(steps, batch, device=dev)


def graph_vs_eager(torch, make_trainer, frames, starts, w, phases, evals):
    """Two trainers from one seeded init (``make_trainer()``), one stepping
    op by op (scan=False), one replaying its captured steps (scan=True; its
    first WARMUP_CALLS steps of each graph are the eager warm-up): for each
    teacher-forcing flag of ``phases`` GRAPH_STEPS steps on the same
    batches, every step's loss kept on the device; then each evaluation
    ``(kind, n_groups, frames, window_starts, group_ids, batch)`` of
    ``evals``. Both under deterministic cuDNN, whose atomics would let two
    eager runs drift apart too. Returns {max relative loss error, max
    parameter error over its tensor's largest magnitude (and which), max
    relative evaluation error, bit for bit}."""
    import numpy as np

    runs = {}
    torch.backends.cudnn.deterministic = True  # both paths, one sum order
    for scan in (False, True):
        tr = make_trainer()
        sums = [tr._train_sums(frames, starts[i:i + 1], w[i:i + 1], tf, scan)
                for tf in phases for i in range(GRAPH_STEPS)]
        ev = [np.stack(tr.evaluate_grouped(f, s, g, ng, bs, kind, scan))
              for kind, ng, f, s, g, bs in evals]
        sums = torch.stack(sums).cpu().double()
        runs[scan] = (sums[:, 0] / sums[:, 1],
                      {k: p.detach().clone()
                       for k, p in tr.model.named_parameters()},
                      [e.astype(np.float64) for e in ev])
    torch.backends.cudnn.deterministic = False
    (le, pe, ee), (lg, pg, eg) = runs[False], runs[True]
    loss_err = float(((lg - le).abs() / le.abs()).max())
    param_errs = {k: float((pg[k] - pe[k]).abs().max())
                  / max(float(pe[k].abs().max()), 1e-30) for k in pe}
    worst = max(param_errs, key=param_errs.get)
    eval_err = max(float(np.max(np.abs(b - a) / np.maximum(np.abs(a), 1e-30)))
                   for a, b in zip(ee, eg))
    bits = (torch.equal(lg, le) and all(torch.equal(pg[k], pe[k]) for k in pe)
            and all(np.array_equal(a, b) for a, b in zip(ee, eg)))
    return {"steps": len(le), "loss": loss_err, "param": param_errs[worst],
            "worst": worst, "eval": eval_err, "bit_for_bit": bits,
            "losses": [float(v) for v in lg[:: GRAPH_STEPS // 2]]}


def epd_rel(hist: dict, ref: dict) -> float:
    """Max relative difference of two CLI histories' per-epoch train, val
    and test losses and test metrics."""
    import numpy as np

    keys = [(k,) for k in ("train", "val", "test")] + [
        ("metrics", k) for k in hist["metrics"]]
    err = 0.0
    for key in keys:
        a, b = hist, ref
        for k in key:
            a, b = a[k], b[k]
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        err = max(err, float(np.max(np.abs(a - b) / np.abs(b))))
    return err


def epd_check(torch, main, argv, save_root) -> tuple:
    """The training CLI ``main`` on ``argv`` twice under deterministic
    cuDNN, with --epochs_per_dispatch 2 and with 1 (cuDNN's atomics would
    let two runs of either drift apart over a thousand steps): the max
    relative difference of their per-epoch histories and the two
    histories."""
    torch.backends.cudnn.deterministic = True
    try:
        hists = [main([*argv, *extra, "--save_path", str(save_root / tag)])
                 for tag, extra in (("epd2", EPD2), ("epd1", []))]
    finally:
        torch.backends.cudnn.deterministic = False
    return epd_rel(*hists), hists[0], hists[1]


def check_graph(name: str, res: dict) -> None:
    if not (res["loss"] <= TOL_GRAPH_LOSS and res["param"] <= TOL_GRAPH_PARAM
            and res["eval"] <= TOL_GRAPH_EVAL):
        fail(f"{name}: graph and eager disagree: {res}")


def fmt_graph(res: dict) -> str:
    return (f"{res['steps']} steps, loss rel {res['loss']:.3e} (tol "
            f"{TOL_GRAPH_LOSS:g}), parameters {res['param']:.3e} of each "
            f"tensor's max ({res['worst']}; tol {TOL_GRAPH_PARAM:g}), "
            f"evaluations rel "
            f"{res['eval']:.3e} (tol {TOL_GRAPH_EVAL:g}), bit for bit "
            f"{res['bit_for_bit']}")


def dropout_replays(torch, dev, model) -> tuple:
    """Two replays of a captured training-mode forward of ``model`` on one
    input: (share of outputs that differ with dropout on, the same with
    the model in eval mode, where none may)."""
    from motionmixerconv_tpu_torch.train.graphs import WARMUP_CALLS

    x = (torch.randn(TRAIN_BATCH, 10, 66,
                     generator=torch.Generator().manual_seed(SEED + 12))
         * 0.3).to(dev)
    shares = []
    for train in (True, False):
        model.train(train)
        with torch.no_grad():
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(WARMUP_CALLS):
                    model(x)
            torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = model(x)
            graph.replay()
            first = out.clone()
            graph.replay()
            shares.append(float((first != out).float().mean()))
    return tuple(shares)


def profiled_launches(torch, run, names) -> tuple:
    """(``run()``'s result, the device launches of each kernel named in
    ``names`` (by substring) in a torch.profiler trace of ``run()``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    events = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    return out, {n: sum(n in e for e in events) for n in names}


@contextlib.contextmanager
def traced_launches(torch, cls, methods, names):
    """Yields {method: {kernel: device launches}}, the launches of each
    kernel named in ``names`` (by substring) made by the calls of each of
    ``cls``'s ``methods`` while the context is open. Every call is taken in
    a torch.profiler trace of its own: one trace of a whole training run
    (~500 kernels a step, ~1,000 steps) would outgrow the profiler's device
    buffers. Replays of a CUDA graph show each of the graph's kernels in
    the trace, which the launch counters of the Python wrappers cannot."""
    counts = {m: dict.fromkeys(names, 0) for m in methods}
    saved = {m: getattr(cls, m) for m in methods}

    def traced(m, fn):
        def call(*a, **k):
            out, got = profiled_launches(torch, lambda: fn(*a, **k), names)
            for n, c in got.items():
                counts[m][n] += c
            return out
        return call

    for m, fn in saved.items():
        setattr(cls, m, traced(m, fn))
    try:
        yield counts
    finally:
        for m, fn in saved.items():
            setattr(cls, m, fn)


def step_grads(torch, model, x, target):
    """Loss and gradients of one phase-8 training step of ``model`` on
    input ``x``; with the sums of |upstream gradient| of
    ``encoder.channelUpscaling``'s output per channel (float64) and the
    terms each sums, captured by a tensor hook."""
    up = {}

    def capture(g):
        g64 = g.detach().double()
        up["abs_sum"] = g64.abs().sum(dim=tuple(range(g.dim() - 1)))
        up["n"] = g.numel() // g.shape[-1]

    def on_output(mod, inp, out):
        out.register_hook(capture)

    hook = model.encoder.channelUpscaling.register_forward_hook(on_output)
    try:
        pred = model(x)
        diff = (target - pred).reshape(target.shape[0], -1, 3)
        loss = torch.linalg.norm(diff, dim=-1).mean()
        loss.backward()
    finally:
        hook.remove()
    return (float(loss.detach()),
            {k: p.grad for k, p in model.named_parameters()}, up)


def step_check(torch, dev, model_seed: int, data_seed: int, fused_models,
               harmonic=None):
    """Phase 8: one flagship training step (batch TRAIN_BATCH, dropout off)
    of the plain float32 model and of each fused-encoder model of
    ``fused_models`` (name -> ConvMixer class), every one from the same
    weights and inputs, and a float64 reference step: the plain model in
    double precision fed the harmonic features of the float32 arguments
    (fl32(x f_i), which both float32 paths take the sine and cosine of;
    above harmonic ~17 a float64 argument would differ by whole radians).
    Each float32 gradient is held to the reference on its own: within
    TOL_STEP of max(max|reference|, STEP_FLOOR x the tree's largest), or
    for a gradient of ROUNDING_FLOOR within sqrt(n) 2^-24 sum|terms| of its
    own sum. Returns {run: (loss, launches (fwd, bwd), {parameter: (error,
    bound)})} with the reference's loss under "float64"; with ``harmonic``
    (the ops module) the B1 launches of each run are counted."""
    from motionmixerconv_tpu_torch.models import ConvMixer

    cfg = dict(FLAGSHIP, regularization=0.0)  # dropout off
    plain = ConvMixer(**cfg, generator=torch.Generator().manual_seed(model_seed))
    state = plain.state_dict()
    gs = torch.Generator().manual_seed(data_seed)
    seq = (torch.randn(TRAIN_BATCH, 35, 66, generator=gs) * 300.0).to(dev)
    x, target = seq[:, :10] * 1e-3, seq[:, 10:]
    ref = ConvMixer(**cfg, encoder_precomputed=True)
    ref.load_state_dict(state, strict=True)
    ref = ref.to(dev).double().train()
    freqs = plain.encoder.frequencies.to(dev)
    args = (x[..., None] * freqs).reshape(*x.shape[:-1], -1).double()
    feats = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    loss64, g64, _ = step_grads(torch, ref, feats, target.double())
    tree_max = max(float(g.abs().max()) for g in g64.values())
    runs = {"plain": plain.to(dev).train()}
    for name, cls in fused_models.items():
        m = cls(**cfg, encoder_fused=True)
        m.load_state_dict(state, strict=True)
        runs[name] = m.to(dev).train()
    out = {"float64": (loss64, None, None)}
    for name, m in runs.items():
        counts = ((harmonic.LAUNCHES.value, harmonic.LAUNCHES_BWD.value)
                  if harmonic is not None else (0, 0))
        loss, grads, up = step_grads(torch, m, x, target)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        launches = ((harmonic.LAUNCHES.value - counts[0],
                     harmonic.LAUNCHES_BWD.value - counts[1])
                    if harmonic is not None else None)
        checks = {}
        for k, g in grads.items():
            ref_g = g64[k]
            err = (g.double() - ref_g).abs()
            if k in ROUNDING_FLOOR:
                bound = (up["n"] ** 0.5 * 2.0 ** -24 * up["abs_sum"]).reshape(
                    ref_g.shape)
                checks[k] = (float((err / bound).max()), 1.0)
            else:
                scale = max(float(ref_g.abs().max()), STEP_FLOOR * tree_max)
                checks[k] = (float(err.max()) / scale, TOL_STEP)
        out[name] = (loss, launches, checks)
    return out


def in_plane_taps(n: int, k: int) -> int:
    """Taps of a width-``k`` 'same' stencil (torch's padding: floor((k-1)/2)
    on the left) that fall inside the ``n`` positions, summed over the
    outputs. Taps on the zero padding need no multiply-add."""
    left = (k - 1) // 2
    return sum(min(n, i - left + k) - max(0, i - left) for i in range(n))


def conv_taps(spec, k) -> int:
    """In-plane multiply-adds of one (kh, kw) 'same' stencil over a (T, E)
    plane, for one input and one output channel."""
    return in_plane_taps(spec.T, k[0]) * in_plane_taps(spec.E, k[1])


def b2_work(spec, batch: int, n_weights: int):
    """(bytes, operations) the fused ConvMixer core needs for ``batch``
    samples: each input, weight and output element moved once; every
    multiply, add, comparison and transcendental counted as one operation
    (stencil taps on the zero padding not counted)."""
    T, E, P, D, H = spec.T, spec.E, spec.P, spec.D, spec.H
    te = T * E

    def branch(k):
        ops = 7 * te                      # LayerNorm
        ops += 2 * conv_taps(spec, k) + te  # stencil + bias
        ops += 8 * te + 2 * te            # mish or GELU, BN affine
        if spec.use_se:
            ops += te + 4 * T * H + 4 * T + te  # squeeze, fc1/fc2, sigmoid, gate
        return ops + te                   # residual

    per_block = branch(spec.k1) + (branch(spec.k2) if spec.twice else
                                   (2 * te + 4 * T * H + 4 * T if spec.use_se else te))
    decoder = 7 * te + 2 * T * P * E + P * E + 2 * P * E + 8 * P * E \
        + 2 * P * E * D + P * D
    ops = batch * (spec.num_blocks * per_block + decoder)
    nbytes = 4 * (batch * T * E + n_weights + batch * P * D)
    return nbytes, ops


def b3_work(spec, batch: int, n_weights: int):
    """(bytes, operations) the fused multi-channel ConvMixer core needs for
    ``batch`` samples: each input, weight and output element moved once;
    every multiply, add, comparison and transcendental counted as one
    operation. The convolutions dominate: 2 * C * C multiply-adds per
    in-plane tap (taps on the zero padding not counted)."""
    C, T, E, P, D, H = spec.C, spec.T, spec.E, spec.P, spec.D, spec.H
    n = C * T * E

    def se_and_residual():
        ops = (2 * n + 4 * T * H + 4 * T) if spec.use_se else 0
        return ops + n

    def branch(k):
        ops = 7 * n                              # LayerNorm
        ops += 2 * C * C * conv_taps(spec, k) + n  # the C x C conv, bias
        ops += 8 * n + 2 * n                  # mish or GELU, BN affine
        return ops + se_and_residual()

    per_block = branch(spec.k1) + (branch(spec.k2) if spec.twice
                                   else se_and_residual())
    decoder = 7 * n + 2 * C * T * P * E + C * P * E + 2 * C * P * E \
        + P * E + 8 * P * E + 2 * P * E * D + P * D
    ops = batch * (spec.num_blocks * per_block + decoder)
    nbytes = 4 * (batch * n + n_weights + batch * P * D)
    return nbytes, ops


def model_floats(model) -> int:
    """Floats of a model's own state: its parameters and floating-point
    buffers (BatchNorm's running statistics). The packed buffer B4 reads is
    larger (its BatchNorm fold planes are (T, H) per block), but the
    function needs only these."""
    return sum(t.numel() for t in (*model.parameters(), *model.buffers())
               if t.is_floating_point())


def b4_launch(spec, b):
    """B4's launch for b samples: one 512-thread block a sample
    (csrc/mlp_mixer_fused.cu kThreads), with the placements the wrapper
    chose for the shape."""
    wbuf, nbuf = spec.wbuf_floats(), spec.nbufs()
    return (f"{b} blocks x 512 thr, activations in "
            f"{'scratch' if spec.uses_scratch else 'shared memory'}, weights "
            + (f"copied by TMA into {nbuf} buffer(s) of {wbuf} floats"
               if nbuf else "read in place")
            + f", {spec.smem_bytes()} B smem")


def b4_work(spec, batch: int, n_weights: int):
    """(bytes, operations) the fused MlpMixer forward needs for ``batch``
    samples, ``n_weights`` being the model's own floats (``model_floats``):
    each input, weight and output element moved once; a
    multiply-add counted as two operations, every other multiply, add,
    comparison and transcendental as one (LayerNorm 7 a value, GELU or mish
    8, as ``b2_work``)."""
    T, D, H, P, NC, S = spec.T, spec.D, spec.H, spec.P, spec.NC, spec.S
    tok, ch, th = spec.tok, spec.ch, spec.T * spec.H
    se = (2 * th + 4 * T * S + 4 * T) if spec.use_se else 0  # squeeze, fcs, gate
    per_block = 0
    if spec.has_tok:
        per_block += (7 * th + 2 * H * T * tok + 9 * H * tok  # LN, fc1, bias+act
                      + 2 * H * tok * T + 2 * th + se + th)   # fc2, fold, SE, res
    else:
        per_block += se + th  # the channel-only block's x + se(x)
    if spec.has_ch:
        per_block += (7 * th + 2 * T * H * ch + 9 * T * ch
                      + 2 * T * ch * H + 2 * th + se + th)
    else:
        per_block += th  # the token-only block's second residual
    embed = 2 * T * D * H + th
    head = 7 * th + 2 * H * T * P + P * H + 2 * P * H * NC + P * NC
    ops = batch * (embed + spec.num_blocks * per_block + head)
    nbytes = 4 * (batch * T * D + n_weights + batch * P * NC)
    return nbytes, ops


def b1_work(rows: int, d: int, n: int, e: int, impl: str):
    """(bytes, operations) of the fused harmonic forward for ``rows`` rows."""
    nbytes = 4 * (rows * d + 2 * n * d * e + e + n + rows * e)
    ops = 2 * rows * (2 * n * d) * e + rows * e  # the contraction, the bias
    if impl == "direct":
        ops += rows * d * n * 3                  # angle, sin, cos
    else:
        ops += rows * d * 3 + rows * d * (n - 1) * 9  # one sin/cos, doubling steps
    return nbytes, ops


def b1_bwd_work(rows: int, d: int, n: int, e: int, impl: str, with_dx: bool):
    """(bytes, operations) of the fused harmonic backward for ``rows`` rows:
    dW and db always, dx when asked; each harmonic's features counted once."""
    nbytes = 4 * (rows * d + rows * e + n + 2 * n * d * e + e)
    ops = 2 * rows * (2 * n * d) * e + rows * e  # dW = feat^T g, db
    if impl == "direct":
        ops += rows * d * n * 3                  # angle, sin, cos
    else:
        ops += rows * d * 3 + rows * d * (n - 1) * 9
    if with_dx:
        nbytes += 4 * (2 * n * d * e + rows * d)  # the weight in, dx out
        ops += 2 * rows * (2 * n * d) * e         # g Ws^T, g Wc^T
        ops += rows * d * n * 5                   # f (c gs - s gc), summed
    return nbytes, ops


def check_b1_plans(lib, harmonic, torch) -> str:
    """Fail unless the library's B1 tiles and shared memory agree with the
    wrapper's launch plans (``ops/harmonic.py``) at the flagship shape and
    the rows phases 4, 7 and 10 use, and unless as many blocks fit an SM as
    the plans count on; returns the plans in brief."""
    d, n, e = B1_SHAPE
    consts = {"fwd_rows": harmonic.FWD_ROWS,
              "fwd_max_cols": harmonic.FWD_MAX_COLS,
              "dw_rows": harmonic.DW_ROWS,
              "dx_rows": harmonic.DX_ROWS}
    for k, v in consts.items():
        if getattr(lib, f"mmc_harmonic_{k}")() != v:
            fail(f"B1: the library's {k} is not the wrapper's {v}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for rows in sorted({*B1_FWD_ROWS, *B1_BWD_ROWS}):
        fp = harmonic.fwd_plan(rows, d, e, n, sms)
        bp = harmonic.bwd_plan(rows, d, e, n, True, sms)
        resident = (lib.mmc_harmonic_resident_blocks(0, fp.threads, fp.smem),
                    lib.mmc_harmonic_resident_blocks(1, bp.threads, bp.smem))
        if resident[0] < fp.blocks_per_sm or resident[1] < bp.blocks_per_sm:
            fail(f"B1 R={rows}: {resident} blocks fit an SM, the plans count "
                 f"on {(fp.blocks_per_sm, bp.blocks_per_sm)}")
        if (lib.mmc_harmonic_fwd_smem_bytes(d, fp.cols),
                lib.mmc_harmonic_dw_smem_bytes(d, bp.cols),
                lib.mmc_harmonic_finish_smem_bytes(e, n),
                lib.mmc_harmonic_dx_smem_bytes(d, e, bp.dx_ld)) != (
                fp.smem, bp.smem, bp.finish_smem, bp.dx_smem):
            fail(f"B1 R={rows}: the library's shared memory disagrees with "
                 "ops/harmonic.py's plans")
        out.append(f"R={rows} fwd {fp.blocks} blocks ({fp.groups} groups of "
                   f"{fp.hg}) x {fp.threads} thr, dW {bp.blocks} blocks "
                   f"({bp.chunks} chunks of {bp.chunk_rows} rows) x "
                   f"{bp.threads} thr, dx {bp.dx_blocks} blocks "
                   f"({bp.dx_groups} groups of {bp.dx_hg}); resident per SM "
                   f"fwd {resident[0]}, dW {resident[1]}")
    return f"{sms} SMs; " + " ; ".join(out)


def bound(nbytes: int, ops: int):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tf32_flags(torch) -> str:
    return (f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
            f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")


def post(base: str, path: str, payload: dict) -> dict:
    req = urllib.request.Request(
        f"{base}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def main() -> None:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    sys.path.insert(0, str(ROOT))
    try:
        import motionmixerconv_tpu_torch as pkg
    except ImportError as e:
        fail(f"the port's package is not beside this script: {e}")
    if Path(pkg.__file__).resolve().parent.parent != ROOT:
        fail(f"imported the port from {pkg.__file__}, not from {ROOT}")
    from motionmixerconv_tpu_torch.models import ConvMixer, MlpMixer
    from motionmixerconv_tpu_torch.ops import (_build, conv_mixer, conv_mixer_mc,
                                               harmonic, mlp_mixer)
    from motionmixerconv_tpu_torch.serving import Predictor
    from motionmixerconv_tpu_torch.serving_server import PredictionServer

    # [1] device and settings
    card = card_line()
    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)
    say(f"[1 device] {card} | torch.cuda.get_device_name(0)="
        f"{torch.cuda.get_device_name(0)} | device_count="
        f"{torch.cuda.device_count()} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {tf32_flags(torch)} (PyTorch's defaults; the "
        "port's Predictor pins both off, checked in phase 5)")

    # [2] build every kernel from the sources in this checkout
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    ptxas = [ln.split(":", 1)[1].strip() for ln in _build.build_log.splitlines()
             if "Used" in ln and "registers" in ln]
    say(f"[2 build] {build_s:.2f} s ({'built' if _build.build_log else 'cached'})"
        f" | ptxas: {' ; '.join(ptxas) or 'n/a'}")

    # [3] B2 against its plain version at the flagship shape and the
    # bn+maxpool+once model, B2_REPEATS launches of each case bit-identical;
    # each case's launch plan against the library and the card's shared
    # memory
    lib = _build.load_library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card_smem = lib.mmc_conv_mixer_card_smem()
    gen = torch.Generator().manual_seed(SEED)
    flag = ConvMixer(**FLAGSHIP, generator=gen).eval().to(dev)
    x_all = (torch.randn(BULK_ROWS, 10, 66, generator=gen) * 0.5).to(dev)
    bn_cfg = dict(FLAGSHIP, regularization=-1.0, use_max_pooling=True,
                  mode_conv="once")
    bn_model = warm_batchnorm(torch, ConvMixer(**bn_cfg, generator=gen).eval(),
                              gen).to(dev)
    b2_err = 0.0
    parts, b2_plans = [], []
    with torch.no_grad():
        for tag, model, batches in (("flagship", flag, B2_BATCHES),
                                    ("bn+maxpool+once", bn_model, (7, 128))):
            fused = conv_mixer.make_fused_conv_mixer(model)
            spec = fused.spec
            dims = (spec.T, spec.E, spec.P, spec.D, spec.H, spec.num_blocks,
                    *spec.k1, *spec.k2)
            if lib.mmc_conv_mixer_weights_numel(*dims) != spec.numel():
                fail(f"B2 {tag}: the kernel's weight layout disagrees with "
                     "ops/conv_mixer.py")
            y_all = fused.encoder(x_all[:128])[..., 0].contiguous()
            for b in batches:
                plan = conv_mixer.b2_plan(spec, b)
                fit = lib.mmc_conv_mixer_resident_blocks(plan.threads, plan.smem)
                lib_smem = lib.mmc_conv_mixer_smem_bytes(*dims)
                if lib_smem != plan.smem or not plan.smem <= card_smem \
                        or fit < 1:
                    fail(f"B2 {tag} B={b}: {plan} against the library's "
                         f"{lib_smem} B, the card's {card_smem} B, {fit} "
                         "resident")
                b2_plans.append(f"{tag} B={b} {plan.blocks} blocks x "
                                f"{plan.warps} warps, {plan.smem} B smem, "
                                f"{fit} resident")
                y = y_all[:b].contiguous()
                got = conv_mixer.conv_mixer_fused(y, fused.weights, spec)
                again = [conv_mixer.conv_mixer_fused(y, fused.weights, spec)
                         for _ in range(B2_REPEATS - 1)]
                want = conv_mixer.conv_mixer_plain(y, fused.weights, spec)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    fail(f"B2 {tag} B={b}: non-finite output")
                differ = sum(not torch.equal(got, a) for a in again)
                if differ:
                    fail(f"B2 {tag} B={b} {plan}: {differ} of "
                         f"{B2_REPEATS - 1} launches differ from the first")
                err = float((got - want).abs().max())
                b2_err = max(b2_err, err)
                parts.append(f"{tag} B={b} {err:.3e}")
    say(f"[3 B2 conv_mixer_fused vs plain] max_abs_err {b2_err:.3e} "
        f"(tol {TOL_B2:g}), {B2_REPEATS} launches of each case "
        "bit-identical | " + " ; ".join(parts) + f" | {sms} SMs, the card's "
        f"shared memory a block {card_smem} B; plans (library agrees): "
        + " ; ".join(b2_plans))
    if not b2_err <= TOL_B2:
        fail(f"B2 disagrees with its plain version: {b2_err:.3e} > {TOL_B2:g}")

    # [4] B1 forward against its plain version at the training step's rows,
    # 1280 and the bulk 2560 rows, twice for bit-identity (the groups'
    # partial sums are added in a fixed order); the wrapper's launch plans
    # against the library's tiles and shared memory
    plans = check_b1_plans(_build.load_library(), harmonic, torch)
    enc = flag.encoder
    w, bias, freqs = enc.embed_mlp.weight.detach(), enc.embed_mlp.bias.detach(), \
        enc.frequencies
    wi = enc.kernel_weight()  # the i-major weight the fused encoder keeps
    b1_err = 0.0
    parts = []
    with torch.no_grad():
        for impl in harmonic.IMPLS:
            for rows in B1_FWD_ROWS:
                x2d = x_all.reshape(-1, 66)[:rows].contiguous()
                got = harmonic.harmonic_dense_fwd(x2d, w, bias, freqs, impl, wi)
                again = harmonic.harmonic_dense_fwd(x2d, w, bias, freqs, impl, wi)
                want = harmonic.harmonic_dense_plain(x2d, w, bias, freqs, impl)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    fail(f"B1 {impl} R={rows}: non-finite output")
                if not torch.equal(got, again):
                    fail(f"B1 {impl} R={rows}: two launches differ")
                err = float((got - want).abs().max())
                b1_err = max(b1_err, err)
                parts.append(f"{impl} R={rows} {err:.3e}")
    say(f"[4 B1 harmonic_dense_fwd vs plain] max_abs_err {b1_err:.3e} "
        f"(tol {TOL_B1:g}); second launch bit-identical | " + " ; ".join(parts)
        + f" | launch plans (library agrees): {plans}")
    if not b1_err <= TOL_B1:
        fail(f"B1 disagrees with its plain version: {b1_err:.3e} > {TOL_B1:g}")

    # [5] the main path: a .pt checkpoint served over HTTP on the card
    ckpt = ROOT / "build" / "chip_smoke" / "flagship.pt"
    ckpt.parent.mkdir(parents=True, exist_ok=True)
    torch.save(ConvMixer(**FLAGSHIP, generator=torch.Generator().manual_seed(SEED + 1))
               .state_dict(), ckpt)
    predictor = Predictor.from_checkpoint(ConvMixer(**FLAGSHIP), str(ckpt),
                                          device=dev)
    bulk = Predictor.from_checkpoint(ConvMixer(**FLAGSHIP, encoder_fused=True),
                                     str(ckpt), device=dev)
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        fail(f"the port left TF32 on for its plain forward: {tf32_flags(torch)}")
    server = PredictionServer(predictor, port=0, warmup=True)
    server.start_background()
    base = f"http://127.0.0.1:{server.port}"
    rs = torch.Generator().manual_seed(SEED + 2)
    reqs = {b: torch.randn(b, 10, 66, generator=rs) * 0.5 for b in (1, 5, 32)}
    x_bulk = torch.randn(BULK_ROWS, 10, 66, generator=rs) * 0.5
    plain = predictor.model  # the loaded nn.Module, plain forward

    for c in (conv_mixer.LAUNCHES, harmonic.LAUNCHES):
        c.reset()
    answers = {b: post(base, "/predict", {"inputs": x.tolist()})["outputs"]
               for b, x in reqs.items()}
    rollout = post(base, "/predict_autoregressive",
                   {"inputs": reqs[5].tolist(), "horizon": 12})["outputs"]
    bulk_out = bulk.predict(x_bulk)
    torch.cuda.synchronize()
    launches = {"conv_mixer_fused": conv_mixer.LAUNCHES.value,
                "harmonic_dense_fwd": harmonic.LAUNCHES.value}

    with torch.no_grad():
        e2e = []
        for b, x in reqs.items():
            got = torch.tensor(answers[b], dtype=torch.float32)
            want = plain(x.to(dev)).cpu()
            if got.shape != (b, 25, 66) or not torch.isfinite(got).all():
                fail(f"/predict b={b}: bad answer of shape {tuple(got.shape)}")
            e2e.append((f"/predict b={b}", float((got - want).abs().max())))
        got = torch.tensor(rollout, dtype=torch.float32)
        want = plain(reqs[5].to(dev))[:, :12].cpu()
        if got.shape != (5, 12, 66):
            fail(f"/predict_autoregressive: shape {tuple(got.shape)}")
        e2e.append(("/predict_autoregressive b=5 h=12",
                    float((got - want).abs().max())))
        want = plain(x_bulk.to(dev))
        if bulk_out.shape != (BULK_ROWS, 25, 66) or not torch.isfinite(bulk_out).all():
            fail("bulk predict: bad output")
        e2e.append((f"bulk encoder_fused b={BULK_ROWS}",
                    float((bulk_out - want).abs().max())))
    with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
        health = json.loads(r.read())
    say(f"[5 serve] health {health} | {tf32_flags(torch)} | launches on the "
        f"main path {launches} | "
        + " ; ".join(f"{k} err {v:.3e}" for k, v in e2e) + f" (tol {TOL_E2E:g})")
    for k, v in e2e:
        if not v <= TOL_E2E:
            fail(f"{k}: {v:.3e} from the plain forward (tol {TOL_E2E:g})")
    for k, v in launches.items():
        if v < 1:
            fail(f"kernel {k} was not launched on the main path")

    # [6] times (CUDA events; per-request latency on the host clock)
    lat, bat_lat = {}, {}
    for b in (1, 32):
        payload = {"inputs": reqs[b].tolist()}
        xb = reqs[b].numpy()
        lat[b] = host_median_ms(lambda: post(base, "/predict", payload))
        bat_lat[b] = host_median_ms(lambda: server.batcher.predict(xb))
    server.close()
    pred_lat = {}
    for b, p in ((1, predictor), (32, predictor), (128, predictor), (BULK_ROWS, bulk)):
        xb = x_bulk[:b].clone()
        p.predict(xb).cpu()
        pred_lat[b] = host_median_ms(lambda: p.predict(xb).cpu())

    with torch.no_grad():
        fused = predictor._fused
        spec, wts = fused.spec, fused.weights
        b2 = {}
        for b in B2_BATCHES:
            y = fused.encoder(x_all[:b])[..., 0].contiguous()
            b2[b] = (
                queued_ms(torch, lambda: conv_mixer.conv_mixer_fused(y, wts, spec)),
                cuda_ms(torch, lambda: conv_mixer.conv_mixer_fused(y, wts, spec)),
                cuda_ms(torch, lambda: conv_mixer.conv_mixer_plain(y, wts, spec)),
                host_ms(torch, lambda: conv_mixer.conv_mixer_fused(y, wts, spec)),
                bound(*b2_work(spec, b, wts.numel())),
                device_us(torch, lambda: conv_mixer.conv_mixer_fused(
                    y, wts, spec), "conv_mixer_fused_kernel"),
            )
        rows = BULK_ROWS * 10
        x2d = x_all.reshape(-1, 66)[:rows].contiguous()
        b1 = {}
        for impl in ("direct", "doubling"):
            b1[impl] = (
                cuda_ms(torch, lambda: harmonic.harmonic_dense_fwd(
                    x2d, w, bias, freqs, impl, wi), reps=10),
                cuda_ms(torch, lambda: harmonic.harmonic_dense_plain(
                    x2d, w, bias, freqs, impl), reps=10),
            )
        dev_us = {
            **{f"B1 {i} R={rows} {k}": device_us(
                torch, lambda: harmonic.harmonic_dense_fwd(x2d, w, bias, freqs, i, wi),
                k, reps=5)
               for i in harmonic.IMPLS for k in B1_FWD_KERNELS},
        }
    bound_b2, by_b2 = b2[128][4]
    nb1, ob1 = b1_work(rows, 66, 64, 50, "direct")
    bound_b1, by_b1 = bound(nb1, ob1)
    say(f"[6 times] {card} | B2 conv_mixer_fused ms: per call from Python "
        "(events) / device (events over calls queued behind a spin kernel) "
        "/ plain / host enqueue (bound ms, by; profiler device us/launch): "
        + " ; ".join(f"B={b} {k:.4f}/{q:.4f}/{p:.4f}/{h:.4f} ({bd[0]:.6f}, "
                     f"{bd[1]}; {'not measured' if us is None else f'{us:.2f}'})"
                     for b, (q, k, p, h, bd, us) in b2.items())
        + f" | B1 harmonic_dense_fwd R={rows} kernel/plain ms: "
        + " ; ".join(f"{i} {k:.4f}/{p:.4f}" for i, (k, p) in b1.items())
        + " | profiler device us/launch: " + " ; ".join(
            f"{k} {'not measured' if v is None else f'{v:.2f}'}"
            for k, v in dev_us.items())
        + " | Predictor.predict latency ms (host clock, to a CPU array): "
        + " ; ".join(f"b={b} {v:.3f}" for b, v in pred_lat.items())
        + f" | BatchingPredictor.predict latency ms: b=1 {bat_lat[1]:.3f} ; "
          f"b=32 {bat_lat[32]:.3f}"
        + f" | HTTP /predict latency ms: b=1 {lat[1]:.3f} ; b=32 {lat[32]:.3f}"
        + f" | bound ms: B1 R={rows} {bound_b1:.6f} ({by_b1})")

    # [7] B1-bwd against its plain version, twice for bit-identity
    gg = torch.Generator().manual_seed(SEED + 3)
    g_all = torch.randn(max(B1_BWD_ROWS), 50, generator=gg).to(dev)
    bwd_err = {"dW": 0.0, "db": 0.0, "dx_rel": 0.0}
    parts = []
    with torch.no_grad():
        for impl in ("direct", "doubling"):
            for rows in B1_BWD_ROWS:
                x2d = x_all.reshape(-1, 66)[:rows].contiguous()
                gr = g_all[:rows].contiguous()
                got = harmonic.harmonic_dense_bwd(x2d, gr, w, freqs, impl, wi)
                again = harmonic.harmonic_dense_bwd(x2d, gr, w, freqs, impl, wi)
                want = harmonic.harmonic_dense_bwd_plain(x2d, gr, w, freqs, impl)
                torch.cuda.synchronize()
                if not all(torch.isfinite(t).all() for t in got):
                    fail(f"B1-bwd {impl} R={rows}: non-finite output")
                if not all(torch.equal(a, b) for a, b in zip(got, again)):
                    fail(f"B1-bwd {impl} R={rows}: two launches differ")
                errs = {}
                for name, a, b in zip(("dx", "dW", "db"), got, want):
                    err = float((a - b).abs().max())
                    scale = float(b.abs().max())
                    if not err <= TOL_B1_BWD * scale:
                        fail(f"B1-bwd {impl} R={rows} {name}: {err:.3e} > "
                             f"{TOL_B1_BWD:g} x max|ref| {scale:.3e}")
                    errs[name] = (err, err / scale)
                bwd_err["dW"] = max(bwd_err["dW"], errs["dW"][0])
                bwd_err["db"] = max(bwd_err["db"], errs["db"][0])
                bwd_err["dx_rel"] = max(bwd_err["dx_rel"], errs["dx"][1])
                parts.append(f"{impl} R={rows} dW {errs['dW'][0]:.3e} db "
                             f"{errs['db'][0]:.3e} dx/max|dx| {errs['dx'][1]:.3e}")
    say(f"[7 B1-bwd harmonic_dense_bwd vs plain] max abs err dW "
        f"{bwd_err['dW']:.3e}, db {bwd_err['db']:.3e}; dx err / max|dx| "
        f"{bwd_err['dx_rel']:.3e} (tol {TOL_B1_BWD:g} x max|ref| each); "
        "second launch bit-identical | " + " ; ".join(parts))

    # [8] one flagship training step, fused encoder and plain, each against
    # a float64 step of the same weights and inputs
    steps = step_check(torch, dev, SEED + 4, SEED + 5, {"fused": ConvMixer},
                       harmonic)
    if steps["fused"][1] != (1, 1) or steps["plain"][1] != (0, 0):
        fail(f"training step launches (fwd, bwd): fused {steps['fused'][1]}, "
             f"plain {steps['plain'][1]}; expected (1, 1) and (0, 0)")
    loss_rel = abs(steps["fused"][0] - steps["plain"][0]) / abs(steps["plain"][0])
    parts = []
    for tag in ("fused", "plain"):
        checks = steps[tag][2]
        worst = max((k for k in checks if k not in ROUNDING_FLOOR),
                    key=lambda k: checks[k][0])
        parts.append(
            f"{tag}: {len(checks)} gradients, worst max|g - g64| / "
            f"max(max|g64|, {STEP_FLOOR:g} x tree max) {checks[worst][0]:.3e} "
            f"at {worst} (tol {TOL_STEP:g}); encoder.embed_mlp.weight "
            f"{checks['encoder.embed_mlp.weight'][0]:.3e}; "
            + ", ".join(f"{k} |g - g64| / (sqrt(n) 2^-24 sum|terms|) "
                        f"{checks[k][0]:.3e} (tol 1)" for k in ROUNDING_FLOOR))
    say(f"[8 train step fused and plain vs float64] batch {TRAIN_BATCH}, "
        f"dropout off | loss float64 {steps['float64'][0]:.6f}, plain "
        f"{steps['plain'][0]:.6f}, fused {steps['fused'][0]:.6f} (fused vs "
        f"plain rel {loss_rel:.3e}) | " + " | ".join(parts))
    if not loss_rel <= TOL_STEP:
        fail(f"training step loss: fused and plain differ by {loss_rel:.3e}")
    for tag in ("fused", "plain"):
        for k, (err, tol) in steps[tag][2].items():
            if not err <= tol:
                fail(f"training step, {tag} gradient {k}: {err:.3e} > {tol:g}"
                     " against the float64 step")
    del steps

    # [9] the training path: the CLI on a synthetic corpus, 2 epochs as one
    # chunk (--epochs_per_dispatch 2), every step and evaluation batch a
    # replay of a captured CUDA graph; the same run in chunks of one epoch
    # and with the plain encoder beside it; the checkpoint served through B2
    from motionmixerconv_tpu_torch.cli import _runner, train_mixer_h36m
    from motionmixerconv_tpu_torch.data import H36MDataset, fixtures
    from motionmixerconv_tpu_torch.train import Trainer

    work = ROOT / "build" / "chip_smoke"
    data_dir = work / "h36m"
    t0 = time.perf_counter()
    shutil.rmtree(data_dir, ignore_errors=True)
    fixtures.make_h36m_corpus(str(data_dir), n_frames=CORPUS_FRAMES, seed=SEED)
    corpus_s = time.perf_counter() - t0
    args = train_mixer_h36m.parse_args([*TRAIN_ARGV, "--data_dir", str(data_dir)])
    train_ds = H36MDataset(str(data_dir), args.input_n, args.output_n,
                           args.skip_rate, split=0)
    n_train = len(train_ds)
    steps_per_epoch = -(-n_train // args.batch_size)
    steps = args.n_epochs * steps_per_epoch
    runs = {}
    for tag, extra in (("fused", ["--fused_encoder", *EPD2]),
                       ("plain", EPD2)):
        save = work / f"runs_{len(runs)}"
        shutil.rmtree(save, ignore_errors=True)
        argv = [*TRAIN_ARGV, *extra, "--data_dir", str(data_dir),
                "--save_path", str(save)]
        traces = contextlib.nullcontext()
        if tag == "fused":
            for c in (conv_mixer.LAUNCHES, harmonic.LAUNCHES, harmonic.LAUNCHES_BWD):
                c.reset()
            # B1's device launches in this run, replays included, counted
            # from 0 at its start
            traces = traced_launches(torch, Trainer, TRACED_METHODS, B1_IN_RUN)
        t0 = time.perf_counter()
        with traces as in_run:
            hist = train_mixer_h36m.main(argv)
        runs[tag] = (hist, time.perf_counter() - t0,
                     save / "h36_3d_25frames_ckpt" / _runner.WEIGHTS_FILE, argv)
        if tag == "fused":
            # serve the trained checkpoint through B2, still on the path
            args = train_mixer_h36m.parse_args(argv)
            served = Predictor.from_checkpoint(
                _runner.build_conv_mixer(args, 66, 66, 10, 25), str(runs[tag][2]),
                device=dev)
            test_ds = H36MDataset(str(data_dir), 10, 25, 1, actions=["walking"],
                                  split=2)
            dim_used = test_ds.dim_used
            win = torch.as_tensor(np.stack([test_ds[i] for i in range(32)]))
            x_test = (win[:, :10, dim_used] * 1e-3).contiguous()
            got = served.predict(x_test)
            torch.cuda.synchronize()
            train_launches = {"conv_mixer_fused": conv_mixer.LAUNCHES.value,
                              "harmonic_dense_fwd": harmonic.LAUNCHES.value,
                              "harmonic_dense_bwd": harmonic.LAUNCHES_BWD.value}
            plain_net = _runner.build_conv_mixer(
                argparse.Namespace(**{**vars(args), "fused_encoder": False}),
                66, 66, 10, 25)
            plain_net.load_state_dict(torch.load(runs[tag][2], weights_only=True),
                                      strict=True)
            with torch.no_grad():
                want = plain_net.to(dev).eval()(x_test.to(dev))
            # trained outputs are in mm (hundreds): the error is taken
            # relative to the output's scale
            serve_scale = max(1.0, float(want.abs().max()))
            serve_err = float((got - want).abs().max()) / serve_scale
            b1_run = in_run
    # the Python counters above see the eager warm-up steps and the
    # captures, not the replays; the traces see every device launch
    b1_train = {k: b1_run["_train_sums"][k] for k in B1_IN_RUN}
    for save in work.glob("epd_*"):
        shutil.rmtree(save, ignore_errors=True)
    epd_err, epd_hist2, epd_hist1 = epd_check(
        torch, train_mixer_h36m.main,
        [*TRAIN_ARGV, "--fused_encoder", "--data_dir", str(data_dir)],
        work / "epd_flagship")
    hist = runs["fused"][0]
    values = [*hist["train"], *hist["val"], *hist["test"],
              *hist["metrics"]["mpjpe"], *hist["metrics"]["auc_pck"]]
    say(f"[9 train CLI --loss_type mpjpe --fused_encoder "
        f"{' '.join(EPD2)}] corpus written in "
        f"{corpus_s:.1f} s, {n_train} train windows, batch {args.batch_size} | train loss {hist['train']} | val {hist['val']} | "
        f"mpjpe {[float(v) for v in hist['metrics']['mpjpe']]} | auc_pck "
        f"{[float(v) for v in hist['metrics']['auc_pck']]} | Python launch "
        f"counts on the training path {train_launches} for {steps} train "
        f"steps (eager warm-up, captures, serving) | device launches in the "
        f"CLI's run (profiler traces of each training and evaluation call):"
        f" training {b1_train} for {steps} train steps, evaluation "
        f"{b1_run['_eval_sums']} | deterministic cuDNN, --epochs_per_dispatch"
        f" 2 against 1: per-epoch history max rel {epd_err:.3e} (tol "
        f"{TOL_EPD:g}; train loss {epd_hist2['train']} against "
        f"{epd_hist1['train']}) | trained .pt served through B2 "
        f"(b=32 test windows) vs the plain forward: max abs err / max(1, "
        f"max|out| = {serve_scale:.1f}) {serve_err:.3e} (tol {TOL_E2E:g}) | "
        f"plain-encoder run train loss {runs['plain'][0]['train']}")
    if not all(np.isfinite(float(v)) for v in values):
        fail(f"non-finite loss or metric in {values}")
    if not hist["train"][1] < hist["train"][0]:
        fail(f"train loss did not fall: {hist['train']}")
    for k in ("harmonic_dense_fwd", "harmonic_dense_bwd"):
        if train_launches[k] < 1:
            fail(f"{k} was never launched on the training path")
    for k in B1_IN_RUN:
        if b1_train[k] < steps:
            fail(f"{k}: {b1_train[k]} device launches in the CLI's {steps} "
                 "train steps")
    if not epd_err <= TOL_EPD:
        fail(f"--epochs_per_dispatch 2 and 1 disagree: {epd_err:.3e}")
    if train_launches["conv_mixer_fused"] < 1:
        fail("the trained checkpoint was not served through B2")
    if got.shape != (32, 25, 66) or not serve_err <= TOL_E2E:
        fail(f"served checkpoint: shape {tuple(got.shape)}, err {serve_err:.3e}")

    # [10] training times (host clock around work ending in a host read;
    # kernels by CUDA events and the profiler)
    # the fused run's calls were traced (phase 9); the same CLI's untraced
    # --epochs_per_dispatch 2 run of the epd check beside it
    per = {}
    for tag, h, run_s in (
            ("fused, each training and evaluation call traced",
             *runs["fused"][:2]),
            ("fused, untraced, deterministic cuDNN", epd_hist2, None),
            ("plain", *runs["plain"][:2])):
        per[tag] = {"train_s": h["train_s"], "epoch_s": h["epoch_s"],
                    "samples_per_s": [n_train / t for t in h["train_s"]],
                    "step_ms": [t / steps_per_epoch * 1e3 for t in h["train_s"]],
                    "run_s": run_s}
    # B1 at the training step's rows and the bulk rows; the yardsticks are
    # cuBLAS's f32 products alone on a precomputed embedding (no trig)
    from motionmixerconv_tpu_torch.models.encoding import harmonic_features

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the cuBLAS yardsticks would not be float32")
    bwd_t, fwd_t, b1_dev = {}, {}, {}
    with torch.no_grad():
        for rows in B1_BWD_ROWS:
            x2d = x_all.reshape(-1, 66)[:rows].contiguous()
            gr = g_all[:rows].contiguous()
            feats = harmonic_features(x2d, 64, float(freqs[0]), "direct", freqs)
            for dx_on in (False, True):
                bwd_t[(rows, dx_on)] = (
                    cuda_ms(torch, lambda: harmonic.harmonic_dense_bwd(
                        x2d, gr, w, freqs, "direct", wi, need_dx=dx_on), reps=10),
                    cuda_ms(torch, lambda: harmonic.harmonic_dense_bwd_plain(
                        x2d, gr, w, freqs, "direct", need_dx=dx_on), reps=10),
                    bound(*b1_bwd_work(rows, 66, 64, 50, "direct", dx_on)),
                )
            bwd_t[(rows, "doubling")] = cuda_ms(
                torch, lambda: harmonic.harmonic_dense_bwd(
                    x2d, gr, w, freqs, "doubling", wi, need_dx=False), reps=10)
            fwd_t[rows] = {
                "ms": cuda_ms(torch, lambda: harmonic.harmonic_dense_fwd(
                    x2d, w, bias, freqs, "direct", wi), reps=10),
                "plain_ms": cuda_ms(torch, lambda: harmonic.harmonic_dense_plain(
                    x2d, w, bias, freqs, "direct"), reps=10),
                "bound": bound(*b1_work(rows, 66, 64, 50, "direct")),
                "library_ms": cuda_ms(
                    torch, lambda: torch.nn.functional.linear(feats, w, bias),
                    reps=10),
                "dw_library_ms": cuda_ms(torch, lambda: gr.t() @ feats, reps=10)}
            for k in B1_FWD_KERNELS:
                b1_dev[f"fwd R={rows} {k}"] = device_us(
                    torch, lambda: harmonic.harmonic_dense_fwd(
                        x2d, w, bias, freqs, "direct", wi), k, reps=5)
            for k in B1_BWD_KERNELS:
                b1_dev[f"bwd+dx R={rows} {k}"] = device_us(
                    torch, lambda: harmonic.harmonic_dense_bwd(
                        x2d, gr, w, freqs, "direct", wi, need_dx=True), k, reps=5)
        r0 = B1_BWD_ROWS[0]  # the training step's rows
    from motionmixerconv_tpu_torch.data.constants import H36M_DIM_USED_XYZ
    from motionmixerconv_tpu_torch.train import make_optimizer

    def flagship_trainer(regularization, **opt):
        model = ConvMixer(**dict(FLAGSHIP, regularization=regularization),
                          encoder_fused=True,
                          generator=torch.Generator().manual_seed(SEED + 6))
        model = model.to(dev)
        return Trainer(model, make_optimizer(model.parameters(), lr=1e-3, **opt),
                       loss_type="mpjpe", dim_used=H36M_DIM_USED_XYZ,
                       input_n=10, output_n=25, input_scale=1e-3)

    frames, starts, w = random_batches(torch, dev, SEED + 6, 5000, 96, 300.0,
                                       35, 3 * GRAPH_STEPS, TRAIN_BATCH)
    ev_starts = np.random.default_rng(SEED + 6).integers(0, 5000 - 35, 900)
    ev_gids = np.arange(900) % 3
    flag_graph = graph_vs_eager(
        torch, lambda: flagship_trainer(0.0, **GRAPH_SCHEDULE), frames,
        starts, w, [None],
        [("val", 1, frames, ev_starts, np.zeros(900, np.int64), TRAIN_BATCH),
         ("h36m_xyz", 3, frames, ev_starts, ev_gids, 128)])
    check_graph("flagship", flag_graph)
    trainer = flagship_trainer(FLAGSHIP["regularization"])
    masks = dropout_replays(torch, dev, trainer.model)
    if not (masks[0] > 0 and masks[1] == 0):
        fail(f"dropout under graphs: outputs that differ between two replays "
             f"{masks[0]:.3f} with dropout, {masks[1]:.3f} without")
    flag_times = train_times(torch, trainer, frames, starts, w, None)
    del trainer
    say(f"[10 train times] {card} | CLI per epoch (epoch 0, epoch 1; in "
        "the --epochs_per_dispatch 2 runs each epoch's train s and epoch s "
        "are the chunk's / 2, validation and test included): "
        + " ; ".join(
            f"{t}: train s {p['train_s'][0]:.3f}, {p['train_s'][1]:.3f} | "
            f"epoch s (train+val+test+ckpt) {p['epoch_s'][0]:.3f}, "
            f"{p['epoch_s'][1]:.3f} | train samples/s {p['samples_per_s'][0]:.1f}, "
            f"{p['samples_per_s'][1]:.1f} | step ms {p['step_ms'][0]:.3f}, "
            f"{p['step_ms'][1]:.3f}" + (
                "" if p["run_s"] is None
                else f" | whole CLI run s {p['run_s']:.2f}")
            for t, p in per.items())
        + " | B1-bwd direct kernel/plain ms (bound ms, by): "
        + " ; ".join(
            f"R={r} {'dW+db+dx' if d else 'dW+db'} {k:.4f}/{p:.4f} "
            f"({b[0]:.5f}, {b[1]})"
            for (r, d), v in bwd_t.items() if d != "doubling" for k, p, b in [v])
        + " | B1-bwd doubling dW+db kernel ms: "
        + " ; ".join(f"R={r} {v:.4f}" for (r, d), v in bwd_t.items()
                     if d == "doubling")
        + " | B1-fwd direct kernel/plain ms (bound ms, by): " + " ; ".join(
            f"R={r} {t['ms']:.4f}/{t['plain_ms']:.4f} ({t['bound'][0]:.5f}, "
            f"{t['bound'][1]})" for r, t in fwd_t.items())
        + " | cuBLAS f32 yardsticks on a precomputed embedding (no trig) ms: "
        + " ; ".join(f"R={r} F.linear(embed, W, b) {t['library_ms']:.4f}, "
                     f"g.t() @ embed {t['dw_library_ms']:.4f}"
                     for r, t in fwd_t.items())
        + " | profiler device us/launch: " + " ; ".join(
            f"{k} {'not measured' if v is None else f'{v:.2f}'}"
            for k, v in b1_dev.items())
        + f" | graph against eager (dropout off, deterministic cuDNN): "
        f"{fmt_graph(flag_graph)} | dropout 0.1 under graphs: outputs that "
        f"differ between two replays of a captured training forward "
        f"{masks[0]:.3f} (eval mode {masks[1]:.3f}) | train steps (fused, "
        f"batch {TRAIN_BATCH}, dropout 0.1): {fmt_times(flag_times)}")

    # [11] B3 against its plain version: the autoregressive default (warmed
    # BatchNorm stats), the study shape and two widths that take clusters,
    # B3_REPEATS launches each for bit-identity (a race between a cluster's
    # blocks shows as a launch that differs); each launch plan against the
    # library
    lib = _build.load_library()
    # the clusters the card holds at once, one block an SM, that the plans
    # are sized by (a plan within them runs its clusters in one wave)
    slots = conv_mixer_mc.cluster_slots(torch.cuda.current_device())
    if any(n < 1 for _, n in slots):
        fail(f"B3: the card holds no cluster of some size: {slots}")
    gb = torch.Generator().manual_seed(SEED + 7)
    x_b3 = (torch.randn(128, 10, 66, generator=gb) * 0.5).to(dev)
    b3_err, parts, b3_fused, b3_plans = 0.0, [], {}, {}
    b3_cases = [("autoregressive", AUTOREG, B3_BATCHES),
                ("study", STUDY, B3_BATCHES),
                *((tag, cfg, (7, 128)) for tag, cfg in B3_WIDE.items())]
    with torch.no_grad():
        for tag, cfg, batches in b3_cases:
            model = warm_batchnorm(torch, ConvMixer(**cfg, generator=gb).eval(),
                                   gb).to(dev)
            fused = conv_mixer.make_fused_conv_mixer(model)
            if not isinstance(fused, conv_mixer_mc.FusedConvMixerMC):
                fail(f"B3 {tag}: the factory returned {type(fused).__name__}")
            spec = fused.spec
            dims = (spec.C, spec.T, spec.E, spec.P, spec.D, spec.H,
                    spec.num_blocks, *spec.k1, *spec.k2)
            if lib.mmc_conv_mixer_mc_weights_numel(*dims) != spec.numel():
                fail(f"B3 {tag}: the kernel's weight layout disagrees with "
                     "ops/conv_mixer_mc.py")
            y_all = fused.encoder(x_b3).permute(0, 3, 1, 2).contiguous()
            b3_fused[tag] = (fused, y_all)
            for b in batches:
                plan = conv_mixer_mc.mc_plan(spec, b, slots)
                if lib.mmc_conv_mixer_mc_smem_bytes(*dims, plan.K) != \
                        spec.smem_bytes(plan.K):
                    fail(f"B3 {tag} B={b}: the kernel's shared memory "
                         f"disagrees with the plan {plan}")
                fit = lib.mmc_conv_mixer_mc_max_clusters(plan.K, plan.threads,
                                                         plan.smem)
                if fit < 1:
                    fail(f"B3 {tag} B={b}: the plan's cluster cannot be "
                         f"scheduled ({fit})")
                b3_plans[(tag, b)] = (plan, fit)
                y = y_all[:b].contiguous()
                got = conv_mixer_mc.conv_mixer_mc_fused(y, fused.weights, spec)
                again = [conv_mixer_mc.conv_mixer_mc_fused(y, fused.weights,
                                                           spec)
                         for _ in range(B3_REPEATS - 1)]
                want = conv_mixer_mc.conv_mixer_mc_plain(y, fused.weights, spec)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    fail(f"B3 {tag} B={b}: non-finite output")
                differ = sum(not torch.equal(got, a) for a in again)
                if differ:
                    fail(f"B3 {tag} B={b} {plan}: {differ} of "
                         f"{B3_REPEATS - 1} launches differ from the first")
                err = float((got - want).abs().max())
                b3_err = max(b3_err, err)
                parts.append(f"{tag} B={b} {err:.3e}")
        if not b3_err <= TOL_B3:
            fail(f"B3 disagrees with its plain version: {b3_err:.3e} > {TOL_B3:g}")
        b3_t = {}
        for tag in ("autoregressive", "study"):
            fused, y_all = b3_fused[tag]
            spec, wts = fused.spec, fused.weights
            for b in B3_BATCHES:
                y = y_all[:b].contiguous()
                b3_t[(tag, b)] = (
                    cuda_ms(torch, lambda: conv_mixer_mc.conv_mixer_mc_fused(
                        y, wts, spec), reps=20),
                    cuda_ms(torch, lambda: conv_mixer_mc.conv_mixer_mc_plain(
                        y, wts, spec), reps=20),
                    bound(*b3_work(spec, b, wts.numel())),
                    device_us(torch, lambda: conv_mixer_mc.conv_mixer_mc_fused(
                        y, wts, spec), "conv_mixer_mc_kernel", reps=10))
    say(f"[11 B3 conv_mixer_mc_fused vs plain] {card} | max_abs_err "
        f"{b3_err:.3e} (tol {TOL_B3:g}), {B3_REPEATS} launches of each case "
        "bit-identical, kernel layout and shared memory equal the wrapper's | "
        + " ; ".join(parts)
        + f" | clusters the card holds at once, one block an SM (the plans' "
          f"slots): {dict(slots)}"
        + " | plans (clusters of K blocks x threads, stencil tile, max "
        "clusters resident): " + " ; ".join(
            f"{t} B={b} K={p.K} x {p.threads} thr, tile "
            f"{conv_mixer_mc.TILES[p.tile]}, {p.smem} B smem, {fit} resident"
            for (t, b), (p, fit) in b3_plans.items())
        + " | kernel/plain ms (bound ms, by; profiler device us/launch): "
        + " ; ".join(
            f"{t} B={b} {k:.4f}/{p:.4f} ({bd[0]:.5f}, {bd[1]}; "
            f"{'not measured' if us is None else f'{us:.2f}'})"
            for (t, b), (k, p, bd, us) in b3_t.items()))
    del b3_fused

    # [12] the autoregressive path: the CLI at its default widths (one
    # teacher-forcing and one closed-loop epoch) on the synthetic corpus,
    # its train_state.pt rebuilt and served through B3, in process and over
    # HTTP (launch counts reset just before the CLI and read just after the
    # serving)
    from motionmixerconv_tpu_torch.cli import train_autoreg_mixer_h36m

    ar_save = work / "runs_ar"
    shutil.rmtree(ar_save, ignore_errors=True)
    ar_argv = [*AR_ARGV, *EPD2, "--data_dir", str(data_dir), "--save_path",
               str(ar_save)]
    ar_args = train_autoreg_mixer_h36m.parse_args(ar_argv)
    n_train_ar = len(H36MDataset(str(data_dir), ar_args.input_n_dataset,
                                 ar_args.output_n_dataset, ar_args.skip_rate,
                                 split=0))
    ar_steps = -(-n_train_ar // ar_args.batch_size)
    counters = {"conv_mixer_fused": conv_mixer.LAUNCHES,
                "conv_mixer_mc": conv_mixer_mc.LAUNCHES,
                "harmonic_dense_fwd": harmonic.LAUNCHES,
                "harmonic_dense_bwd": harmonic.LAUNCHES_BWD}
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    ar_hist = train_autoreg_mixer_h36m.main(ar_argv)
    ar_run_s = time.perf_counter() - t0
    served_ar = Predictor.from_checkpoint(
        None, str(ar_save / "h36_ar_25frames_ckpt" / _runner.STATE_FILE),
        device=dev)
    x_ar = win[:, :10, dim_used].contiguous()  # mm: this path feeds raw input
    got = served_ar.predict(x_ar)
    server = PredictionServer(served_ar, port=0, warmup=True)
    server.start_background()
    http_ar = post(f"http://127.0.0.1:{server.port}", "/predict",
                   {"inputs": x_ar[:5].tolist()})["outputs"]
    server.close()
    torch.cuda.synchronize()
    ar_launches = {k: c.value for k, c in counters.items()}
    ar_pred_lat = host_median_ms(lambda: served_ar.predict(x_ar[:1]).cpu())
    ar_epd_err, ar_epd2, ar_epd1 = epd_check(
        torch, train_autoreg_mixer_h36m.main,
        [*AR_ARGV, "--data_dir", str(data_dir)], work / "epd_autoregressive")
    with torch.no_grad():
        want = served_ar.model(x_ar.to(dev))  # the loaded nn.Module, plain
    ar_scale = max(1.0, float(want.abs().max()))
    ar_err = float((got - want).abs().max()) / ar_scale
    http_ar = torch.tensor(http_ar, dtype=torch.float32)
    ar_http_err = float((http_ar - want[:5].cpu()).abs().max()) / ar_scale
    values = [*ar_hist["train"], *ar_hist["val"], *ar_hist["test"],
              *ar_hist["metrics"]["mpjpe"], *ar_hist["metrics"]["auc_pck"]]
    say(f"[12 autoregressive CLI {' '.join(AR_ARGV + EPD2)}] model "
        f"{type(served_ar._fused).__name__} conv_nChan "
        f"{served_ar.model.conv_nChan} dimPosEmb {served_ar.model.dimPosEmb} "
        f"BatchNorm {served_ar.model.regularization == -1.0} | {n_train_ar} "
        f"train windows, batch {ar_args.batch_size} | train loss "
        f"{ar_hist['train']} (teacher forcing, closed loop) | val "
        f"{ar_hist['val']} (closed loop both) | rollout mpjpe "
        f"{[float(v) for v in ar_hist['metrics']['mpjpe']]} | auc_pck "
        f"{[float(v) for v in ar_hist['metrics']['auc_pck']]} | launches on "
        f"the path {ar_launches} | deterministic cuDNN, --epochs_per_dispatch "
        f"2 against 1: per-epoch history max rel {ar_epd_err:.3e} (tol "
        f"{TOL_EPD:g}; train loss {ar_epd2['train']} against {ar_epd1['train']}) | train_state.pt "
        f"served through B3 (b=32 "
        f"test windows) vs the plain forward: max abs err / max(1, max|out| = "
        f"{ar_scale:.1f}) {ar_err:.3e}; /predict b=5 {ar_http_err:.3e} (tol "
        f"{TOL_E2E:g}) | {card}: served Predictor.predict b=1 "
        f"{ar_pred_lat:.3f} ms (host clock, to a CPU array)")
    if not all(np.isfinite(float(v)) for v in values):
        fail(f"autoregressive run: non-finite loss or metric in {values}")
    if not ar_hist["val"][1] < ar_hist["val"][0]:
        fail(f"autoregressive run: the closed-loop val loss did not fall: "
             f"{ar_hist['val']}")
    if ar_launches["conv_mixer_mc"] < 1:
        fail("the autoregressive checkpoint was not served through B3")
    if not ar_epd_err <= TOL_EPD:
        fail(f"autoregressive --epochs_per_dispatch 2 and 1 disagree: "
             f"{ar_epd_err:.3e}")
    if got.shape != (32, 5, 66) or not torch.isfinite(got).all() \
            or not ar_err <= TOL_E2E or not ar_http_err <= TOL_E2E:
        fail(f"served autoregressive checkpoint: shape {tuple(got.shape)}, "
             f"err {ar_err:.3e}, /predict err {ar_http_err:.3e}")

    # [13] autoregressive times: the CLI's epochs (host clock around work
    # ending in a host read) and a profiled window of closed-loop steps
    from motionmixerconv_tpu_torch.train import AutoregressiveTrainer

    def ar_trainer(**opt):
        model = ConvMixer(**AUTOREG,
                          generator=torch.Generator().manual_seed(SEED + 8))
        model = model.to(dev)
        return AutoregressiveTrainer(
            model, make_optimizer(model.parameters(), lr=1e-3, **opt),
            loss_type="mpjpe", dim_used=H36M_DIM_USED_XYZ, input_n=10,
            output_n=25, input_n_model=10, output_n_model=5, step_window=5)

    frames, starts, w = random_batches(torch, dev, SEED + 8, 5000, 96, 300.0,
                                       35, 3 * GRAPH_STEPS, TRAIN_BATCH)
    ev_starts = np.random.default_rng(SEED + 8).integers(0, 5000 - 35, 400)
    ev_zeros = np.zeros(400, np.int64)
    ar_graph = graph_vs_eager(
        torch, lambda: ar_trainer(**GRAPH_SCHEDULE), frames, starts, w,
        [True, False], [("val", 1, frames, ev_starts, ev_zeros, TRAIN_BATCH),
                        ("ar", 1, frames, ev_starts, ev_zeros, TRAIN_BATCH)])
    check_graph("autoregressive", ar_graph)
    trainer = ar_trainer()
    ar_times = {tf: train_times(torch, trainer, frames, starts, w, tf)
                for tf in (True, False)}
    del trainer
    say(f"[13 autoregressive times] {card} | CLI epoch 0 (teacher forcing), "
        f"epoch 1 (closed loop), a chunk each (train s and samples/s include "
        f"the chunk's validation and test): train s {ar_hist['train_s'][0]:.3f}, "
        f"{ar_hist['train_s'][1]:.3f} | train samples/s "
        f"{n_train_ar / ar_hist['train_s'][0]:.1f}, "
        f"{n_train_ar / ar_hist['train_s'][1]:.1f} | step ms "
        f"{ar_hist['train_s'][0] / ar_steps * 1e3:.3f}, "
        f"{ar_hist['train_s'][1] / ar_steps * 1e3:.3f} | epoch s (train+val+"
        f"test+ckpt) {ar_hist['epoch_s'][0]:.3f}, {ar_hist['epoch_s'][1]:.3f}"
        f" | whole CLI run s {ar_run_s:.2f} | graph against eager (teacher "
        f"forcing, then closed loop; deterministic cuDNN): {fmt_graph(ar_graph)}"
        f" | teacher-forcing steps (batch {TRAIN_BATCH}): "
        f"{fmt_times(ar_times[True])} | closed-loop steps: "
        f"{fmt_times(ar_times[False])}")

    # [14] B4 against its plain version at the AMASS default and the
    # variants it takes, B4_REPEATS launches of each case bit-identical
    gm = torch.Generator().manual_seed(SEED + 9)
    b4_err, parts, b4_fused, b4_plans = 0.0, [], {}, []
    with torch.no_grad():
        for tag, (cfg, batches) in B4_SHAPES.items():
            model = warm_batchnorm(torch, MlpMixer(**cfg, generator=gm).eval(),
                                   gm).to(dev)
            fused = mlp_mixer.make_fused_mlp_mixer(model)
            spec = fused.spec
            if (spec.uses_scratch, spec.wbuf_floats() == 0) != (
                    tag == "long_window", tag == "wide"):
                fail(f"B4 {tag}: uses_scratch {spec.uses_scratch}, weight "
                     f"buffer {spec.wbuf_floats()} floats")
            x_m = (torch.randn(max(batches), spec.T, spec.D, generator=gm)
                   * 0.5).to(dev)
            b4_fused[tag] = (fused, x_m, model_floats(model))
            b4_plans.append(f"{tag} {b4_launch(spec, max(batches))}")
            for b in batches:
                xb = x_m[:b].contiguous()
                got = mlp_mixer.mlp_mixer_fused(xb, fused.weights, spec)
                again = [mlp_mixer.mlp_mixer_fused(xb, fused.weights, spec)
                         for _ in range(B4_REPEATS - 1)]
                want = mlp_mixer.mlp_mixer_plain(xb, fused.weights, spec)
                module = model(xb)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all():
                    fail(f"B4 {tag} B={b}: non-finite output")
                differ = sum(not torch.equal(got, a) for a in again)
                if differ:
                    fail(f"B4 {tag} B={b}: {differ} of {B4_REPEATS - 1} "
                         "launches differ from the first")
                err = float((got - want).abs().max())
                b4_err = max(b4_err, err)
                parts.append(f"{tag} B={b} {err:.3e} (module "
                             f"{float((got - module).abs().max()):.1e})")
    say(f"[14 B4 mlp_mixer_fused vs plain] max_abs_err {b4_err:.3e} (tol "
        f"{TOL_B4:g}), {B4_REPEATS} launches of each case bit-identical, "
        "activations in scratch "
        "(long_window) and weights read in place (wide) as the wrapper "
        "placed them | " + " ; ".join(parts)
        + " | launch per shape at its largest batch: " + " ; ".join(b4_plans))
    if not b4_err <= TOL_B4:
        fail(f"B4 disagrees with its plain version: {b4_err:.3e} > {TOL_B4:g}")

    # [15] the AMASS path: the CLI at its default widths for 2 epochs on a
    # synthetic corpus, its train_state.pt served through B4 in process and
    # over HTTP with --arch auto (launch counts reset just before the CLI and
    # read just after the serving)
    from motionmixerconv_tpu_torch import serving_server
    from motionmixerconv_tpu_torch.cli import train_mixer_amass
    from motionmixerconv_tpu_torch.data import AMASSDataset
    from motionmixerconv_tpu_torch.data.constants import AMASS_DIM_USED, AMASS_SPLITS

    amass_dir = work / "amass"
    t0 = time.perf_counter()
    shutil.rmtree(amass_dir, ignore_errors=True)
    fixtures.make_amass_corpus(str(amass_dir), splits=AMASS_SPLITS,
                               seed=SEED, **AMASS_CORPUS)
    amass_corpus_s = time.perf_counter() - t0
    am_save = work / "runs_amass"
    shutil.rmtree(am_save, ignore_errors=True)
    am_argv = [*AMASS_ARGV, *EPD2, "--data_dir", str(amass_dir),
               "--save_path", str(am_save)]
    am_args = train_mixer_amass.parse_args(am_argv)
    counters["mlp_mixer_fused"] = mlp_mixer.LAUNCHES
    for c in (*counters.values(), mlp_mixer.PLAIN_CALLS):
        c.reset()
    t0 = time.perf_counter()
    am_hist = train_mixer_amass.main(am_argv)
    am_run_s = time.perf_counter() - t0
    am_state = str(am_save / "amass_3d_25frames_ckpt" / _runner.STATE_FILE)
    served_am = Predictor.from_checkpoint(None, am_state, device=dev)
    am_test = AMASSDataset(str(amass_dir), 10, 25, 1, split=2)
    am_win = torch.as_tensor(np.stack([am_test[i] for i in range(32)]))
    x_am = am_win.reshape(32, 35, -1)[:, :10, AMASS_DIM_USED].contiguous()
    got = served_am.predict(x_am)
    http_pred = serving_server.load_predictor(
        serving_server.build_parser().parse_args(
            ["--model_path", am_state, "--arch", "auto"]), dev)
    am_server = PredictionServer(http_pred, port=0, warmup=True)
    am_server.start_background()
    am_base = f"http://127.0.0.1:{am_server.port}"
    http_am = post(am_base, "/predict", {"inputs": x_am[:5].tolist()})["outputs"]
    torch.cuda.synchronize()
    am_launches = {k: c.value for k, c in counters.items()}
    am_plain_calls = mlp_mixer.PLAIN_CALLS.value
    am_epd_err, am_epd2, am_epd1 = epd_check(
        torch, train_mixer_amass.main,
        [*AMASS_ARGV, "--data_dir", str(amass_dir)], work / "epd_amass")
    with torch.no_grad():
        want = served_am.model(x_am.to(dev))  # the loaded nn.Module, plain
    am_scale = max(1.0, float(want.abs().max()))
    am_err = float((got - want).abs().max()) / am_scale
    http_am = torch.tensor(http_am, dtype=torch.float32)
    am_http_err = float((http_am - want[:5].cpu()).abs().max()) / am_scale
    n_train_am = len(AMASSDataset(str(amass_dir), 10, 25, 1, split=0))
    n_val_am = len(AMASSDataset(str(amass_dir), 10, 25, 1, split=1))
    am_steps = -(-n_train_am // am_args.batch_size)
    values = [*am_hist["train"], *am_hist["val"], *am_hist["test"]]
    say(f"[15 AMASS CLI {' '.join(AMASS_ARGV + EPD2)}] corpus written in "
        f"{amass_corpus_s:.1f} s: {n_train_am} train, {n_val_am} val, "
        f"{len(am_test)} test windows, batch {am_args.batch_size} | model "
        f"{type(served_am._fused).__name__} hidden {served_am.model.hidden_dim}"
        f" blocks {served_am.model.num_blocks} | train loss {am_hist['train']}"
        f" | val {am_hist['val']} | test mpjpe mm {am_hist['test']} | "
        f"launches on the path {am_launches}, plain-version calls "
        f"{am_plain_calls} | deterministic cuDNN, --epochs_per_dispatch 2 "
        f"against 1: per-epoch history max rel {am_epd_err:.3e} (tol "
        f"{TOL_EPD:g}; train loss {am_epd2['train']} against {am_epd1['train']}) | train_state.pt served through B4 (b=32 test "
        f"windows) vs the plain forward: max abs err / max(1, max|out| = "
        f"{am_scale:.3f}) {am_err:.3e}; /predict --arch auto b=5 "
        f"{am_http_err:.3e} (tol {TOL_E2E:g})")
    if not all(np.isfinite(float(v)) for v in values):
        fail(f"AMASS run: non-finite loss or metric in {values}")
    if not am_hist["train"][1] < am_hist["train"][0]:
        fail(f"AMASS run: the train loss did not fall: {am_hist['train']}")
    if not am_epd_err <= TOL_EPD:
        fail(f"AMASS --epochs_per_dispatch 2 and 1 disagree: {am_epd_err:.3e}")
    if am_launches["mlp_mixer_fused"] < 1 or am_plain_calls != 0:
        fail(f"AMASS checkpoint: B4 launched {am_launches['mlp_mixer_fused']}"
             f" times, the plain version called {am_plain_calls} times")
    if got.shape != (32, 25, 54) or not torch.isfinite(got).all() \
            or not am_err <= TOL_E2E or not am_http_err <= TOL_E2E:
        fail(f"served AMASS checkpoint: shape {tuple(got.shape)}, err "
             f"{am_err:.3e}, /predict err {am_http_err:.3e}")

    # [16] B4, serving and AMASS training times
    b4_t, b4_dev = {}, {}
    with torch.no_grad():
        fused, x_m, n_model = b4_fused["amass"]
        spec, wts = fused.spec, fused.weights
        b4_spec = spec
        for b in (1, 32, 128):
            xb = x_m[:b].contiguous()
            b4_t[b] = (
                cuda_ms(torch, lambda: mlp_mixer.mlp_mixer_fused(xb, wts, spec)),
                cuda_ms(torch, lambda: mlp_mixer.mlp_mixer_plain(xb, wts, spec)),
                bound(*b4_work(spec, b, n_model)),
                queued_ms(torch, lambda: mlp_mixer.mlp_mixer_fused(xb, wts, spec)))
            b4_dev[b] = device_us(
                torch, lambda: mlp_mixer.mlp_mixer_fused(xb, wts, spec),
                "mlp_mixer_kernel")
            if b4_dev[b] is None:
                fail(f"B4 B={b}: the profiler shows no device time for "
                     "mlp_mixer_kernel")
    del b4_fused
    am_pred_lat = {}
    x_bulk_am = (torch.randn(BULK_ROWS, 10, 54, generator=gm) * 0.3)
    for b in (1, 32, 128, BULK_ROWS):
        xb = x_bulk_am[:b].clone()
        served_am.predict(xb).cpu()
        am_pred_lat[b] = host_median_ms(lambda: served_am.predict(xb).cpu())
    payload = {"inputs": x_am[:1].tolist()}
    am_http_lat = host_median_ms(lambda: post(am_base, "/predict", payload))
    am_server.close()
    def amass_trainer(regularization, **opt):
        model = MlpMixer(**dict(AMASS_MLP, regularization=regularization),
                         generator=torch.Generator().manual_seed(SEED + 10))
        model = model.to(dev)
        return Trainer(model, make_optimizer(model.parameters(), lr=1e-3, **opt),
                       loss_type="mpjpe", dim_used=AMASS_DIM_USED, input_n=10,
                       output_n=25, input_scale=1.0, loss_scale=1000.0)

    batch = am_args.batch_size
    frames, starts, w = random_batches(torch, dev, SEED + 10, 5000, 156, 0.3,
                                       35, 3 * GRAPH_STEPS, batch)
    ev_starts = np.random.default_rng(SEED + 10).integers(0, 5000 - 35, 1200)
    ev_zeros = np.zeros(1200, np.int64)
    am_graph = graph_vs_eager(
        torch, lambda: amass_trainer(0.0, **GRAPH_SCHEDULE), frames, starts,
        w, [None], [("val", 1, frames, ev_starts, ev_zeros, batch),
                    ("amass22", 1, frames, ev_starts, ev_zeros, batch)])
    check_graph("AMASS", am_graph)
    am_times = train_times(torch, amass_trainer(AMASS_MLP["regularization"]),
                           frames, starts, w, None)
    say(f"[16 AMASS times] {card} | B4 mlp_mixer_fused ms: per call from "
        "Python / device (calls queued) / plain (bound ms, by): " + " ; ".join(
            f"B={b} {k:.4f}/{q:.4f}/{p:.4f} ({bd[0]:.5f}, {bd[1]})"
            for b, (k, p, bd, q) in b4_t.items())
        + " | launches: " + " ; ".join(
            f"B={b} {b4_launch(b4_spec, b)}" for b in b4_t)
        + " | profiler device us/launch: " + " ; ".join(
            f"B={b} {'not measured' if v is None else f'{v:.2f}'}"
            for b, v in b4_dev.items())
        + " | Predictor.predict latency ms (host clock, to a CPU array): "
        + " ; ".join(f"b={b} {v:.3f}" for b, v in am_pred_lat.items())
        + f" | HTTP /predict b=1 {am_http_lat:.3f} ms"
        + f" | CLI epochs 0, 1 as one chunk (each the chunk's / 2, "
          f"validation and test included): train s {am_hist['train_s'][0]:.3f}, "
          f"{am_hist['train_s'][1]:.3f} | train samples/s "
          f"{n_train_am / am_hist['train_s'][0]:.1f}, "
          f"{n_train_am / am_hist['train_s'][1]:.1f} | step ms "
          f"{am_hist['train_s'][0] / am_steps * 1e3:.3f}, "
          f"{am_hist['train_s'][1] / am_steps * 1e3:.3f} ({am_steps} steps) | "
          f"epoch s (train+val+test+ckpt) {am_hist['epoch_s'][0]:.3f}, "
          f"{am_hist['epoch_s'][1]:.3f} | whole CLI run s {am_run_s:.2f} | "
          f"graph against eager (dropout off): {fmt_graph(am_graph)} | train "
          f"steps (batch {batch}, dropout 0.1): {fmt_times(am_times)}")

    kernels = [
        {"name": "conv_mixer_fused", "route": "cuda",
         "source": "motionmixerconv_tpu_torch/csrc/conv_mixer_fused.cu",
         "replaces": "motionmixerconv_tpu/ops/pallas_conv_mixer.py:579",
         "launches": launches["conv_mixer_fused"], "max_abs_err": b2_err,
         "ms": b2[128][1], "plain_ms": b2[128][2], "bound_ms": bound_b2,
         "bound_by": by_b2, "library_ms": None, "device_ms": b2[128][0],
         "by_batch": {str(b): {"ms": k, "device_ms": q, "plain_ms": p,
                               "bound_ms": bd[0], "device_us": us}
                      for b, (q, k, p, h, bd, us) in b2.items()}},
        {"name": "harmonic_dense_fwd", "route": "cuda",
         "source": "motionmixerconv_tpu_torch/csrc/harmonic_dense.cu",
         "replaces": "motionmixerconv_tpu/ops/pallas_harmonic.py:54",
         "launches": launches["harmonic_dense_fwd"], "max_abs_err": b1_err,
         "device_launches_per_train_step": b1_train[B1_IN_RUN[0]] / steps,
         "ms": b1["direct"][0], "plain_ms": b1["direct"][1], "bound_ms": bound_b1,
         "bound_by": by_b1, "library_ms": fwd_t[BULK_ROWS * 10]["library_ms"],
         "library_note": "F.linear(embed, W, b), cuBLAS f32, on a precomputed "
                         "embedding: the contraction without the trig",
         "rows": BULK_ROWS * 10,
         "by_rows": {str(r): {"ms": t["ms"], "plain_ms": t["plain_ms"],
                              "bound_ms": t["bound"][0],
                              "library_ms": t["library_ms"],
                              "device_us": {k: b1_dev[f"fwd R={r} {k}"]
                                            for k in B1_FWD_KERNELS}}
                     for r, t in fwd_t.items()}},
        {"name": "harmonic_dense_bwd", "route": "cuda",
         "source": "motionmixerconv_tpu_torch/csrc/harmonic_dense.cu",
         "replaces": "motionmixerconv_tpu/ops/pallas_harmonic.py:104",
         "launches": train_launches["harmonic_dense_bwd"],
         "device_launches_per_train_step": b1_train[B1_IN_RUN[1]] / steps,
         "max_abs_err": max(bwd_err["dW"], bwd_err["db"]),
         "dx_err_over_max": bwd_err["dx_rel"],
         "ms": bwd_t[(r0, False)][0], "plain_ms": bwd_t[(r0, False)][1],
         "bound_ms": bwd_t[(r0, False)][2][0],
         "bound_by": bwd_t[(r0, False)][2][1],
         "library_ms": fwd_t[r0]["dw_library_ms"],
         "library_note": "g.t() @ embed, cuBLAS f32, on a precomputed "
                         "embedding: dW's contraction without the trig or db",
         "rows": r0,
         "with_dx": {"ms": bwd_t[(r0, True)][0],
                     "plain_ms": bwd_t[(r0, True)][1],
                     "bound_ms": bwd_t[(r0, True)][2][0]},
         "by_rows": {str(r): {"ms": bwd_t[(r, False)][0],
                              "plain_ms": bwd_t[(r, False)][1],
                              "bound_ms": bwd_t[(r, False)][2][0],
                              "library_ms": fwd_t[r]["dw_library_ms"],
                              "with_dx_ms": bwd_t[(r, True)][0],
                              "device_us": {k: b1_dev[f"bwd+dx R={r} {k}"]
                                            for k in B1_BWD_KERNELS}}
                     for r in B1_BWD_ROWS}},
        {"name": "conv_mixer_mc", "route": "cuda",
         "source": "motionmixerconv_tpu_torch/csrc/conv_mixer_mc.cu",
         "replaces": "motionmixerconv_tpu/ops/pallas_conv_mixer.py:465",
         "launches": ar_launches["conv_mixer_mc"], "max_abs_err": b3_err,
         "ms": b3_t[("autoregressive", 128)][0],
         "plain_ms": b3_t[("autoregressive", 128)][1],
         "bound_ms": b3_t[("autoregressive", 128)][2][0],
         "bound_by": b3_t[("autoregressive", 128)][2][1], "library_ms": None,
         "study": {"ms": b3_t[("study", 128)][0],
                   "plain_ms": b3_t[("study", 128)][1],
                   "bound_ms": b3_t[("study", 128)][2][0]},
         "by_batch": {f"{t} {b}": {
             "ms": k, "plain_ms": p, "bound_ms": bd[0], "device_us": us,
             "K": b3_plans[(t, b)][0].K,
             "threads": b3_plans[(t, b)][0].threads}
             for (t, b), (k, p, bd, us) in b3_t.items()}},
        {"name": "mlp_mixer_fused", "route": "cuda",
         "source": "motionmixerconv_tpu_torch/csrc/mlp_mixer_fused.cu",
         "replaces": "motionmixerconv_tpu/ops/pallas_mixer.py:278",
         "launches": am_launches["mlp_mixer_fused"], "max_abs_err": b4_err,
         "ms": b4_t[128][0], "plain_ms": b4_t[128][1],
         "bound_ms": b4_t[128][2][0], "bound_by": b4_t[128][2][1],
         "library_ms": None, "device_ms": b4_t[128][3],
         "by_batch": {str(b): {"ms": k, "device_ms": q, "plain_ms": p,
                               "bound_ms": bd[0], "device_us": b4_dev[b]}
                      for b, (k, p, bd, q) in b4_t.items()}},
    ]
    for k in kernels:
        k["launches_by_path"] = {"serve": launches.get(k["name"], 0),
                                 "train": train_launches.get(k["name"], 0),
                                 "autoregressive": ar_launches.get(k["name"], 0),
                                 "amass": am_launches[k["name"]]}
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

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
that run counted by the kernels themselves on the device, read around
each of its training and evaluation calls (at least one of each a train
step), the history held to
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
held to the eager one, [17] B1-fwd and B1-bwd (dW + db, and with dx; 500
and 2560 rows), B2 (the angle ConvMixer, AIS direct and AIS
autoregressive, at 1, 7, 32 and 128 samples) and B4 (the angle MlpMixer at
1, 32 and 128) at the shapes the H36M angle and AIS paths give them,
through the same checks and timers as phases 3-4, 6-7, 10, 14 and 16,
[18] the main training CLI at
its true defaults (``--loss_type angle``: 48 dims, hidden 60, 3 blocks, lr
1e-2) with ``--fused_encoder --epochs_per_dispatch 2``, B1's device
launches counted in its own run as in phase 9, its history held to chunks
of one epoch, its ``train_state.pt`` served through B2 in process and over
HTTP, [19] the angle autoregressive CLI at its defaults (conv_nChan 60,
outside B3's domain: served by the plain forward, the refusal named), [20]
both AIS CLIs at their default widths on a synthetic keypoint corpus with
failed detections (frame 0 among them), each checkpoint served through B2
(launch counts reset just before each CLI of 18-20 and read just after its
serving), then the
angle and AIS train steps' times and the angle graph held to its eager
steps, [21] checkpoint interchange with the JAX package: the committed
JAX checkpoint (no meta; its MlpMixer from its array shapes) served through
B4, phase 9's trained flagship written by the port as a JAX ``.ckpt``, read
back bit-identical to its ``train_state.pt`` (weights and Adam state),
served through B2 and the bulk path (B1-fwd) bit-identical to the ``.pt``
route, and evaluated by ``cli.test_mixer_h36m`` as the ``.pt`` is, [22]
``sweep.conv_study`` at its default widths (one epoch on a fifth of the H36M
windows; one grid trial at ``--n_jobs 1``, two at ``--n_jobs 2`` with
``--pruner median``, each trial mpjpe then angle), every trial's state read
from ``results.db``, ``optuna_export``, the best trial served through B3,
and B3 at all 24 kernel shapes of the study's grid against its plain
version, twice for bit-identity, [23] ``sweep.mlp_study`` (TPE, seed 0, 2
trials) with its best trial through B4 and ``sweep.autoreg_study`` (one AIS
grid trial, a teacher-forcing and a closed-loop epoch) through B3 (launch
counts reset just before each of 21-23's paths and read just after its
serving), [24] the convergence-parity runs of
``motionmixerconv_tpu_torch.parity_runs`` at their full schedules from the
recorded inits (matched-init and lockstep H36M, each with the plain
encoder and with ``--fused_encoder``, the lockstep drift pair, AMASS and
both autoregressive configurations), each held to the recorded torch
reference at the tolerances of ``tests/test_parity_runs.py`` and the drift
endpoints to theirs, B1's device launches counted in the fused runs, the
trained flagship, autoregressive and AMASS models served through B2, B3
and B4 against their plain forwards and float64, [25] ``make_cmu_corpus``
-> ``CMUDataset`` (xyz) -> graph-replayed training steps of an MlpMixer
at the CMU width -> served through B4 against its plain forward and
float64 (launch counts reset just before 24's and 25's paths and read just
after their serving), [26] the data-parallel mesh: (a) one NCCL rank a
card (``parallel.launch``) trains the flagship with the fused encoder
through the mesh Trainer on graphs (collectives captured), evaluates and
runs 2 fused epochs, held to ``mesh=None`` from the same init at 1e-6
relative, B1 on the device at least once a train step; (b) two gloo ranks
on the card through every stanza of ``parallel/dryrun.py`` at the
flagship widths; (c) ``Predictor(mesh=)`` over two replicas on the card,
bulk batches of 5 and 257 rows against the plain forward, B = 128 through
B2 (the NCCL-trained flagship) and B3 (the gloo-trained BatchNorm model)
against float64, [27] the bf16 compute dtype: the flagship's bf16
forward against its float32 one (0.05 relative), 20 graph-replayed bf16
and float32 train steps timed in one call, and a bf16 MlpMixer's weights
served through B4 against its float32 plain forward (launch counts reset
just before each of 26's and 27's paths and read just after its serving).
Then the whole run's seconds, one JSON line with every kernel's
numbers, the card's name and power limit, and the result line. Any failure exits non-zero; with
no CUDA device, or with the port's package missing beside this script, it
exits at once and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import shutil
import sqlite3
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
# B1's kernels, counted on the device in the training CLIs' own runs
# (phases 9 and 18: at least one of each a train step), and the trainer
# methods around each of whose calls the counts are read
B1_IN_RUN = ("harmonic_dense_fwd_kernel", "harmonic_dense_bwd_dw_kernel")
COUNTED_METHODS = ("_train_sums", "_eval_sums")
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
# phases 17-20: the H36M angle paths and AIS, each at its CLI's defaults.
# B1 at the angle encoder's D, n, E; the AIS corpus: all eight actions of
# AIS_FRAMES keypoint frames, detections failing on AIS_FAIL_FRAMES (even,
# so that --skip_rate 2 keeps them; frame 0 too, whose NaN no padding row
# may read)
B1_ANGLE_SHAPE = (48, 64, 60)
B1_ANGLE_ROWS = (500, 2560)  # a train step at batch 50; 256 windows
B2_NEW_TIMED = (1, 128)  # the batches phase 17 times B2 at
ANGLE_ARGV = ["--fused_encoder"]  # the main CLI at its true defaults
AR_ANGLE_ARGV = ["--loss_type", "angle", "--n_epochs", "2",
                 "--n_epochs_teacher_forcing", "1", "--skip_rate", "5"]
AIS_FRAMES = 3000
AIS_FAIL_FRAMES = (0,) + tuple(range(120, AIS_FRAMES, 194))
AIS_ARGV = ["--n_epochs", "2"]
AIS_AR_ARGV = ["--n_epochs", "2", "--n_epochs_teacher_forcing", "1"]
B4_ANGLE_BATCHES = (1, 32, 128)
# phases 21-23: checkpoint interchange and the studies. The committed JAX
# checkpoint (a 2-block AMASS MlpMixer, no meta) and the batches B4 serves
# it at; the studies at their default widths, cut to one epoch (two for the
# autoregressive study: teacher forcing, then closed loop), a fifth of the
# H36M windows and a fifth of the AIS ones; conv_study's grid of kernel
# shapes (conv_optuna_main.py:337-348)
ANCHOR = str(ROOT / "checkpoints" / "amass_3d_25frames_ckpt")
ANCHOR_BATCHES = (1, 32, 128)
STUDY_ARGV = ["--n_epochs", "1", "--skip_rate", "5"]
MLP_STUDY_ARGV = ["--n_trials", "2", "--n_epochs", "1", "--skip_rate", "5"]
AR_STUDY_ARGV = ["--dataset_type", "ais", "--n_trials", "1", "--n_epochs",
                 "2", "--n_epochs_teacher_forcing", "1", "--skip_rate", "5"]
STUDY_GRID = tuple((kh, kw) for kh in (1, 5, 9) for kw in range(1, 30, 4))
# phase 25: the CMU corpus (every action, 2 files of CMU_FRAMES frames),
# CMU_EPOCHS epochs of CMU_STEPS graph-replayed steps at batch TRAIN_BATCH
CMU_FRAMES = 600
CMU_STEPS = 20
CMU_EPOCHS = 2
# phases 26-27: the data-parallel mesh (one NCCL rank a card; two gloo
# ranks on one card; Predictor(mesh=) over two replicas on one card) and
# the bf16 compute dtype
MESH_BATCH = 50      # a rank's rows of a global batch
MESH_STEPS = 20      # batches of the NCCL epoch, the last ragged
MESH_GROUPS = 15     # the grouped evaluation's groups (H36M's actions)
TOL_MESH = 1e-6      # NCCL mesh against mesh=None, relative; bit-identical expected
MESH_BULK = (5, 257)  # Predictor(mesh=) bulk batches: 3 * 2 - 1 and 257
TOL_BF16 = 0.05      # bf16 forward against float32, relative (JAX's bound)
BF16_STEPS = 20      # graph-replayed steps a timing window
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


@contextlib.contextmanager
def counted_launches(harmonic, cls, methods):
    """Yields {method: {kernel: device launches}}: the launches of B1's
    forward and dW kernels (B1_IN_RUN) made by the calls of each of
    ``cls``'s ``methods`` while the context is open, as the kernels count
    them on the device (``harmonic.device_launches``, read before and after
    each call). Replays of a captured CUDA graph launch no wrapper, so the
    Python counters cannot see them; the device counts every launch."""
    counts = {m: dict.fromkeys(B1_IN_RUN, 0) for m in methods}
    saved = {m: getattr(cls, m) for m in methods}

    def counted(m, fn):
        def call(*a, **k):
            before = harmonic.device_launches()
            out = fn(*a, **k)
            after = harmonic.device_launches()
            for name, b, n in zip(B1_IN_RUN, before, after):
                counts[m][name] += n - b
            return out
        return call

    for m, fn in saved.items():
        setattr(cls, m, counted(m, fn))
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


def check_b1_plans(lib, harmonic, torch, shape=B1_SHAPE,
                   rows_used=(*B1_FWD_ROWS, *B1_BWD_ROWS)) -> str:
    """Fail unless the library's B1 tiles and shared memory agree with the
    wrapper's launch plans (``ops/harmonic.py``) at ``shape`` (D, n, E; the
    flagship's by default) and the rows ``rows_used`` (those phases 4, 7
    and 10 use by default), and unless as many blocks fit an SM as the
    plans count on; returns the plans in brief."""
    d, n, e = shape
    consts = {"fwd_rows": harmonic.FWD_ROWS,
              "fwd_max_cols": harmonic.FWD_MAX_COLS,
              "dw_rows": harmonic.DW_ROWS,
              "dx_rows": harmonic.DX_ROWS}
    for k, v in consts.items():
        if getattr(lib, f"mmc_harmonic_{k}")() != v:
            fail(f"B1: the library's {k} is not the wrapper's {v}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = []
    for rows in sorted(set(rows_used)):
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


def encoder_params(enc) -> tuple:
    """(W, b, frequencies, the i-major weight the fused encoder keeps) of a
    ``PoseEncoder``: B1's operands."""
    return (enc.embed_mlp.weight.detach(), enc.embed_mlp.bias.detach(),
            enc.frequencies, enc.kernel_weight())


def check_b1_fwd(torch, harmonic, x_all, enc, impls, rows_used) -> dict:
    """B1-fwd against its plain version on the first rows of ``x_all``
    (rows x D) for each of ``impls`` and ``rows_used``, launched twice for
    bit-identity (the groups' partial sums are added in a fixed order);
    ``enc`` from ``encoder_params``. Fails on any case; returns {(impl,
    rows): max abs err}."""
    w, bias, freqs, wi = enc
    out = {}
    with torch.no_grad():
        for impl in impls:
            for rows in rows_used:
                case = f"B1 {impl} D={x_all.shape[1]} R={rows}"
                x2d = x_all[:rows].contiguous()
                got = harmonic.harmonic_dense_fwd(x2d, w, bias, freqs, impl, wi)
                again = harmonic.harmonic_dense_fwd(x2d, w, bias, freqs, impl,
                                                    wi)
                want = harmonic.harmonic_dense_plain(x2d, w, bias, freqs, impl)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all() or not torch.equal(got, again):
                    fail(f"{case}: non-finite output, or two launches differ")
                err = float((got - want).abs().max())
                if not err <= TOL_B1:
                    fail(f"{case}: {err:.3e} from its plain version (tol "
                         f"{TOL_B1:g})")
                out[(impl, rows)] = err
    return out


def check_b1_bwd(torch, harmonic, x_all, g_all, enc, impls, rows_used,
                 dx_cases) -> dict:
    """B1-bwd against its plain version on the first rows of ``x_all`` and
    ``g_all`` for each of ``impls``, ``rows_used`` and ``dx_cases`` (dx
    asked for or not), launched twice for bit-identity; dx, dW and db each
    within TOL_B1_BWD of max|ref|. Fails on any case; returns {(impl,
    rows, need_dx): {name: (max abs err, err / max|ref|)}}."""
    w, _, freqs, wi = enc
    out = {}
    with torch.no_grad():
        for impl in impls:
            for rows in rows_used:
                x2d, gr = x_all[:rows].contiguous(), g_all[:rows].contiguous()
                for dx_on in dx_cases:
                    case = (f"B1-bwd {impl} D={x2d.shape[1]} R={rows} need_dx="
                            f"{dx_on}")
                    got = harmonic.harmonic_dense_bwd(x2d, gr, w, freqs, impl,
                                                      wi, need_dx=dx_on)
                    again = harmonic.harmonic_dense_bwd(x2d, gr, w, freqs, impl,
                                                        wi, need_dx=dx_on)
                    want = harmonic.harmonic_dense_bwd_plain(
                        x2d, gr, w, freqs, impl, need_dx=dx_on)
                    torch.cuda.synchronize()
                    errs = {}
                    for name, a, a2, ref in zip(("dx", "dW", "db"), got, again,
                                                want):
                        if (a is None) != (name == "dx" and not dx_on):
                            fail(f"{case}: {name} is {a}")
                        if a is None:
                            continue
                        if not torch.isfinite(a).all() or not torch.equal(a, a2):
                            fail(f"{case} {name}: non-finite, or two launches "
                                 "differ")
                        err = float((a - ref).abs().max())
                        scale = float(ref.abs().max())
                        if not err <= TOL_B1_BWD * scale:
                            fail(f"{case} {name}: {err:.3e} > {TOL_B1_BWD:g} x "
                                 f"max|ref| {scale:.3e}")
                        errs[name] = (err, err / scale)
                    out[(impl, rows, dx_on)] = errs
    return out


def b1_times(torch, harmonic, x_all, g_all, enc, rows_used) -> dict:
    """B1's times at each of ``rows_used``, per call from Python by CUDA
    events: the forward (direct and doubling) and dW+db without and with dx
    (direct; dW+db also doubling), the plain versions, the bounds, and
    cuBLAS's f32 products alone on a precomputed embedding (no trig: the
    forward's F.linear and dW's g.t() @ embed); each kernel's profiler
    device us/launch."""
    from motionmixerconv_tpu_torch.models.encoding import harmonic_features

    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the cuBLAS yardsticks would not be float32")
    w, bias, freqs, wi = enc
    d, n, e = x_all.shape[1], freqs.numel(), w.shape[0]
    fwd, bwd, dev = {}, {}, {}
    with torch.no_grad():
        for rows in rows_used:
            x2d, gr = x_all[:rows].contiguous(), g_all[:rows].contiguous()
            feats = harmonic_features(x2d, n, float(freqs[0]), "direct", freqs)
            for dx_on in (False, True):
                bwd[(rows, dx_on)] = {
                    "ms": cuda_ms(torch, lambda: harmonic.harmonic_dense_bwd(
                        x2d, gr, w, freqs, "direct", wi, need_dx=dx_on),
                        reps=10),
                    "plain_ms": cuda_ms(
                        torch, lambda: harmonic.harmonic_dense_bwd_plain(
                            x2d, gr, w, freqs, "direct", need_dx=dx_on),
                        reps=10),
                    "bound": bound(*b1_bwd_work(rows, d, n, e, "direct",
                                                dx_on))}
            bwd[(rows, False)]["doubling_ms"] = cuda_ms(
                torch, lambda: harmonic.harmonic_dense_bwd(
                    x2d, gr, w, freqs, "doubling", wi, need_dx=False), reps=10)
            bwd[(rows, False)]["library_ms"] = cuda_ms(
                torch, lambda: gr.t() @ feats, reps=10)
            fwd[rows] = {
                "ms": cuda_ms(torch, lambda: harmonic.harmonic_dense_fwd(
                    x2d, w, bias, freqs, "direct", wi), reps=10),
                "doubling_ms": cuda_ms(torch, lambda: harmonic.harmonic_dense_fwd(
                    x2d, w, bias, freqs, "doubling", wi), reps=10),
                "plain_ms": cuda_ms(torch, lambda: harmonic.harmonic_dense_plain(
                    x2d, w, bias, freqs, "direct"), reps=10),
                "bound": bound(*b1_work(rows, d, n, e, "direct")),
                "library_ms": cuda_ms(
                    torch, lambda: torch.nn.functional.linear(feats, w, bias),
                    reps=10)}
            for k in B1_FWD_KERNELS:
                dev[f"fwd R={rows} {k}"] = device_us(
                    torch, lambda: harmonic.harmonic_dense_fwd(
                        x2d, w, bias, freqs, "direct", wi), k, reps=5)
            for k in B1_BWD_KERNELS:
                dev[f"bwd+dx R={rows} {k}"] = device_us(
                    torch, lambda: harmonic.harmonic_dense_bwd(
                        x2d, gr, w, freqs, "direct", wi, need_dx=True), k,
                    reps=5)
    return {"fwd": fwd, "bwd": bwd, "device_us": dev}


def fmt_b1_times(t: dict) -> str:
    return (
        "B1-fwd kernel (doubling) / plain / cuBLAS F.linear(embed, W, b) ms "
        "(bound ms, by): " + " ; ".join(
            f"R={r} {v['ms']:.4f} ({v['doubling_ms']:.4f}) / "
            f"{v['plain_ms']:.4f} / {v['library_ms']:.4f} ({v['bound'][0]:.5f}"
            f", {v['bound'][1]})" for r, v in t["fwd"].items())
        + " | B1-bwd direct kernel / plain ms (bound ms, by): " + " ; ".join(
            f"R={r} {'dW+db+dx' if dx else 'dW+db'} {v['ms']:.4f} / "
            f"{v['plain_ms']:.4f} ({v['bound'][0]:.5f}, {v['bound'][1]})"
            for (r, dx), v in t["bwd"].items())
        + " | dW+db doubling ms, cuBLAS g.t() @ embed ms: " + " ; ".join(
            f"R={r} {v['doubling_ms']:.4f}, {v['library_ms']:.4f}"
            for (r, dx), v in t["bwd"].items() if not dx)
        + " | profiler device us/launch: " + " ; ".join(
            f"{k} {'not measured' if v is None else f'{v:.2f}'}"
            for k, v in t["device_us"].items()))


def check_b2(torch, lib, tag, fused, y_all, batches) -> dict:
    """B2 against its plain version for ``fused`` (a ``FusedConvMixer``) on
    the first B rows of ``y_all`` (its encoder's output) at each B of
    ``batches``, B2_REPEATS launches of each case bit-identical; the
    kernel's weight layout and each launch plan against the library and
    the card's shared memory. Fails on any case; returns {B: {"err",
    "plan", "fit"}}."""
    from motionmixerconv_tpu_torch.ops import conv_mixer

    spec, wts = fused.spec, fused.weights
    dims = (spec.T, spec.E, spec.P, spec.D, spec.H, spec.num_blocks,
            *spec.k1, *spec.k2)
    if lib.mmc_conv_mixer_weights_numel(*dims) != spec.numel():
        fail(f"B2 {tag}: the kernel's weight layout disagrees with "
             "ops/conv_mixer.py")
    card_smem = lib.mmc_conv_mixer_card_smem()
    out = {}
    with torch.no_grad():
        for b in batches:
            plan = conv_mixer.b2_plan(spec, b)
            fit = lib.mmc_conv_mixer_resident_blocks(plan.threads, plan.smem)
            lib_smem = lib.mmc_conv_mixer_smem_bytes(*dims)
            if lib_smem != plan.smem or not plan.smem <= card_smem or fit < 1:
                fail(f"B2 {tag} B={b}: {plan} against the library's "
                     f"{lib_smem} B, the card's {card_smem} B, {fit} resident")
            y = y_all[:b].contiguous()
            got = conv_mixer.conv_mixer_fused(y, wts, spec)
            differ = sum(not torch.equal(
                got, conv_mixer.conv_mixer_fused(y, wts, spec))
                for _ in range(B2_REPEATS - 1))
            want = conv_mixer.conv_mixer_plain(y, wts, spec)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all() or differ:
                fail(f"B2 {tag} B={b} {plan}: non-finite output, or {differ} "
                     f"of {B2_REPEATS - 1} launches differ from the first")
            err = float((got - want).abs().max())
            if not err <= TOL_B2:
                fail(f"B2 {tag} B={b}: {err:.3e} from its plain version (tol "
                     f"{TOL_B2:g})")
            out[b] = {"err": err, "plan": plan, "fit": fit}
    return out


def fmt_b2_plans(tag, checks: dict) -> str:
    return " ; ".join(f"{tag} B={b} {v['plan'].blocks} blocks x "
                      f"{v['plan'].warps} warps, {v['plan'].smem} B smem, "
                      f"{v['fit']} resident, err {v['err']:.3e}"
                      for b, v in checks.items())


def b2_times(torch, fused, y_all, batches) -> dict:
    """B2's times for ``fused`` at each B of ``batches``: the device's
    (calls queued behind a spin kernel), per call from Python and the
    plain version's by CUDA events, the host's enqueue, the bound and the
    profiler's device us/launch."""
    from motionmixerconv_tpu_torch.ops import conv_mixer

    spec, wts = fused.spec, fused.weights
    out = {}
    with torch.no_grad():
        for b in batches:
            y = y_all[:b].contiguous()

            def call():
                return conv_mixer.conv_mixer_fused(y, wts, spec)

            out[b] = {"device_ms": queued_ms(torch, call),
                      "ms": cuda_ms(torch, call),
                      "plain_ms": cuda_ms(torch, lambda: conv_mixer.conv_mixer_plain(
                          y, wts, spec), reps=10),
                      "host_ms": host_ms(torch, call),
                      "bound": bound(*b2_work(spec, b, wts.numel())),
                      "device_us": device_us(torch, call,
                                             "conv_mixer_fused_kernel")}
    return out


def fmt_b2_times(tag, times: dict) -> str:
    return " ; ".join(
        f"{tag} B={b} {v['ms']:.4f}/{v['device_ms']:.4f}/{v['plain_ms']:.4f}/"
        f"{v['host_ms']:.4f} ({v['bound'][0]:.6f}, {v['bound'][1]}; "
        + ("not measured" if v["device_us"] is None else
           f"{v['device_us']:.2f}") + ")" for b, v in times.items())


def check_b4(torch, tag, fused, model, x, batches) -> dict:
    """B4 against its plain version for ``fused`` (a ``FusedMlpMixer`` of
    ``model``) on the first B rows of ``x`` at each B of ``batches``,
    B4_REPEATS launches of each case bit-identical. Fails on any case;
    returns {B: {"err", "module_err"}} (the latter against the module's
    own forward)."""
    from motionmixerconv_tpu_torch.ops import mlp_mixer

    spec, wts = fused.spec, fused.weights
    out = {}
    with torch.no_grad():
        for b in batches:
            xb = x[:b].contiguous()
            got = mlp_mixer.mlp_mixer_fused(xb, wts, spec)
            differ = sum(not torch.equal(got, mlp_mixer.mlp_mixer_fused(
                xb, wts, spec)) for _ in range(B4_REPEATS - 1))
            want = mlp_mixer.mlp_mixer_plain(xb, wts, spec)
            module = model(xb)
            torch.cuda.synchronize()
            if not torch.isfinite(got).all() or differ:
                fail(f"B4 {tag} B={b}: non-finite output, or {differ} of "
                     f"{B4_REPEATS - 1} launches differ from the first")
            err = float((got - want).abs().max())
            if not err <= TOL_B4:
                fail(f"B4 {tag} B={b}: {err:.3e} from its plain version (tol "
                     f"{TOL_B4:g})")
            out[b] = {"err": err,
                      "module_err": float((got - module).abs().max())}
    return out


def b4_against_float64(torch, fused, x, batches) -> dict:
    """B4 and its plain version for ``fused`` on the first B rows of ``x``,
    each against the plain version evaluated in float64 on the same packed
    weights, relative to max(1, max|ref|) (a trained checkpoint's outputs
    reach the hundreds, where float32 rounding alone exceeds an absolute
    1e-4); B4_REPEATS launches of each case bit-identical. Fails on any
    case; returns {B: (kernel err, plain err, max|ref|)}."""
    from motionmixerconv_tpu_torch.ops import mlp_mixer

    spec, wts = fused.spec, fused.weights
    out = {}
    with torch.no_grad():
        for b in batches:
            xb = x[:b].contiguous()
            got = mlp_mixer.mlp_mixer_fused(xb, wts, spec)
            differ = sum(not torch.equal(got, mlp_mixer.mlp_mixer_fused(
                xb, wts, spec)) for _ in range(B4_REPEATS - 1))
            plain = mlp_mixer.mlp_mixer_plain(xb, wts, spec)
            ref = mlp_mixer.mlp_mixer_plain(xb.double(), wts.double(), spec)
            torch.cuda.synchronize()
            scale = max(1.0, float(ref.abs().max()))
            out[b] = (float((got.double() - ref).abs().max()) / scale,
                      float((plain.double() - ref).abs().max()) / scale,
                      float(ref.abs().max()))
            if not torch.isfinite(got).all() or differ \
                    or not out[b][0] <= TOL_B4:
                fail(f"B4 B={b}: {out[b]} against float64 (tol {TOL_B4:g})"
                     f", or {differ} of {B4_REPEATS - 1} launches differ")
    return out


def b4_times(torch, fused, x, n_model, batches) -> dict:
    """B4's times for ``fused`` at each B of ``batches``: per call from
    Python and the plain version's by CUDA events, the device's (calls
    queued), the bound (``n_model`` the model's own floats) and the
    profiler's device us/launch, which must show."""
    from motionmixerconv_tpu_torch.ops import mlp_mixer

    spec, wts = fused.spec, fused.weights
    out = {}
    with torch.no_grad():
        for b in batches:
            xb = x[:b].contiguous()

            def call():
                return mlp_mixer.mlp_mixer_fused(xb, wts, spec)

            out[b] = {"ms": cuda_ms(torch, call),
                      "plain_ms": cuda_ms(torch, lambda: mlp_mixer.mlp_mixer_plain(
                          xb, wts, spec), reps=10),
                      "bound": bound(*b4_work(spec, b, n_model)),
                      "device_ms": queued_ms(torch, call),
                      "device_us": device_us(torch, call, "mlp_mixer_kernel"),
                      "launch": b4_launch(spec, b)}
            if out[b]["device_us"] is None:
                fail(f"B4 B={b}: the profiler shows no device time for "
                     "mlp_mixer_kernel")
    return out


def fmt_b4_times(tag, times: dict) -> str:
    return " ; ".join(
        f"{tag} B={b} {v['ms']:.4f}/{v['device_ms']:.4f}/{v['plain_ms']:.4f} "
        f"({v['bound'][0]:.5f}, {v['bound'][1]}; {v['device_us']:.2f}); "
        f"{v['launch']}" for b, v in times.items())


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


def cli_args(cli, argv):
    """A training CLI's parsed flags, with the kernel shape its ``main``
    adds before training."""
    args = cli.parse_args(argv)
    if hasattr(args, "kernel1_x"):
        args.conv1_kernel_shape = (args.kernel1_x, args.kernel1_y)
    return args


def cli_models(torch):
    """The models of phases 17-20 at their CLIs' defaults, built from the
    flags as a checkpoint's meta rebuilds them (seeded, CPU): the angle
    ConvMixer and MlpMixer of ``train_mixer_h36m``, the direct and
    autoregressive AIS ConvMixers."""
    from motionmixerconv_tpu_torch.cli import (train_autoreg_mixer_ais,
                                               train_mixer_ais,
                                               train_mixer_h36m)
    from motionmixerconv_tpu_torch.cli._runner import model_from_checkpoint_meta

    torch.manual_seed(SEED + 11)
    return {tag: model_from_checkpoint_meta(vars(cli_args(cli, argv))).eval()
            for tag, cli, argv in (
                ("angle", train_mixer_h36m, []),
                ("ais", train_mixer_ais, []),
                ("ais_ar", train_autoreg_mixer_ais, []),
                ("angle_mlp", train_mixer_h36m, ["--model_type", "mlp"]))}


def new_shape_kernels(torch, dev, lib, card, models) -> dict:
    """Phase 17: B1-fwd, B1-bwd, B2 and B4 at the shapes the angle and AIS
    paths give them, through the checks and timers of phases 3-4, 6-7, 10,
    14 and 16; each plan against the library and the card. Returns the
    numbers the kernels line takes."""
    from motionmixerconv_tpu_torch.ops import conv_mixer, harmonic, mlp_mixer

    b1_plans = check_b1_plans(lib, harmonic, torch, B1_ANGLE_SHAPE,
                              B1_ANGLE_ROWS)
    d, n, e = B1_ANGLE_SHAPE
    enc = encoder_params(models["angle"].to(dev).encoder)
    if tuple(enc[0].shape) != (e, 2 * n * d):
        fail(f"B1 angle: encoder weight {tuple(enc[0].shape)}, not the shape "
             f"{B1_ANGLE_SHAPE}")
    gen = torch.Generator().manual_seed(SEED + 13)
    x_all = (torch.randn(max(B1_ANGLE_ROWS), d, generator=gen) * 0.5).to(dev)
    g_all = torch.randn(max(B1_ANGLE_ROWS), e, generator=gen).to(dev)
    out = {"b1_fwd": check_b1_fwd(torch, harmonic, x_all, enc, ("direct",),
                                  B1_ANGLE_ROWS),
           "b1_bwd": check_b1_bwd(torch, harmonic, x_all, g_all, enc,
                                  ("direct",), B1_ANGLE_ROWS, (False, True)),
           "b1_times": b1_times(torch, harmonic, x_all, g_all, enc,
                                B1_ANGLE_ROWS),
           "b2": {}, "b2_times": {}}
    for tag in ("angle", "ais", "ais_ar"):
        model = models[tag].to(dev)
        fused = conv_mixer.make_fused_conv_mixer(model)
        x = (torch.randn(max(B2_BATCHES), fused.spec.T, model.dimPosIn,
                         generator=gen) * 0.5).to(dev)
        with torch.no_grad():
            y_all = fused.encoder(x)[..., 0].contiguous()
        out["b2"][tag] = check_b2(torch, lib, tag, fused, y_all, B2_BATCHES)
        out["b2_times"][tag] = b2_times(torch, fused, y_all, B2_NEW_TIMED)
    model = models["angle_mlp"].to(dev)
    fused = mlp_mixer.make_fused_mlp_mixer(model)
    x = (torch.randn(max(B4_ANGLE_BATCHES), fused.spec.T, fused.spec.D,
                     generator=gen) * 0.5).to(dev)
    out["b4"] = check_b4(torch, "angle", fused, model, x, B4_ANGLE_BATCHES)
    out["b4_times"] = b4_times(torch, fused, x, model_floats(model),
                               B4_ANGLE_BATCHES)
    say(f"[17 kernels at the angle and AIS shapes] {card} | B1 (D, n, E) = "
        f"{B1_ANGLE_SHAPE}, direct: fwd err " + " ; ".join(
            f"R={r} {v:.3e}" for (_, r), v in out["b1_fwd"].items())
        + f" (tol {TOL_B1:g}) | bwd err/max|ref| " + " ; ".join(
            f"R={r} {'dW+db+dx' if dx else 'dW+db'} " + ", ".join(
                f"{k} {x[1]:.3e}" for k, x in v.items())
            for (_, r, dx), v in out["b1_bwd"].items())
        + f" (tol {TOL_B1_BWD:g}); second launches bit-identical; launch "
        f"plans (library agrees): {b1_plans} | {fmt_b1_times(out['b1_times'])}"
        f" | B2 (tol {TOL_B2:g}; {B2_REPEATS} launches of each case "
        "bit-identical; plans, library and card agree): " + " ; ".join(
            fmt_b2_plans(t, v) for t, v in out["b2"].items())
        + " | B2 ms per call/device/plain/host enqueue (bound ms, by; "
        "profiler device us/launch): " + " ; ".join(
            fmt_b2_times(t, v) for t, v in out["b2_times"].items())
        + f" | B4 angle MlpMixer (tol {TOL_B4:g}; {B4_REPEATS} launches "
        "bit-identical) err " + " ; ".join(
            f"B={b} {v['err']:.3e}" for b, v in out["b4"].items())
        + " | B4 ms per call/device/plain (bound ms, by; profiler device "
        f"us/launch): {fmt_b4_times('angle', out['b4_times'])}")
    for m in models.values():
        m.cpu()
    return out


def served_err(torch, got, want) -> float:
    """Max abs error of a served answer, relative to max(1, max|want|)."""
    want = want.to(got.device)
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def serve_checks(torch, dev, state, x, http: bool):
    """``state`` (a train_state.pt) rebuilt and served in process (and over
    HTTP with ``serving_server --arch auto`` when ``http``) on ``x``; the
    answers against the checkpoint's plain forward (its model with the
    plain encoder). Returns (Predictor, in-process answer, its error, the
    HTTP answer's error or None)."""
    from motionmixerconv_tpu_torch import serving_server
    from motionmixerconv_tpu_torch.cli._runner import model_from_checkpoint_meta
    from motionmixerconv_tpu_torch.models.torch_io import read_weights
    from motionmixerconv_tpu_torch.serving import Predictor
    from motionmixerconv_tpu_torch.serving_server import PredictionServer

    served = Predictor.from_checkpoint(None, str(state), device=dev)
    got = served.predict(x)
    http_err = None
    if http:
        pred = serving_server.load_predictor(
            serving_server.build_parser().parse_args(
                ["--model_path", str(state), "--arch", "auto"]), dev)
        server = PredictionServer(pred, port=0, warmup=True)
        server.start_background()
        try:
            answer = post(f"http://127.0.0.1:{server.port}", "/predict",
                          {"inputs": x[:5].tolist()})["outputs"]
        finally:
            server.close()
    sd, meta = read_weights(str(state))
    plain = model_from_checkpoint_meta({**meta, "fused_encoder": False})
    plain.load_state_dict(sd, strict=True)
    with torch.no_grad():
        want = plain.to(dev).eval()(x.to(dev))
    torch.cuda.synchronize()
    if http:
        http_err = served_err(torch, torch.tensor(answer), want[:5].cpu())
    return served, got, served_err(torch, got, want), http_err


def non_finite(np, hist, names) -> list:
    """The per-epoch losses and test metrics of a CLI history that are not
    finite."""
    values = [*hist["train"], *hist["val"], *hist["test"]]
    for k in names:
        values += list(hist["metrics"][k])
    return [float(v) for v in values if not np.isfinite(float(v))]


def angle_and_ais_paths(torch, np, dev, card, work, data_dir,
                        counters) -> dict:
    """Phases 18-20: the main CLI at its true defaults (the angle loss) with
    ``--fused_encoder``, the angle autoregressive CLI, and both AIS CLIs,
    each driven with the launch ``counters`` set to 0 just before and read
    just after its checkpoint is served; then their times. Returns the
    numbers the kernels line takes."""
    from motionmixerconv_tpu_torch.cli import (_runner, train_autoreg_mixer_ais,
                                               train_autoreg_mixer_h36m,
                                               train_mixer_ais, train_mixer_h36m)
    from motionmixerconv_tpu_torch.data import AISDataset, H36MDataset, fixtures
    from motionmixerconv_tpu_torch.data.constants import (
        AIS_ALL_ACTIONS, AIS_DIM_USED, AIS_TEST_ACTIONS, AIS_TRAIN_ACTIONS,
        H36M_DIM_USED_ANGLE)
    from motionmixerconv_tpu_torch.ops import harmonic
    from motionmixerconv_tpu_torch.train import Trainer, make_optimizer

    def reset():
        for c in counters.values():
            c.reset()

    def read():
        torch.cuda.synchronize()
        return {k: c.value for k, c in counters.items()}

    out = {}
    # [18] the main CLI at its defaults: --loss_type angle (48 dims, hidden
    # 60, 3 blocks, lr 1e-2), with the fused encoder, 2 epochs as one chunk
    save = work / "runs_angle"
    shutil.rmtree(save, ignore_errors=True)
    argv = [*ANGLE_ARGV, *EPD2, "--data_dir", str(data_dir), "--save_path",
            str(save)]
    args = train_mixer_h36m.parse_args(argv)
    n_train = len(H36MDataset(str(data_dir), args.input_n, args.output_n,
                              args.skip_rate, split=0, mode="angle"))
    steps = args.n_epochs * -(-n_train // args.batch_size)
    test_ds = H36MDataset(str(data_dir), 10, 25, 1, split=2, mode="angle")
    x_angle = torch.as_tensor(np.stack(
        [test_ds[i] for i in range(32)]))[:, :10, H36M_DIM_USED_ANGLE]
    x_angle = x_angle.contiguous()
    reset()
    t0 = time.perf_counter()
    with counted_launches(harmonic, Trainer, COUNTED_METHODS) as in_run:
        hist = train_mixer_h36m.main(argv)
    run_s = time.perf_counter() - t0
    state = save / "h36_3d_25frames_ckpt" / _runner.STATE_FILE
    served, got, err, http_err = serve_checks(torch, dev, state, x_angle, True)
    launches = read()
    b1_train = {k: in_run["_train_sums"][k] for k in B1_IN_RUN}
    for p in work.glob("epd_angle*"):
        shutil.rmtree(p, ignore_errors=True)
    epd_err, epd2, epd1 = epd_check(
        torch, train_mixer_h36m.main,
        [*ANGLE_ARGV, "--data_dir", str(data_dir)], work / "epd_angle")
    names = ("euler_angle", "joint_angle")
    say(f"[18 main CLI at its defaults {' '.join(ANGLE_ARGV + EPD2)}] "
        f"loss_type {args.loss_type}, model {type(served.model).__name__} "
        f"{served.model.dimPosIn} dims, dimPosEmb {served.model.dimPosEmb}, "
        f"{served.model.num_blocks} blocks, lr {args.lr}, served through "
        f"{type(served._fused).__name__} | {n_train} train windows, batch "
        f"{args.batch_size} | train loss {hist['train']} | val (euler) "
        f"{hist['val']} | euler_angle "
        f"{[float(v) for v in hist['metrics']['euler_angle']]} | joint_angle "
        f"{[float(v) for v in hist['metrics']['joint_angle']]} | Python "
        f"launch counts on the path {launches} | device launches in the "
        f"CLI's run (the kernels' device counters, read around each training"
        f" and evaluation call): "
        f"training {b1_train} for {steps} train steps, evaluation "
        f"{in_run['_eval_sums']} | deterministic cuDNN, --epochs_per_dispatch"
        f" 2 against 1: per-epoch history max rel {epd_err:.3e} (tol "
        f"{TOL_EPD:g}; train loss {epd2['train']} against {epd1['train']}) | "
        f"train_state.pt served through B2 (b=32 test windows) vs the plain "
        f"forward: max abs err / max(1, max|out|) {err:.3e}; /predict --arch "
        f"auto b=5 {http_err:.3e} (tol {TOL_E2E:g}) | whole CLI run s "
        f"{run_s:.2f}")
    bad = non_finite(np, hist, names)
    if bad or set(hist["metrics"]) != set(names):
        fail(f"angle run: metrics {list(hist['metrics'])}, non-finite {bad}")
    for k in B1_IN_RUN:
        if b1_train[k] < steps:
            fail(f"{k}: {b1_train[k]} device launches in the angle CLI's "
                 f"{steps} train steps")
    if not epd_err <= TOL_EPD:
        fail(f"angle --epochs_per_dispatch 2 and 1 disagree: {epd_err:.3e}")
    if launches["conv_mixer_fused"] < 1 or type(served._fused).__name__ != \
            "FusedConvMixer":
        fail("the angle checkpoint was not served through B2")
    if got.shape != (32, 25, 48) or not err <= TOL_E2E \
            or not http_err <= TOL_E2E:
        fail(f"served angle checkpoint: shape {tuple(got.shape)}, err "
             f"{err:.3e}, /predict err {http_err:.3e}")
    out["angle"] = {"launches": launches, "b1_train": b1_train,
                    "steps": steps, "hist": hist, "n_train": n_train}

    # [19] the angle autoregressive CLI at its defaults (conv_nChan 60,
    # hidden 60, (5,5), 48 dims): outside B3's domain, served by the plain
    # forward with the domain named
    save = work / "runs_ar_angle"
    shutil.rmtree(save, ignore_errors=True)
    argv = [*AR_ANGLE_ARGV, *EPD2, "--data_dir", str(data_dir),
            "--save_path", str(save)]
    ar_args = train_autoreg_mixer_h36m.parse_args(argv)
    reset()
    t0 = time.perf_counter()
    ar_hist = train_autoreg_mixer_h36m.main(argv)
    ar_run_s = time.perf_counter() - t0
    state = save / "h36_ar_25frames_ckpt" / _runner.STATE_FILE
    served, got, err, _ = serve_checks(torch, dev, state, x_angle, False)
    ar_launches = read()
    reason = served.fused_fallback_reason or ""
    say(f"[19 angle autoregressive CLI {' '.join(AR_ANGLE_ARGV + EPD2)}] "
        f"model conv_nChan {served.model.conv_nChan} dimPosEmb "
        f"{served.model.dimPosEmb} kernel {served.model.conv1_kernel_shape} "
        f"{served.model.dimPosIn} dims, lr {ar_args.lr} | train loss "
        f"{ar_hist['train']} (teacher forcing, closed loop) | val "
        f"{ar_hist['val']} | euler_angle "
        f"{[float(v) for v in ar_hist['metrics']['euler_angle']]} | "
        f"joint_angle {[float(v) for v in ar_hist['metrics']['joint_angle']]}"
        f" | launches on the path {ar_launches} | served: fused kernel "
        f"{type(served._fused).__name__}, fused_fallback_reason {reason!r}; "
        f"b=32 vs the plain forward {err:.3e} | whole CLI run s "
        f"{ar_run_s:.2f}")
    bad = non_finite(np, ar_hist, names)
    if bad:
        fail(f"angle autoregressive run: non-finite {bad}")
    if served._fused is not None or "conv_nChan*in_nTP <= 128" not in reason:
        fail(f"angle autoregressive model: fused {served._fused}, reason "
             f"{reason!r}; expected B3's domain refusal")
    if got.shape != (32, 5, 48) or not err <= TOL_E2E:
        fail(f"served angle autoregressive checkpoint: shape "
             f"{tuple(got.shape)}, err {err:.3e}")
    out["angle_autoregressive"] = {"launches": ar_launches}

    # [20] AIS: the synthetic keypoint corpus, both CLIs at their default
    # widths, their checkpoints served through B2
    ais_dir = work / "ais"
    shutil.rmtree(ais_dir, ignore_errors=True)
    t0 = time.perf_counter()
    fixtures.make_ais_corpus(str(ais_dir), actions=AIS_ALL_ACTIONS,
                             n_frames=AIS_FRAMES,
                             fail_frames=frozenset(AIS_FAIL_FRAMES), seed=SEED)
    ais_corpus_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    test_ais = AISDataset(str(ais_dir), 10, 10, 2, AIS_TEST_ACTIONS, 0.15)
    ais_parse_s = time.perf_counter() - t0
    x_ais = torch.as_tensor(np.stack(
        [test_ais[int(i)] for i in np.linspace(0, len(test_ais) - 1, 32)]
    ))[:, :10, AIS_DIM_USED]
    x_ais = x_ais.contiguous()
    ais = {}
    for tag, cli, extra, http in (
            ("ais", train_mixer_ais, AIS_ARGV, True),
            ("ais_autoregressive", train_autoreg_mixer_ais, AIS_AR_ARGV,
             False)):
        save = work / f"runs_{tag}"
        shutil.rmtree(save, ignore_errors=True)
        argv = [*extra, *EPD2, "--data_dir", str(ais_dir), "--save_path",
                str(save)]
        a = cli_args(cli, argv)
        window = ((a.input_n, a.output_n) if hasattr(a, "input_n")
                  else (a.input_n_dataset, a.output_n_dataset))
        n_tr = len(AISDataset(str(ais_dir), *window, a.skip_rate,
                              AIS_TRAIN_ACTIONS, a.smoothing_alpha))
        reset()
        t0 = time.perf_counter()
        h = cli.main(argv)
        run_s = time.perf_counter() - t0
        state = next(save.glob(f"*/{_runner.STATE_FILE}"))
        served, got, err, http_err = serve_checks(torch, dev, state, x_ais,
                                                  http)
        ais[tag] = {"hist": h, "launches": read(), "err": err,
                    "http_err": http_err, "run_s": run_s, "n_train": n_tr,
                    "steps": -(-n_tr // a.batch_size),
                    "shape": tuple(got.shape), "served": served}
    d, ar = ais["ais"], ais["ais_autoregressive"]
    say(f"[20 AIS CLIs {' '.join(AIS_ARGV + EPD2)}; "
        f"{' '.join(AIS_AR_ARGV + EPD2)}] corpus: {len(AIS_ALL_ACTIONS)} "
        f"actions x {AIS_FRAMES} frames, {len(AIS_FAIL_FRAMES)} failed "
        f"detections each, written in {ais_corpus_s:.1f} s (test split "
        f"parsed in {ais_parse_s:.2f} s) | " + " | ".join(
            f"{tag}: {v['n_train']} train windows, model "
            f"{v['served'].model.dimPosIn} dims, dimPosEmb "
            f"{v['served'].model.dimPosEmb}, kernel "
            f"{v['served'].model.conv1_kernel_shape}, harmonics "
            f"{v['served'].model.encoder_n_harmonic_functions}, served "
            f"through {type(v['served']._fused).__name__}; train loss "
            f"{v['hist']['train']}, val {v['hist']['val']}, test mpjpe mm "
            f"{[float(x) for x in v['hist']['metrics']['mpjpe']]}, auc_pck "
            f"{[float(x) for x in v['hist']['metrics']['auc_pck']]}; "
            f"launches on the path {v['launches']}; served b=32 vs the plain "
            f"forward {v['err']:.3e}"
            + ("" if v["http_err"] is None else
               f", /predict --arch auto b=5 {v['http_err']:.3e}")
            + f" (tol {TOL_E2E:g}); whole CLI run s {v['run_s']:.2f}"
            for tag, v in ais.items()))
    for tag, v in ais.items():
        bad = non_finite(np, v["hist"], ("mpjpe", "auc_pck"))
        if bad:
            fail(f"{tag} run: non-finite {bad}")
        if v["launches"]["conv_mixer_fused"] < 1:
            fail(f"the {tag} checkpoint was not served through B2")
        if not v["err"] <= TOL_E2E or not (v["http_err"] is None
                                           or v["http_err"] <= TOL_E2E):
            fail(f"served {tag} checkpoint: err {v['err']:.3e}, /predict "
                 f"{v['http_err']}")
    if not d["hist"]["train"][1] < d["hist"]["train"][0]:
        fail(f"AIS run: the train loss did not fall: {d['hist']['train']}")
    if d["shape"] != (32, 10, 33) or ar["shape"] != (32, 5, 33):
        fail(f"served AIS shapes {d['shape']}, {ar['shape']}")
    out.update({tag: {"launches": v["launches"]} for tag, v in ais.items()})

    # times of [18] and [20]: train steps on random windows, the graph path
    # against scan=False; the angle graph held to its eager steps (the
    # L1 loss, the euler validation and the h36m_angle test under capture)
    def trainer_for(cli, argv, **kw):
        def make(**opt):
            a = cli_args(cli, argv)
            torch.manual_seed(SEED + 14)
            model = _runner.model_from_checkpoint_meta(vars(a)).to(dev)
            return Trainer(model, make_optimizer(model.parameters(), lr=a.lr,
                                                 **opt),
                           loss_type=a.loss_type, **kw)
        return make

    make_angle = trainer_for(train_mixer_h36m, ANGLE_ARGV,
                             dim_used=H36M_DIM_USED_ANGLE, input_n=10,
                             output_n=25, input_scale=1.0)
    frames, starts, w = random_batches(torch, dev, SEED + 14, 5000, 99, 1.0,
                                       35, 3 * GRAPH_STEPS, TRAIN_BATCH)
    ev_starts = np.random.default_rng(SEED + 14).integers(0, 5000 - 35, 900)
    angle_graph = graph_vs_eager(
        torch, lambda: make_angle(**GRAPH_SCHEDULE), frames, starts, w,
        [None],
        [("val", 1, frames, ev_starts, np.zeros(900, np.int64), TRAIN_BATCH),
         ("h36m_angle", 3, frames, ev_starts, np.arange(900) % 3, 128)])
    check_graph("angle", angle_graph)
    angle_times = train_times(torch, make_angle(), frames, starts, w, None)
    make_ais = trainer_for(train_mixer_ais, [],
                           dim_used=AIS_DIM_USED, input_n=10, output_n=10)
    frames, starts, w = random_batches(torch, dev, SEED + 15, 5000, 57, 0.3,
                                       20, 3 * GRAPH_STEPS, TRAIN_BATCH)
    ais_times = train_times(torch, make_ais(), frames, starts, w, None)
    a_hist = out["angle"]["hist"]
    steps_a = out["angle"]["steps"] // 2
    say(f"[18/20 times] {card} | angle CLI epochs 0, 1 as one chunk (each "
        f"the chunk's / 2, validation and test included; phase 18's run, "
        f"the device counters read around each call, and the epd check's "
        f"run under deterministic cuDNN): train s "
        f"{a_hist['train_s'][0]:.3f}, {epd2['train_s'][0]:.3f} | train "
        f"samples/s {n_train / a_hist['train_s'][0]:.1f}, "
        f"{n_train / epd2['train_s'][0]:.1f} | step ms "
        f"{a_hist['train_s'][0] / steps_a * 1e3:.3f}, "
        f"{epd2['train_s'][0] / steps_a * 1e3:.3f} ({steps_a} steps) | AIS "
        + " ; ".join(
            f"{tag} epochs 0, 1: train s {v['hist']['train_s'][0]:.3f} | "
            f"train samples/s {v['n_train'] / v['hist']['train_s'][0]:.1f} | "
            f"step ms {v['hist']['train_s'][0] / v['steps'] * 1e3:.3f} "
            f"({v['steps']} steps)" for tag, v in ais.items())
        + f" | angle graph against eager (no dropout, deterministic cuDNN): "
        f"{fmt_graph(angle_graph)} | angle train steps (fused encoder, batch "
        f"{TRAIN_BATCH}): {fmt_times(angle_times)} | AIS train steps (batch "
        f"{TRAIN_BATCH}, dropout 0.1): {fmt_times(ais_times)}")
    out["times"] = {"angle": angle_times, "ais": ais_times,
                    "angle_graph": angle_graph}
    return out


def anchor_model(variables):
    """The committed JAX checkpoint's MlpMixer, which stores no meta: its
    widths from its array shapes, the rest at the AMASS test CLI's
    defaults."""
    from motionmixerconv_tpu_torch.cli import test_mixer_amass
    from motionmixerconv_tpu_torch.models import MlpMixer

    p = variables["params"]
    d, hidden = p["conv"]["kernel"].shape
    t, tokens = p["Mixer_Block_0"]["mlp_block_token_mixing"]["fc1"]["kernel"].shape
    channels = p["Mixer_Block_0"]["mlp_block_channel_mixing"]["fc1"]["kernel"].shape[1]
    defaults = test_mixer_amass.parse_args(["--model_path", ANCHOR])
    return MlpMixer(
        num_classes=d, num_blocks=sum(k.startswith("Mixer_Block_") for k in p),
        hidden_dim=hidden, tokens_mlp_dim=tokens, channels_mlp_dim=channels,
        seq_len=t, pred_len=p["conv_out"]["kernel"].shape[1],
        activation=defaults.activation, regularization=defaults.regularization,
        input_size=d, r_se=defaults.r_se, use_se=True)


def fused_vs_model(torch, pred, x, batches) -> dict:
    """{B: max abs error} of ``pred.predict`` (its fused kernel) against
    its model's plain forward on the first B rows of ``x``."""
    errs = {}
    with torch.no_grad():
        for b in batches:
            xb = x[:b].to(pred.device)
            errs[b] = float((pred.predict(xb) - pred.model(xb)).abs().max())
    torch.cuda.synchronize()
    return errs


def checkpoint_interchange(torch, np, dev, card, work, data_dir, counters,
                           steps_per_epoch: int) -> dict:
    """Phase 21: the committed JAX checkpoint served through B4; phase 9's
    trained flagship written by the port as a JAX .ckpt, read back
    bit-identical, served through B2 and the bulk path (B1-fwd)
    bit-identical to its train_state.pt, and evaluated by
    cli.test_mixer_h36m as the train_state.pt is (launch counts reset just
    before and read just after). Returns the kernels line's numbers."""
    from motionmixerconv_tpu_torch.cli import _runner, test_mixer_h36m
    from motionmixerconv_tpu_torch.ops import mlp_mixer
    from motionmixerconv_tpu_torch.serving import Predictor
    from motionmixerconv_tpu_torch.train import make_optimizer
    from motionmixerconv_tpu_torch.train.state import (read_jax_checkpoint,
                                                       restore_checkpoint,
                                                       save_jax_checkpoint)

    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    anchor = read_jax_checkpoint(ANCHOR)
    if anchor.meta is not None:
        fail(f"{ANCHOR}: expected no meta, found {sorted(anchor.meta)}")
    served = Predictor.from_checkpoint(
        None, ANCHOR, device=dev,
        model_factory=lambda: anchor_model(anchor.variables))
    if not isinstance(served._fused, mlp_mixer.FusedMlpMixer):
        fail(f"the JAX checkpoint is not served by B4: "
             f"{served.fused_fallback_reason}")
    gen = torch.Generator().manual_seed(SEED + 21)
    spec = served._fused.spec
    x_anchor = torch.randn(128, spec.T, spec.D, generator=gen) * 0.5
    anchor_errs = fused_vs_model(torch, served, x_anchor, ANCHOR_BATCHES)

    # phase 9's flagship, its train_state.pt written again as a JAX .ckpt
    state_pt = work / "runs_0" / "h36_3d_25frames_ckpt" / _runner.STATE_FILE
    payload = torch.load(state_pt, map_location="cpu", weights_only=True)
    meta = payload["meta"]

    def model_and_optimizer():
        model = _runner.model_from_checkpoint_meta(meta)
        opt = make_optimizer(
            model.parameters(), lr=meta["lr"],
            use_scheduler=meta["use_scheduler"], milestones=meta["milestones"],
            gamma=meta["gamma"], steps_per_epoch=steps_per_epoch,
            clip_grad=meta["clip_grad"])
        return model, opt

    model, opt = model_and_optimizer()
    model.load_state_dict(payload["model"], strict=True)
    opt.load_state_dict(payload["optimizer"])
    ckpt = work / "flagship.ckpt"
    save_jax_checkpoint(str(ckpt), model, opt, payload["epoch"], meta=meta,
                        seed=meta.get("seed", 0))
    back = read_jax_checkpoint(str(ckpt))
    sd = back.state_dict()
    want_keys = set(payload["model"]) - {"encoder.frequencies"}
    if set(sd) != want_keys or back.meta != meta \
            or back.epoch != payload["epoch"]:
        fail(f"{ckpt}: keys, meta or epoch differ from {state_pt}")
    differ = [k for k in sd if not torch.equal(sd[k], payload["model"][k])]
    clone, opt2 = model_and_optimizer()
    restore_checkpoint(str(ckpt), clone, opt2)
    differ += [f"adam {k}" for p, q in zip(opt.params, opt2.params)
               for k in ("exp_avg", "exp_avg_sq", "step")
               if not torch.equal(opt.adam.state[p][k].cpu(),
                                  opt2.adam.state[q][k].cpu())]
    if differ or (opt2.steps, opt2.lr) != (opt.steps, opt.lr):
        fail(f"{ckpt} read back differs from {state_pt}: {differ[:5]}, "
             f"steps/lr {(opt2.steps, opt2.lr)} vs {(opt.steps, opt.lr)}")

    served_pt = Predictor.from_checkpoint(None, str(state_pt), device=dev)
    served_ck = Predictor.from_checkpoint(None, str(ckpt), device=dev)
    x = torch.randn(BULK_ROWS, 10, 66, generator=gen) * 0.5
    same, errs = {}, {}
    plain = _runner.model_from_checkpoint_meta({**meta, "fused_encoder": False})
    plain.load_state_dict(payload["model"], strict=True)
    plain = plain.to(dev).eval()
    with torch.no_grad():
        for b in (1, 32, BULK_ROWS):
            got = served_ck.predict(x[:b])
            same[b] = torch.equal(got, served_pt.predict(x[:b]))
            errs[b] = served_err(torch, got, plain(x[:b].to(dev)))
    torch.cuda.synchronize()
    cli = {}
    for tag, path in (("ckpt", ckpt), ("pt", state_pt)):
        cli[tag] = test_mixer_h36m.main(
            ["--data_dir", str(data_dir), "--model_path", str(path),
             "--actions_to_consider", "walking"])
    launches = {k: c.value for k, c in counters.items()}
    seconds = time.perf_counter() - t0
    # timed after the path's counts are read: these launches are not its
    anchor_t = b4_times(torch, served._fused, x_anchor.to(dev),
                        model_floats(served.model), ANCHOR_BATCHES)
    cli_rel = max(abs(a - b) / abs(b) for a, b in zip(cli["ckpt"], cli["pt"]))
    say(f"[21 checkpoint interchange] {card} | committed JAX checkpoint "
        f"(no meta; the MlpMixer of its shapes: hidden "
        f"{served.model.hidden_dim}, {served.model.num_blocks} blocks) "
        f"through B4 vs the plain forward: " + " ; ".join(
            f"B={b} {e:.3e}" for b, e in anchor_errs.items())
        + f" (tol {TOL_B4:g}); B4 ms per call/device/plain (bound ms, by; "
        f"profiler device us/launch): {fmt_b4_times('jax_ckpt', anchor_t)}"
        f" | phase 9's flagship written as {ckpt.name}: "
        f"{len(sd)} tensors bit-identical to train_state.pt, Adam moments and"
        f" count ({opt2.steps} steps, lr {opt2.lr:g}) restored bit-identical"
        f" | served from the .ckpt: bit-identical to the .pt route "
        + ", ".join(f"b={b} {v}" for b, v in same.items())
        + " (B2 at b <= 128, the bulk forward with B1-fwd at b = "
        f"{BULK_ROWS}); vs the plain encoder's forward max abs err / max(1, "
        "max|out|) " + ", ".join(f"b={b} {e:.3e}" for b, e in errs.items())
        + f" (tol {TOL_E2E:g}) | cli.test_mixer_h36m walking: .ckpt "
        f"{cli['ckpt']}, train_state.pt {cli['pt']} (max rel {cli_rel:.3e}) "
        f"| launches on the path {launches} | {seconds:.1f} s")
    if not all(e <= TOL_B4 for e in anchor_errs.values()):
        fail(f"the JAX checkpoint served through B4: {anchor_errs}")
    if not all(same.values()) or not all(e <= TOL_E2E for e in errs.values()):
        fail(f"the .ckpt served unlike the .pt: {same}, {errs}")
    if cli_rel != 0.0:
        fail(f"cli.test_mixer_h36m: .ckpt {cli['ckpt']} vs .pt {cli['pt']}")
    for k in ("mlp_mixer_fused", "conv_mixer_fused", "harmonic_dense_fwd"):
        if launches[k] < 1:
            fail(f"{k} was not launched on the checkpoint interchange path")
    return {"launches": launches, "anchor_err": max(anchor_errs.values()),
            "b4_times": anchor_t, "seconds": seconds}


class TimedObjective:
    """Wraps a study module's ``Objective`` to record each trial's
    wall-clock seconds in ``times`` under (tag, trial number)."""

    def __init__(self, module, times: dict, tag: str):
        self.module, self.times, self.tag = module, times, tag

    def __enter__(self):
        base = self.orig = self.module.Objective
        times, tag = self.times, self.tag

        class Timed(base):
            def __call__(self, trial):
                t0 = time.perf_counter()
                try:
                    return super().__call__(trial)
                finally:
                    times[(tag, trial.number)] = time.perf_counter() - t0

        self.module.Objective = Timed
        return self

    def __exit__(self, *exc):
        self.module.Objective = self.orig


def study_trials(study_dir) -> tuple:
    """A study's results.db read by the port's Study: (the study, the
    (number, state, values) of every trial)."""
    from motionmixerconv_tpu_torch.sweep.engine import Study

    study = Study(study_dir.name, storage=f"sqlite:///{study_dir}/results.db")
    return study, [(t.number, t.state, t.values) for t in study.trials]


def check_trials(tag, rows, n) -> None:
    if len(rows) != n or any(s not in ("COMPLETE", "PRUNED") for _, s, _ in rows):
        fail(f"{tag}: expected {n} trials, each COMPLETE or PRUNED: {rows}")


def state_of(trial_dir, run: str):
    """The train_state.pt of a trial's run named by the glob ``run``."""
    found = sorted(trial_dir.glob(f"{run}/train_state.pt"))
    if len(found) != 1:
        fail(f"expected one {run}/train_state.pt under {trial_dir}: {found}")
    return found[0]


def b3_grid(torch, dev) -> dict:
    """B3 with random weights at every kernel shape of conv_study's grid
    (conv_nChan 8, dimPosEmb 192, 6 blocks), B = 1 and 128, against its
    plain version and a second launch bit-identical: {(kh, kw): max abs
    err}."""
    from motionmixerconv_tpu_torch.models import ConvMixer
    from motionmixerconv_tpu_torch.ops import conv_mixer, conv_mixer_mc

    gen = torch.Generator().manual_seed(SEED + 22)
    x = (torch.randn(128, 10, 66, generator=gen) * 0.5).to(dev)
    errs = {}
    with torch.no_grad():
        for k in STUDY_GRID:
            model = ConvMixer(**dict(STUDY, conv1_kernel_shape=k),
                              generator=gen).eval().to(dev)
            fused = conv_mixer.make_fused_conv_mixer(model)
            if not isinstance(fused, conv_mixer_mc.FusedConvMixerMC):
                fail(f"B3 grid {k}: the factory returned "
                     f"{type(fused).__name__}")
            y_all = fused.encoder(x).permute(0, 3, 1, 2).contiguous()
            err = 0.0
            for b in (1, 128):
                y = y_all[:b].contiguous()
                got = conv_mixer_mc.conv_mixer_mc_fused(y, fused.weights,
                                                        fused.spec)
                again = conv_mixer_mc.conv_mixer_mc_fused(y, fused.weights,
                                                          fused.spec)
                want = conv_mixer_mc.conv_mixer_mc_plain(y, fused.weights,
                                                         fused.spec)
                torch.cuda.synchronize()
                if not torch.isfinite(got).all() or not torch.equal(got, again):
                    fail(f"B3 grid {k} B={b}: non-finite or a second launch "
                         "differs")
                err = max(err, float((got - want).abs().max()))
            errs[k] = err
    return errs


def study_paths(torch, np, dev, card, work, data_dir, counters) -> dict:
    """Phases 22-23: conv_study at its default widths on the card (one
    grid trial at --n_jobs 1, then two at --n_jobs 2 with the median
    pruner), its best trial served through B3, B3 at every kernel shape of
    its grid; mlp_study (TPE, 2 trials) served through B4; autoreg_study
    (1 AIS grid trial) served through B3. Launch counts reset just before
    each study and read just after its serving. Returns the kernels line's
    numbers."""
    from types import SimpleNamespace

    from motionmixerconv_tpu_torch.cli._runner import model_from_checkpoint_meta
    from motionmixerconv_tpu_torch.data import AISDataset, H36MDataset
    from motionmixerconv_tpu_torch.data.constants import (AIS_DIM_USED,
                                                          AIS_TEST_ACTIONS,
                                                          H36M_DIM_USED_XYZ)
    from motionmixerconv_tpu_torch.ops import conv_mixer_mc, mlp_mixer
    from motionmixerconv_tpu_torch.serving import Predictor
    from motionmixerconv_tpu_torch.sweep import (autoreg_study, conv_study,
                                                 mlp_study, optuna_export)

    def reset():
        for c in counters.values():
            c.reset()

    def read():
        torch.cuda.synchronize()
        return {k: c.value for k, c in counters.items()}

    def serve_trial(state, build, kernel_cls, x, batches):
        """A trial's train_state.pt (its meta rebuilt by ``build``) through
        its fused kernel on the first B windows of ``x`` (test windows, as
        the trainer scales them), against its plain forward: ({B: (max abs
        error / max(1, max|out|), max|out|)}, the Predictor)."""
        payload = torch.load(state, map_location="cpu", weights_only=True)
        model = build(SimpleNamespace(**payload["meta"]))
        pred = Predictor(model, payload["model"], device=dev)
        if not isinstance(pred._fused, kernel_cls):
            fail(f"{state}: served by {type(pred._fused).__name__}, not "
                 f"{kernel_cls.__name__}: {pred.fused_fallback_reason}")
        errs = {}
        with torch.no_grad():
            for b in batches:
                xb = x[:b].to(dev)
                want = pred.model(xb)
                errs[b] = (served_err(torch, pred.predict(xb), want),
                           float(want.abs().max()))
        if not all(e <= TOL_E2E for e, _ in errs.values()):
            fail(f"{state} through {kernel_cls.__name__}: {errs} (tol "
                 f"{TOL_E2E:g} of max(1, max|out|))")
        return errs, pred

    def fmt_served(errs):
        return ", ".join(f"B={b} {e:.3e} (max|out| {m:.3g})"
                         for b, (e, m) in errs.items())

    # test windows as the trainers feed them: H36M xyz in meters (the
    # mpjpe trainer's input scale 1e-3), AIS keypoints in meters
    h36m_test = H36MDataset(str(data_dir), 10, 10, 1, actions=["walking"],
                            split=2)
    x_h36m = torch.as_tensor(np.stack([h36m_test[i] for i in range(128)])
                             )[:, :10, H36M_DIM_USED_XYZ] * 1e-3
    ais_test = AISDataset(str(work / "ais"), 10, 25, 2, AIS_TEST_ACTIONS,
                          0.15)
    x_ais = torch.as_tensor(np.stack(
        [ais_test[int(i)] for i in np.linspace(0, len(ais_test) - 1, 128)]
    ))[:, :10, AIS_DIM_USED]

    out, times = {}, {}
    # [22] conv_study
    study_dir = work / "conv_study"
    shutil.rmtree(study_dir, ignore_errors=True)
    argv = [*STUDY_ARGV, "--data_dir", str(data_dir), "--study_dir",
            str(study_dir)]
    reset()
    walls = {}
    with TimedObjective(conv_study, times, "conv"):
        for n_jobs, extra in ((1, ["--n_trials", "1"]),
                              (2, ["--n_trials", "2", "--pruner", "median"])):
            t0 = time.perf_counter()
            conv_study.main([*argv, *extra, "--n_jobs", str(n_jobs)])
            walls[n_jobs] = time.perf_counter() - t0
    study, rows = study_trials(study_dir)
    check_trials("conv_study", rows, 3)
    exported = work / "conv_study_optuna.db"
    exported.unlink(missing_ok=True)
    optuna_export.export_optuna_sqlite(str(study_dir / "results.db"),
                                       str(exported))
    with contextlib.closing(sqlite3.connect(exported)) as conn:
        n_exported = conn.execute("SELECT COUNT(*) FROM trials").fetchone()[0]
    if n_exported != 3:
        fail(f"optuna_export wrote {n_exported} trials, not 3")
    best = study.best_trial
    conv_errs, _ = serve_trial(
        state_of(study_dir / f"trial{best.number}", "h36m_mpjpe_*"),
        lambda a: conv_study._build_model(a, 66, a.input_n, a.output_n),
        conv_mixer_mc.FusedConvMixerMC, x_h36m, (1, 128))
    conv_launches = read()
    # the n_jobs 2 call's grid points again, one after the other in a study
    # of their own: the reference for its wall clock
    seq_dir = work / "conv_study_seq"
    shutil.rmtree(seq_dir, ignore_errors=True)
    with TimedObjective(conv_study, times, "seq"):
        conv_study.main([*STUDY_ARGV, "--data_dir", str(data_dir),
                         "--study_dir", str(seq_dir), "--n_trials", "3",
                         "--n_jobs", "1"])
    check_trials("conv_study, sequential reference", study_trials(seq_dir)[1],
                 3)
    seq_s = times[("seq", 1)] + times[("seq", 2)]
    grid = b3_grid(torch, dev)
    grid_err = max(grid.values())
    if not grid_err <= TOL_B3:
        fail(f"B3 at the conv_study grid: {grid_err:.3e} > {TOL_B3:g}")
    per_trial = {k: v for k, v in times.items() if k[0] == "conv"}
    seq_trial = {k: v for k, v in times.items() if k[0] == "seq"}
    say(f"[22 conv_study {' '.join(STUDY_ARGV)}] {card} | trials (number, "
        f"state, values) from results.db: {rows} | wall s per trial: "
        + ", ".join(f"trial {n} {v:.2f}" for (_, n), v in per_trial.items())
        + f" | study calls: --n_jobs 1 (1 trial) {walls[1]:.2f} s, --n_jobs 2"
        f" (trials 1 and 2) {walls[2]:.2f} s; the same grid points one after"
        f" the other (their own study, --n_jobs 1): trials 1 + 2 "
        f"{times[('seq', 1)]:.2f} + {times[('seq', 2)]:.2f} = {seq_s:.2f} s "
        f"(trial 0 {times[('seq', 0)]:.2f}), n_jobs 2 / sequential "
        f"{walls[2] / seq_s:.3f} | optuna_export: {n_exported} trials "
        f"| best trial {best.number} {best.params}, its train_state.pt "
        "through B3 on H36M test windows vs the plain forward, max abs err "
        f"/ max(1, max|out|): {fmt_served(conv_errs)} (tol {TOL_E2E:g}) | "
        f"launches on the path {conv_launches} | B3 at "
        f"the grid's {len(grid)} kernel shapes, B = 1 and 128, random "
        f"weights, second launch bit-identical: max abs err {grid_err:.3e} "
        "(" + ", ".join(f"{k[0]}x{k[1]} {e:.1e}" for k, e in grid.items())
        + ")")
    out["conv_study"] = {"launches": conv_launches, "walls": walls,
                         "trial_s": {str(n): v for (_, n), v in
                                     per_trial.items()},
                         "sequential_trial_s": {str(n): v for (_, n), v in
                                                seq_trial.items()},
                         "grid_err": grid_err, "served_err": max(
                             e for e, _ in conv_errs.values())}

    # [23] mlp_study and autoreg_study
    mlp_dir = work / "mlp_study"
    shutil.rmtree(mlp_dir, ignore_errors=True)
    reset()
    with TimedObjective(mlp_study, times, "mlp"):
        t0 = time.perf_counter()
        mlp_study.main([*MLP_STUDY_ARGV, "--data_dir", str(data_dir),
                        "--study_dir", str(mlp_dir)])
        mlp_wall = time.perf_counter() - t0
    study, mlp_rows = study_trials(mlp_dir)
    check_trials("mlp_study", mlp_rows, 2)
    best = study.best_trial
    mlp_errs, mlp_pred = serve_trial(
        state_of(mlp_dir / f"trial{best.number}", f"mlp_trial{best.number}"),
        lambda a: model_from_checkpoint_meta(vars(a)),
        mlp_mixer.FusedMlpMixer, x_h36m, (1, 32, 128))
    mlp_launches = read()
    # the trained weights (odd widths, folded BatchNorm where the trial
    # drew it) through B4 and its plain version, each against a float64
    # evaluation of the same packed weights
    mlp_b4 = b4_against_float64(torch, mlp_pred._fused, x_h36m.to(dev),
                                (1, 32, 128))
    ar_dir = work / "autoreg_study"
    shutil.rmtree(ar_dir, ignore_errors=True)
    reset()
    with TimedObjective(autoreg_study, times, "autoreg"):
        t0 = time.perf_counter()
        autoreg_study.main([*AR_STUDY_ARGV, "--data_dir", str(work / "ais"),
                            "--study_dir", str(ar_dir)])
        ar_wall = time.perf_counter() - t0
    _, ar_rows = study_trials(ar_dir)
    check_trials("autoreg_study", ar_rows, 1)
    ar_errs, _ = serve_trial(
        state_of(ar_dir / "trial0", "ar_mpjpe_trial0"),
        lambda a: conv_study._build_model(a, 33, a.input_n_model,
                                          a.output_n_model),
        conv_mixer_mc.FusedConvMixerMC, x_ais, (1, 128))
    ar_launches = read()
    say(f"[23 mlp_study {' '.join(MLP_STUDY_ARGV)}; autoreg_study "
        f"{' '.join(AR_STUDY_ARGV)}] {card} | mlp_study trials {mlp_rows} "
        f"(wall s per trial: " + ", ".join(
            f"trial {n} {v:.2f}" for (t, n), v in times.items() if t == "mlp")
        + f"; study {mlp_wall:.2f} s) | best trial {best.number} "
        f"{best.params} through B4 on H36M test windows vs the plain "
        f"forward: {fmt_served(mlp_errs)} (tol {TOL_E2E:g}); B4 and its "
        "plain version against a float64 evaluation of the packed weights, "
        "max abs err / max(1, max|ref|): " + ", ".join(
            f"B={b} kernel {k:.3e}, plain {p:.3e} (max|ref| {m:.4g})"
            for b, (k, p, m) in mlp_b4.items())
        + f" (tol {TOL_B4:g}; {B4_REPEATS} launches bit-identical) | launches "
        f"{mlp_launches} | autoreg_study trials {ar_rows} ({ar_wall:.2f} s),"
        f" trial 0 through B3 on AIS test windows: {fmt_served(ar_errs)} "
        f"(tol {TOL_E2E:g}) | launches {ar_launches}")
    for tag, launches, k in (("mlp_study", mlp_launches, "mlp_mixer_fused"),
                             ("autoreg_study", ar_launches, "conv_mixer_mc"),
                             ("conv_study", conv_launches, "conv_mixer_mc")):
        if launches[k] < 1:
            fail(f"{k} was not launched on the {tag} path")
    out["mlp_study"] = {"launches": mlp_launches, "wall": mlp_wall,
                        "served_err": max(e for e, _ in mlp_errs.values())}
    out["autoreg_study"] = {"launches": ar_launches, "wall": ar_wall,
                            "served_err": max(e for e, _ in ar_errs.values())}
    return out


def core_against_float64(torch, fused, x, batches) -> dict:
    """A fused model's kernel (B2, B3 or B4) and its plain version on its
    core's input for the first B rows of ``x``, each against the plain
    version in float64 on the same packed weights, relative to max(1,
    max|ref|) (trained outputs reach hundreds of mm); B2 and B3 take the
    float32 encoder's output, as served. Fails on any case; returns {B:
    (kernel err, plain err, max|ref|)}."""
    from motionmixerconv_tpu_torch.ops import conv_mixer, conv_mixer_mc

    if isinstance(fused, conv_mixer.FusedConvMixer):
        kernel, plain = conv_mixer.conv_mixer_fused, conv_mixer.conv_mixer_plain
        tol, name = TOL_B2, "B2"

        def core_in(xb):
            return fused.encoder(xb)[..., 0].contiguous()
    elif isinstance(fused, conv_mixer_mc.FusedConvMixerMC):
        kernel = conv_mixer_mc.conv_mixer_mc_fused
        plain, tol, name = conv_mixer_mc.conv_mixer_mc_plain, TOL_B3, "B3"

        def core_in(xb):
            return fused.encoder(xb).permute(0, 3, 1, 2).contiguous()
    else:
        return b4_against_float64(torch, fused, x, batches)
    spec, wts = fused.spec, fused.weights
    out = {}
    with torch.no_grad():
        for b in batches:
            y = core_in(x[:b].contiguous())
            got = kernel(y, wts, spec)
            differ = not torch.equal(got, kernel(y, wts, spec))
            ref = plain(y.double(), wts.double(), spec)
            scale = max(1.0, float(ref.abs().max()))
            out[b] = (float((got.double() - ref).abs().max()) / scale,
                      float((plain(y, wts, spec).double() - ref).abs().max())
                      / scale, float(ref.abs().max()))
            torch.cuda.synchronize()
            if not torch.isfinite(got).all() or differ \
                    or not out[b][0] <= tol:
                fail(f"{name} B={b}: {out[b]} against float64 (tol {tol:g})"
                     ", or a second launch differs")
    return out


def fmt_f64(errs: dict) -> str:
    return ", ".join(f"B={b} kernel {k:.3e}, plain {p:.3e} (max|ref| {m:.4g})"
                     for b, (k, p, m) in errs.items())


def parity_paths(torch, np, dev, card, work, counters) -> dict:
    """Phase 24: every run of ``parity_runs.RUNS`` at its full schedule and
    the flagship widths from its recorded init (the matched-init and
    lockstep H36M runs with the plain encoder and with ``--fused_encoder``,
    the lockstep drift pair, AMASS, ``ar``, ``ar_small``), held by
    ``parity_runs.compare`` to the recorded torch runs at the tolerances of
    ``tests/test_parity_runs.py``; B1's device launches in the fused runs;
    the trained flagship, ``ar`` and AMASS models served through B2, B3
    and B4, each against its plain forward and against float64. Launch
    counts reset just before the runs and read just after the serving."""
    from motionmixerconv_tpu_torch import parity_runs as pr
    from motionmixerconv_tpu_torch.data import AMASSDataset, H36MDataset
    from motionmixerconv_tpu_torch.data.constants import (AMASS_DIM_USED,
                                                          H36M_DIM_USED_XYZ)
    from motionmixerconv_tpu_torch.ops import (conv_mixer, conv_mixer_mc,
                                               harmonic, mlp_mixer)
    from motionmixerconv_tpu_torch.train import Trainer

    golden = str(ROOT / "tests" / "golden")
    recorded = pr.load_recorded(golden)
    pwork = work / "parity"
    shutil.rmtree(pwork, ignore_errors=True)
    t_phase = time.perf_counter()
    for c in counters.values():
        c.reset()
    h36m_dir, amass_dir = pr.make_corpora(str(pwork), recorded)
    corpus_s = time.perf_counter() - t_phase
    c = pr.H36M_CFG
    n_train = len(H36MDataset(h36m_dir, c["input_n"], c["output_n"],
                              c["skip_rate"], split=0))
    steps = c["n_epochs"] * -(-n_train // c["batch_size"])
    results, b1 = {}, {}
    for name, (_, _, ref_key, _) in pr.RUNS.items():
        with counted_launches(harmonic, Trainer, COUNTED_METHODS) as in_run:
            results[name] = pr.run(name, golden, h36m_dir, amass_dir,
                                   str(pwork), dev=DEVICE)
        b1[name] = {k: in_run["_train_sums"][k] for k in B1_IN_RUN}
        ours, ref = results[name], recorded["results"][ref_key]
        say(f"[24 parity {name}] {pr.report(name, ours, recorded)} | B1 "
            f"device launches in training {b1[name]} for "
            + (f"{steps} train steps" if name.startswith("h36m") else
               "its train steps") + " | train per epoch ours "
            + json.dumps([round(v, 4) for v in ours["train_per_epoch"]])
            + " torch " + json.dumps([round(v, 4) for v in
                                      ref["train_per_epoch"]])
            + (" | test per epoch ours " + json.dumps(
                [round(v, 4) for v in ours["test_per_epoch"]]) + " torch "
               + json.dumps([round(v, 4) for v in ref["test_per_epoch"]])
               if "test_per_epoch" in ref else ""))
    verdict = pr.compare(results, recorded, golden)
    runs_s = time.perf_counter() - t_phase - corpus_s

    # the trained models through their kernels, on test windows as the
    # trainers feed them (H36M xyz in meters, AMASS in meters)
    h36m_test = H36MDataset(h36m_dir, 10, 25, 1, actions=["walking"], split=2)
    x_h36m = torch.as_tensor(np.stack([h36m_test[i] for i in range(128)])
                             )[:, :10, H36M_DIM_USED_XYZ] * 1e-3
    am_test = AMASSDataset(amass_dir, 10, 25, 1, split=2)
    idx = am_test.window_starts[:128, None] + np.arange(10)
    x_am = torch.as_tensor(am_test.frames[idx][..., AMASS_DIM_USED])
    served, preds = {}, {}
    for run, cls, x in (("h36m", conv_mixer.FusedConvMixer, x_h36m),
                        ("ar", conv_mixer_mc.FusedConvMixerMC, x_h36m),
                        ("amass", mlp_mixer.FusedMlpMixer, x_am)):
        pred, got, err, _ = serve_checks(torch, dev, results[run]["checkpoint"],
                                         x.contiguous(), False)
        if not isinstance(pred._fused, cls):
            fail(f"parity {run}: served by {type(pred._fused).__name__}, not "
                 f"{cls.__name__}: {pred.fused_fallback_reason}")
        served[run] = {"kernel": cls.__name__, "err": err}
        preds[run] = (pred, x)
        if not err <= TOL_E2E:
            fail(f"parity {run}'s trained model through {cls.__name__}: "
                 f"{err:.3e} from its plain forward (tol {TOL_E2E:g})")
    torch.cuda.synchronize()
    launches = {k: c.value for k, c in counters.items()}
    # the kernels' cores against float64: comparisons, not on the path
    for run, (pred, x) in preds.items():
        served[run]["float64"] = core_against_float64(
            torch, pred._fused, x.to(dev), (1, 32, 128))
    seconds = time.perf_counter() - t_phase
    with open(work / "parity.json", "w") as f:
        json.dump({"card": card, "results": results, "compare": verdict,
                   "b1": b1, "served": served}, f, indent=1, default=str)
    drift = verdict["drift"]
    say(f"[24 parity] {card} | corpora {corpus_s:.1f} s, runs "
        f"{runs_s:.1f} s, phase {seconds:.1f} s | {len(results)} runs, "
        f"{sum(len(r) for r in verdict['rows'].values())} checks at the "
        "tolerances of tests/test_parity_runs.py, failures: "
        f"{verdict['failures'] or 'none'} | drift endpoints (relative L2 "
        "distance of the final parameters to the reference's): "
        + ", ".join(f"{k} {v:.4f}" for k, v in
                    drift["param_drift_rel"].items())
        + f" (recorded JAX: {drift['jax_recorded']}); last test gaps "
        + ", ".join(f"{k} {v:.4e}" for k, v in drift["last_test_gap"].items())
        + " | trained models served, max abs err / max(1, max|out|) against "
        "the plain forward, and the kernel's core against float64: "
        + " ; ".join(f"{run} via {v['kernel']} {v['err']:.3e}; "
                     f"{fmt_f64(v['float64'])}" for run, v in served.items())
        + f" (tol {TOL_E2E:g}) | launches on the path {launches}")
    if verdict["failures"]:
        fail("parity runs outside the recorded reference's tolerances: "
             + "; ".join(verdict["failures"]))
    for name in ("h36m_fused", "h36m_sync_fused"):
        for k in B1_IN_RUN:
            if b1[name][k] < steps:
                fail(f"{k}: {b1[name][k]} device launches in {name}'s "
                     f"{steps} train steps")
    for k in ("conv_mixer_fused", "conv_mixer_mc", "mlp_mixer_fused"):
        if launches[k] < 1:
            fail(f"{k} was not launched on the parity path")
    return {"launches": launches, "b1": b1, "steps": steps,
            "served": served, "seconds": seconds, "drift": drift}


def cmu_path(torch, np, dev, card, work, counters) -> dict:
    """Phase 25: ``make_cmu_corpus`` -> ``CMUDataset`` (xyz) -> graph-
    replayed training steps of the AMASS CLI's MlpMixer at the CMU width
    (the 75 used dims) -> served through B4, against its plain forward and
    against float64; B4 timed at that width. Launch counts reset just
    before the corpus and read just after the serving."""
    from motionmixerconv_tpu_torch.data import WindowedCorpus, fixtures
    from motionmixerconv_tpu_torch.data.cmu import CMU_ACTIONS, CMUDataset
    from motionmixerconv_tpu_torch.models import MlpMixer
    from motionmixerconv_tpu_torch.ops import mlp_mixer
    from motionmixerconv_tpu_torch.serving import Predictor
    from motionmixerconv_tpu_torch.train import Trainer, make_optimizer

    t0 = time.perf_counter()
    for c in counters.values():
        c.reset()
    cdir = work / "cmu"
    shutil.rmtree(cdir, ignore_errors=True)
    fixtures.make_cmu_corpus(str(cdir), actions=CMU_ACTIONS, n_files=2,
                             n_frames=CMU_FRAMES, seed=SEED + 25)
    train = CMUDataset(str(cdir), 10, 25, split=0, mode="xyz")
    test = CMUDataset(str(cdir), 10, 25, split=2, mode="xyz",
                      data_mean=train.data_mean, data_std=train.data_std)
    dim_used = train.dimensions_to_use
    cfg = dict(AMASS_MLP, num_classes=len(dim_used), input_size=len(dim_used))
    model = MlpMixer(**cfg, generator=torch.Generator().manual_seed(SEED + 25))
    model = model.to(dev)
    cut = WindowedCorpus(frames=train.frames, window_starts=np.random
                         .default_rng(SEED + 25).permutation(
                             train.window_starts)[:CMU_STEPS * TRAIN_BATCH],
                         seq_len=train.seq_len)
    trainer = Trainer(model, make_optimizer(model.parameters(), lr=1e-3,
                                            steps_per_epoch=CMU_STEPS),
                      loss_type="mpjpe", dim_used=dim_used, input_n=10,
                      output_n=25, input_scale=1.0)
    frames, tframes = train.frames_on(dev), test.frames_on(dev)
    losses = [trainer.train_epoch(cut, frames, TRAIN_BATCH, seed=e)
              for e in range(CMU_EPOCHS)]
    replayed = [r for r in trainer._graphs.values() if r.graph is not None]
    val = trainer.validate(test, tframes, TRAIN_BATCH)
    pred = Predictor(trainer.model, device=dev)
    if not isinstance(pred._fused, mlp_mixer.FusedMlpMixer):
        fail(f"the CMU model is not served by B4: {pred.fused_fallback_reason}")
    x = torch.as_tensor(np.stack([test[i] for i in range(len(test))])
                        )[:, :10, dim_used].contiguous()
    with torch.no_grad():
        err = served_err(torch, pred.predict(x), pred.model(x.to(dev)))
    torch.cuda.synchronize()
    launches = {k: c.value for k, c in counters.items()}
    # comparisons and timings, not on the path
    f64 = b4_against_float64(torch, pred._fused, x.to(dev), (1, 32, 128))
    times = b4_times(torch, pred._fused, x.to(dev), model_floats(pred.model),
                     (1, 32, 128))
    seconds = time.perf_counter() - t0
    say(f"[25 cmu] {card} | make_cmu_corpus {len(CMU_ACTIONS)} actions x 2 "
        f"files x {CMU_FRAMES} frames -> CMUDataset xyz: {len(train)} train "
        f"windows ({CMU_STEPS * TRAIN_BATCH} trained on), {len(test)} test, "
        f"{len(dim_used)} used dims | MlpMixer {cfg['num_blocks']} blocks, "
        f"hidden {cfg['hidden_dim']}: {CMU_EPOCHS} epochs of {CMU_STEPS} "
        f"steps, {len(replayed)} captured step graph(s) replayed, train loss "
        f"{losses}, validation {val:.4f} | served through B4 (b={len(x)} test"
        f" windows) vs the plain forward, max abs err / max(1, max|out|) "
        f"{err:.3e} (tol {TOL_E2E:g}); B4 and its plain version against "
        f"float64: {fmt_f64(f64)} (tol {TOL_B4:g}) | launches on the path "
        f"{launches} | B4 ms per call/device/plain (bound ms, by; profiler "
        f"us/launch): {fmt_b4_times('cmu', times)} | phase {seconds:.1f} s")
    if not (all(np.isfinite(losses)) and np.isfinite(val)):
        fail(f"CMU training: losses {losses}, validation {val}")
    if not replayed:
        fail("CMU training replayed no captured step graph")
    if not err <= TOL_E2E or launches["mlp_mixer_fused"] < 1:
        fail(f"CMU model through B4: err {err:.3e}, launches {launches}")
    return {"launches": launches, "seconds": seconds, "err": err,
            "float64": f64, "times": times}


def nccl_mesh_rank(mesh, cfg: dict) -> dict:
    """Phase 26a on one NCCL rank: the flagship with the fused encoder,
    dropout off, cuDNN deterministic, trains through the mesh Trainer on
    graphs (its collectives captured) one epoch of MESH_STEPS global
    batches (the last ragged), then ``evaluate_grouped``, then 2 fused
    epochs; rank 0 runs the same from the same init with ``mesh=None``.
    B1's launches counted on the device around the epoch, the Python
    counters around the whole path."""
    import numpy as np
    import torch
    from motionmixerconv_tpu_torch.data import WindowedCorpus
    from motionmixerconv_tpu_torch.data.constants import H36M_DIM_USED_XYZ
    from motionmixerconv_tpu_torch.models import ConvMixer
    from motionmixerconv_tpu_torch.ops import harmonic
    from motionmixerconv_tpu_torch.train import Trainer, make_optimizer

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dev = mesh.device
    batch = MESH_BATCH * mesh.size
    rs = np.random.RandomState(SEED + 26)
    frames_h = (rs.randn(4000, 96) * 300.0).astype(np.float32)  # mm scale
    n_win = MESH_STEPS * batch - 2
    corpus = WindowedCorpus(frames_h, rs.randint(0, 4000 - 35, n_win)
                            .astype(np.int64), 35)
    gids = np.arange(n_win) % MESH_GROUPS
    frames = torch.from_numpy(frames_h).to(dev)

    def run(m):
        model = ConvMixer(**cfg, generator=torch.Generator().manual_seed(
            SEED + 26)).to(dev)
        tr = Trainer(model, make_optimizer(model.parameters(), lr=1e-3,
                                           steps_per_epoch=MESH_STEPS),
                     loss_type="mpjpe", dim_used=H36M_DIM_USED_XYZ,
                     input_n=10, output_n=25, input_scale=1e-3, mesh=m)
        for c in (harmonic.LAUNCHES, harmonic.LAUNCHES_BWD):
            c.reset()
        before = harmonic.device_launches()
        epoch = tr.train_epoch(corpus, frames, batch, seed=0)
        after = harmonic.device_launches()
        grouped = tr.evaluate_grouped(frames, corpus.window_starts, gids,
                                      MESH_GROUPS, batch, "h36m_xyz")
        fused = tr.run_epochs_fused(corpus, frames, batch, [1, 2], corpus,
                                    frames, frames, corpus.window_starts,
                                    gids, MESH_GROUPS, "h36m_xyz", batch)
        torch.cuda.synchronize()
        params = torch.cat([p.detach().reshape(-1) for p in
                            tr.model.parameters()]).cpu().numpy()
        t0 = time.perf_counter()  # one more epoch, timed: replays only
        tr.train_epoch(corpus, frames, batch, seed=3)
        step_ms = (time.perf_counter() - t0) / MESH_STEPS * 1e3
        return {
            "step_ms": step_ms,
            "train": np.concatenate([[epoch], fused["train"]]),
            "eval": np.concatenate([*grouped, fused["val"],
                                    fused["m1"].ravel(), fused["m2"].ravel(),
                                    fused["n"].ravel()]),
            "params": params,
            "b1_epoch": [a - b for a, b in zip(after, before)],
            "launches": {"harmonic_dense_fwd": harmonic.LAUNCHES.value,
                         "harmonic_dense_bwd": harmonic.LAUNCHES_BWD.value},
            "graphs": sum(r.graph is not None for r in tr._graphs.values()),
            "state_dict": {k: v.detach().cpu() for k, v in
                           tr.model.state_dict().items()}}

    out = {"mesh": run(mesh), "size": mesh.size, "backend": mesh.backend}
    if mesh.rank == 0:
        out["twin"] = run(None)
    return out


def mesh_path(torch, np, dev, card, counters) -> dict:
    """Phase 26: (a) one NCCL rank a visible card (``nccl_mesh_rank``)
    against ``mesh=None`` at TOL_MESH, B1 on the device at least once a
    train step; (b) two gloo ranks on one card through every stanza of
    ``parallel/dryrun.py`` at the flagship widths; (c) ``Predictor(mesh=
    make_mesh([card, card]))``: bulk batches of MESH_BULK rows against the
    plain forward, B <= 128 through B2 (the NCCL-trained flagship) and B3
    (the gloo-trained BatchNorm model), each core against float64. The
    Python counters are reset just before (a) and read just after (c)'s
    serving, (a)'s ranks' own counts added."""
    from motionmixerconv_tpu_torch.models import ConvMixer
    from motionmixerconv_tpu_torch.ops import conv_mixer, conv_mixer_mc
    from motionmixerconv_tpu_torch.parallel import dryrun, launch, make_mesh
    from motionmixerconv_tpu_torch.serving import Predictor

    for c in counters.values():
        c.reset()
    secs = {}
    t0 = time.perf_counter()
    n_cards = torch.cuda.device_count()
    flag_cfg = dict(FLAGSHIP, regularization=0.0, encoder_fused=True)
    ranks = launch(nccl_mesh_rank, n_cards, "nccl", "cuda", args=(flag_cfg,))
    secs["a"] = time.perf_counter() - t0
    r0 = ranks[0]
    mesh_r, twin = r0["mesh"], r0["twin"]
    parts = ("train", "eval", "params")
    rel = {k: float(np.max(np.abs(mesh_r[k] - twin[k]))
                    / max(float(np.max(np.abs(twin[k]))), 1e-30))
           for k in parts}
    bitwise = {k: bool(np.array_equal(mesh_r[k], twin[k])) for k in parts}
    b1_per_step = [n / MESH_STEPS for n in mesh_r["b1_epoch"]]
    say(f"[26 mesh a] {card} | {n_cards} NCCL rank(s), one a card, flagship "
        f"with the fused encoder, dropout off, deterministic cuDNN: "
        f"{MESH_STEPS} steps of {MESH_BATCH} rows a rank on "
        f"{mesh_r['graphs']} captured graphs (collectives inside), "
        f"evaluate_grouped, 2 fused epochs | against mesh=None: relative "
        f"max diff (bit-identical?) " + ", ".join(
            f"{k} {rel[k]:.3e} ({bitwise[k]})" for k in parts)
        + f" (tol {TOL_MESH:g}; the evaluations' index_add_ sums in any "
        f"order) | B1 device "
        f"launches a train step (fwd, dW) {b1_per_step} | step ms (host "
        f"clock over a replayed epoch ending in its host read) mesh "
        f"{mesh_r['step_ms']:.3f}, mesh=None {twin['step_ms']:.3f} | "
        f"{secs['a']:.1f} s (the spawn included)")
    if not max(rel.values()) <= TOL_MESH:
        fail(f"NCCL mesh against mesh=None: {rel}")
    if min(b1_per_step) < 1 or mesh_r["graphs"] < 1:
        fail(f"NCCL mesh: B1 {b1_per_step} a step, {mesh_r['graphs']} graphs")

    t0 = time.perf_counter()
    lines = []
    try:
        dry = dryrun.run(2, "gloo", DEVICE, say=lines.append)
    except AssertionError as e:
        fail(f"the gloo dry run on the card: {e}")
    secs["b"] = time.perf_counter() - t0
    say(f"[26 mesh b] {card} | 2 gloo ranks on {DEVICE}, "
        f"parallel/dryrun.py at the flagship widths: " + " | ".join(lines)
        + f" | {secs['b']:.1f} s")

    t0 = time.perf_counter()
    spread = make_mesh([DEVICE, DEVICE])
    gen = torch.Generator().manual_seed(SEED + 27)
    x = torch.randn(max(MESH_BULK), 10, 66, generator=gen) * 0.5
    served = {}
    flag = Predictor(ConvMixer(**flag_cfg), mesh_r["state_dict"], device=dev,
                     mesh=spread)
    bulk0 = Predictor(ConvMixer(**flag_cfg), mesh_r["state_dict"],
                      device=dev, mesh=spread, fused_max_batch=0)
    bn = Predictor(ConvMixer(**dryrun.BN_MODEL),
                   dry["results"][0]["bn"]["mesh"]["state_dict"],
                   device=dev, mesh=spread)
    if not isinstance(flag._fused, conv_mixer.FusedConvMixer) or not \
            isinstance(bn._fused, conv_mixer_mc.FusedConvMixerMC):
        fail(f"Predictor(mesh=) routes: {flag.fused_fallback_reason}, "
             f"{bn.fused_fallback_reason}")
    bn0 = Predictor(ConvMixer(**dryrun.BN_MODEL),
                    dry["results"][0]["bn"]["mesh"]["state_dict"],
                    device=dev, mesh=spread, fused_max_batch=0)
    with torch.no_grad():
        for tag, p, p0 in (("flagship", flag, bulk0), ("batchnorm", bn, bn0)):
            for b in (*MESH_BULK, 128):
                # bulk batches on the replicas (the small one with no fused
                # window), B = 128 through the fused kernel
                pred = (p0 if b < 128 else p).predict(x[:b])
                if pred.shape != (b, p.model.out_nTP, 66) \
                        or not torch.isfinite(pred).all():
                    fail(f"Predictor(mesh=) {tag} b={b}: bad answer")
                served[f"{tag} b={b}"] = served_err(
                    torch, pred, p.model(x[:b].to(dev)))
    torch.cuda.synchronize()
    launches = {k: c.value for k, c in counters.items()}
    for r in ranks:
        for k, v in r["mesh"]["launches"].items():
            launches[k] += v
    secs["c"] = time.perf_counter() - t0
    # comparisons, not on the path
    f64 = {"B2": core_against_float64(torch, flag._fused, x.to(dev),
                                      (1, 7, 128)),
           "B3": core_against_float64(torch, bn._fused, x.to(dev), (1, 128))}
    say(f"[26 mesh c] {card} | Predictor(mesh=[{DEVICE}, {DEVICE}]): bulk "
        f"and B <= 128 against the plain forward, max abs err / max(1, "
        "max|out|): " + ", ".join(f"{k} {v:.3e}" for k, v in served.items())
        + f" (tol {TOL_E2E:g}) | B2 (NCCL-trained flagship) "
        f"{fmt_f64(f64['B2'])}; B3 (gloo-trained BatchNorm model) "
        f"{fmt_f64(f64['B3'])} against float64 (tol {TOL_B2:g}) | launches "
        f"on the path {launches} | {secs['c']:.1f} s")
    if not max(served.values()) <= TOL_E2E:
        fail(f"Predictor(mesh=) against the plain forward: {served}")
    for k in ("conv_mixer_fused", "conv_mixer_mc", "harmonic_dense_fwd",
              "harmonic_dense_bwd"):
        if launches[k] < 1:
            fail(f"phase 26: kernel {k} was not launched on the path")
    return {"launches": launches, "seconds": secs, "rel": rel,
            "bitwise": bitwise, "step_ms": (mesh_r["step_ms"],
                                            twin["step_ms"]), "b1_per_step": b1_per_step,
            "diffs": dry["diffs"], "served": served, "float64": f64}


def bf16_path(torch, np, dev, card, counters) -> dict:
    """Phase 27: the flagship with the plain encoder at dtype bf16 against
    its float32 forward (TOL_BF16); BF16_STEPS graph-replayed training
    steps of each at batch TRAIN_BATCH, float32 then bf16, timed in this
    one call (``profile_train``); the AMASS MlpMixer at dtype bf16 served
    through B4 (its float32 weights) against its float32 plain forward.
    The Python counters reset just before and read just after the
    serving."""
    from motionmixerconv_tpu_torch.data.constants import H36M_DIM_USED_XYZ
    from motionmixerconv_tpu_torch.models import ConvMixer, MlpMixer
    from motionmixerconv_tpu_torch.ops import mlp_mixer
    from motionmixerconv_tpu_torch.serving import Predictor
    from motionmixerconv_tpu_torch.train import Trainer, make_optimizer

    t0 = time.perf_counter()
    for c in counters.values():
        c.reset()
    bf16 = torch.bfloat16
    gen = torch.Generator().manual_seed(SEED)
    f32 = ConvMixer(**FLAGSHIP, generator=gen).to(dev).eval()
    m16 = ConvMixer(**FLAGSHIP, dtype=bf16).to(dev).eval()
    m16.load_state_dict(f32.state_dict())
    x = (torch.randn(BULK_ROWS, 10, 66, generator=gen) * 0.5).to(dev)
    with torch.no_grad():
        y32, y16 = f32(x), m16(x)
    fwd_rel = float((y16.float() - y32).abs().max() / y32.abs().max())
    if y16.dtype != bf16 or not fwd_rel <= TOL_BF16:
        fail(f"bf16 flagship forward: dtype {y16.dtype}, {fwd_rel:.3e} from "
             f"float32 (tol {TOL_BF16:g})")

    frames, starts, w = random_batches(torch, dev, SEED + 27, 5000, 96, 300.0,
                                       35, 3 * BF16_STEPS, TRAIN_BATCH)
    times, losses = {}, {}
    for tag, dtype in (("float32", None), ("bf16", bf16)):
        model = ConvMixer(**FLAGSHIP, dtype=dtype, generator=torch.Generator()
                          .manual_seed(SEED + 27)).to(dev)
        tr = Trainer(model, make_optimizer(model.parameters(), lr=1e-3),
                     loss_type="mpjpe", dim_used=H36M_DIM_USED_XYZ,
                     input_n=10, output_n=25, input_scale=1e-3)
        got = []

        def run(lo, hi):
            sums = tr._train_sums(frames, starts[lo:hi], w[lo:hi], None,
                                  True).cpu()
            got.append(float(sums[0] / sums[1]))

        times[tag] = profile_train(torch, run, BF16_STEPS, TRAIN_BATCH)
        losses[tag] = got
        if not any(r.graph is not None for r in tr._graphs.values()):
            fail(f"{tag} training replayed no captured step graph")
    if not all(np.isfinite(v).all() for v in losses.values()):
        fail(f"bf16 training losses: {losses}")

    am32 = MlpMixer(**AMASS_MLP, generator=torch.Generator().manual_seed(
        SEED + 28)).to(dev).eval()
    am16 = MlpMixer(**AMASS_MLP, dtype=bf16)
    served = Predictor(am16, am32.state_dict(), device=dev)
    if not isinstance(served._fused, mlp_mixer.FusedMlpMixer):
        fail(f"the bf16 MlpMixer is not served by B4: "
             f"{served.fused_fallback_reason}")
    xa = torch.randn(128, 10, 54, generator=gen) * 0.3
    with torch.no_grad():
        got = served.predict(xa)
        b4_err = served_err(torch, got, am32(xa.to(dev)))
        b4_vs_bf16 = float((got - served.model(xa.to(dev)).float()).abs()
                           .max() / got.abs().max())
    torch.cuda.synchronize()
    launches = {k: c.value for k, c in counters.items()}
    f64 = b4_against_float64(torch, served._fused, xa.to(dev), (1, 128))
    seconds = time.perf_counter() - t0
    ratio = times["bf16"]["step_ms"] / times["float32"]["step_ms"]
    say(f"[27 bf16] {card} | flagship (plain encoder) at dtype bf16 against "
        f"float32, b={BULK_ROWS}: {fwd_rel:.3e} relative (tol {TOL_BF16:g}) "
        f"| {BF16_STEPS} graph-replayed train steps at batch {TRAIN_BATCH}, "
        "dropout 0.1, plain encoder, timed in this call: "
        + " | ".join(f"{tag}: {fmt_times({True: t})}"
                     for tag, t in times.items())
        + f" | bf16 / float32 step ms {ratio:.3f} | losses (3 windows) "
        f"{ {k: [round(v, 3) for v in vs] for k, vs in losses.items()} } | "
        f"bf16 AMASS MlpMixer's weights through B4 against its float32 plain "
        f"forward {b4_err:.3e} (tol {TOL_E2E:g}), against its own bf16 "
        f"forward {b4_vs_bf16:.3e}; B4 against float64 {fmt_f64(f64)} | "
        f"launches on the path {launches} | phase {seconds:.1f} s")
    if not b4_err <= TOL_E2E or launches["mlp_mixer_fused"] < 1:
        fail(f"bf16 MlpMixer through B4: err {b4_err:.3e}, {launches}")
    return {"launches": launches, "seconds": seconds, "fwd_rel": fwd_rel,
            "times": times, "b4_err": b4_err, "float64": f64,
            "ratio": ratio}


def main() -> None:
    t_run = time.perf_counter()
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
    b2_checks = {}
    for tag, model, batches in (("flagship", flag, B2_BATCHES),
                                ("bn+maxpool+once", bn_model, (7, 128))):
        fused = conv_mixer.make_fused_conv_mixer(model)
        with torch.no_grad():
            y_all = fused.encoder(x_all[:128])[..., 0].contiguous()
        b2_checks[tag] = check_b2(torch, lib, tag, fused, y_all, batches)
    b2_err = max(v["err"] for c in b2_checks.values() for v in c.values())
    say(f"[3 B2 conv_mixer_fused vs plain] max_abs_err {b2_err:.3e} "
        f"(tol {TOL_B2:g}), {B2_REPEATS} launches of each case "
        f"bit-identical | {sms} SMs, the card's shared memory a block "
        f"{card_smem} B; plans (library agrees): " + " ; ".join(
            fmt_b2_plans(t, c) for t, c in b2_checks.items()))

    # [4] B1 forward against its plain version at the training step's rows,
    # 1280 and the bulk 2560 rows, twice for bit-identity; the wrapper's
    # launch plans against the library's tiles and shared memory
    plans = check_b1_plans(lib, harmonic, torch)
    enc = encoder_params(flag.encoder)
    x_b1 = x_all.reshape(-1, 66)
    b1_errs = check_b1_fwd(torch, harmonic, x_b1, enc, harmonic.IMPLS,
                           B1_FWD_ROWS)
    b1_err = max(b1_errs.values())
    say(f"[4 B1 harmonic_dense_fwd vs plain] max_abs_err {b1_err:.3e} "
        f"(tol {TOL_B1:g}); second launch bit-identical | " + " ; ".join(
            f"{i} R={r} {v:.3e}" for (i, r), v in b1_errs.items())
        + f" | launch plans (library agrees): {plans}")

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
        y_all = predictor._fused.encoder(x_all[:128])[..., 0].contiguous()
    b2 = b2_times(torch, predictor._fused, y_all, B2_BATCHES)
    say(f"[6 times] {card} | B2 conv_mixer_fused ms: per call from Python "
        "(events) / device (events over calls queued behind a spin kernel) "
        "/ plain / host enqueue (bound ms, by; profiler device us/launch): "
        + fmt_b2_times("flagship", b2)
        + " | Predictor.predict latency ms (host clock, to a CPU array): "
        + " ; ".join(f"b={b} {v:.3f}" for b, v in pred_lat.items())
        + f" | BatchingPredictor.predict latency ms: b=1 {bat_lat[1]:.3f} ; "
          f"b=32 {bat_lat[32]:.3f}"
        + f" | HTTP /predict latency ms: b=1 {lat[1]:.3f} ; b=32 {lat[32]:.3f}")

    # [7] B1-bwd against its plain version, twice for bit-identity
    gg = torch.Generator().manual_seed(SEED + 3)
    g_all = torch.randn(max(B1_BWD_ROWS), 50, generator=gg).to(dev)
    bwd_errs = check_b1_bwd(torch, harmonic, x_b1, g_all, enc, harmonic.IMPLS,
                            B1_BWD_ROWS, (True,))
    bwd_err = {"dW": max(v["dW"][0] for v in bwd_errs.values()),
               "db": max(v["db"][0] for v in bwd_errs.values()),
               "dx_rel": max(v["dx"][1] for v in bwd_errs.values())}
    say(f"[7 B1-bwd harmonic_dense_bwd vs plain] max abs err dW "
        f"{bwd_err['dW']:.3e}, db {bwd_err['db']:.3e}; dx err / max|dx| "
        f"{bwd_err['dx_rel']:.3e} (tol {TOL_B1_BWD:g} x max|ref| each); "
        "second launch bit-identical | " + " ; ".join(
            f"{i} R={r} dW {v['dW'][0]:.3e} db {v['db'][0]:.3e} dx/max|dx| "
            f"{v['dx'][1]:.3e}" for (i, r, _), v in bwd_errs.items()))

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
            # B1's device launches in this run, replays included
            traces = counted_launches(harmonic, Trainer, COUNTED_METHODS)
        t0 = time.perf_counter()
        with traces as in_run:
            hist = train_mixer_h36m.main(argv)
        runs[tag] = (hist, time.perf_counter() - t0)
        if tag == "fused":
            # serve the trained checkpoint through B2, still on the path
            test_ds = H36MDataset(str(data_dir), 10, 25, 1, actions=["walking"],
                                  split=2)
            dim_used = test_ds.dim_used
            win = torch.as_tensor(np.stack([test_ds[i] for i in range(32)]))
            x_test = (win[:, :10, dim_used] * 1e-3).contiguous()
            _, got, serve_err, _ = serve_checks(
                torch, dev, save / "h36_3d_25frames_ckpt" / _runner.STATE_FILE,
                x_test, False)
            train_launches = {"conv_mixer_fused": conv_mixer.LAUNCHES.value,
                              "harmonic_dense_fwd": harmonic.LAUNCHES.value,
                              "harmonic_dense_bwd": harmonic.LAUNCHES_BWD.value}
            b1_run = in_run
    # the Python counters above see the eager warm-up steps and the
    # captures, not the replays; the device counters see every launch
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
        f"CLI's run (the kernels' device counters, read around each training"
        f" and evaluation call): training {b1_train} for {steps} train steps, evaluation "
        f"{b1_run['_eval_sums']} | deterministic cuDNN, --epochs_per_dispatch"
        f" 2 against 1: per-epoch history max rel {epd_err:.3e} (tol "
        f"{TOL_EPD:g}; train loss {epd_hist2['train']} against "
        f"{epd_hist1['train']}) | trained .pt served through B2 "
        f"(b=32 test windows) vs the plain forward: max abs err / max(1, "
        f"max|out|) {serve_err:.3e} (tol {TOL_E2E:g}) | "
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
    # the fused run of phase 9 (device counters read around each call) and
    # the same CLI's --epochs_per_dispatch 2 run of the epd check beside it
    per = {}
    for tag, h, run_s in (
            ("fused, B1's device counters read around each call",
             *runs["fused"][:2]),
            ("fused, deterministic cuDNN", epd_hist2, None),
            ("plain", *runs["plain"][:2])):
        per[tag] = {"train_s": h["train_s"], "epoch_s": h["epoch_s"],
                    "samples_per_s": [n_train / t for t in h["train_s"]],
                    "step_ms": [t / steps_per_epoch * 1e3 for t in h["train_s"]],
                    "run_s": run_s}
    # B1 at the training step's rows and the bulk rows
    b1t = b1_times(torch, harmonic, x_b1, g_all, enc, B1_BWD_ROWS)
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
        + f" | {fmt_b1_times(b1t)}"
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
    x_ar = win[:, :10, dim_used].contiguous()  # mm: this path feeds raw input
    served_ar, got, ar_err, ar_http_err = serve_checks(
        torch, dev, ar_save / "h36_ar_25frames_ckpt" / _runner.STATE_FILE,
        x_ar, True)
    ar_launches = {k: c.value for k, c in counters.items()}
    ar_pred_lat = host_median_ms(lambda: served_ar.predict(x_ar[:1]).cpu())
    ar_epd_err, ar_epd2, ar_epd1 = epd_check(
        torch, train_autoreg_mixer_h36m.main,
        [*AR_ARGV, "--data_dir", str(data_dir)], work / "epd_autoregressive")
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
        f"test windows) vs the plain forward: max abs err / max(1, max|out|) "
        f"{ar_err:.3e}; /predict --arch auto b=5 {ar_http_err:.3e} (tol "
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
    b4_checks, b4_fused, b4_plans = {}, {}, []
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
        b4_checks[tag] = check_b4(torch, tag, fused, model, x_m, batches)
    b4_err = max(v["err"] for c in b4_checks.values() for v in c.values())
    say(f"[14 B4 mlp_mixer_fused vs plain] max_abs_err {b4_err:.3e} (tol "
        f"{TOL_B4:g}), {B4_REPEATS} launches of each case bit-identical, "
        "activations in scratch "
        "(long_window) and weights read in place (wide) as the wrapper "
        "placed them | " + " ; ".join(
            f"{t} B={b} {v['err']:.3e} (module {v['module_err']:.1e})"
            for t, c in b4_checks.items() for b, v in c.items())
        + " | launch per shape at its largest batch: " + " ; ".join(b4_plans))

    # [15] the AMASS path: the CLI at its default widths for 2 epochs on a
    # synthetic corpus, its train_state.pt served through B4 in process and
    # over HTTP with --arch auto (launch counts reset just before the CLI and
    # read just after the serving)
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
    am_test = AMASSDataset(str(amass_dir), 10, 25, 1, split=2)
    am_win = torch.as_tensor(np.stack([am_test[i] for i in range(32)]))
    x_am = am_win.reshape(32, 35, -1)[:, :10, AMASS_DIM_USED].contiguous()
    served_am, got, am_err, am_http_err = serve_checks(
        torch, dev, am_save / "amass_3d_25frames_ckpt" / _runner.STATE_FILE,
        x_am, True)
    am_launches = {k: c.value for k, c in counters.items()}
    am_plain_calls = mlp_mixer.PLAIN_CALLS.value
    am_epd_err, am_epd2, am_epd1 = epd_check(
        torch, train_mixer_amass.main,
        [*AMASS_ARGV, "--data_dir", str(amass_dir)], work / "epd_amass")
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
        f"windows) vs the plain forward: max abs err / max(1, max|out|) "
        f"{am_err:.3e}; /predict --arch auto b=5 "
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
    b4_t = b4_times(torch, *b4_fused["amass"], (1, 32, 128))
    del b4_fused
    am_pred_lat = {}
    x_bulk_am = (torch.randn(BULK_ROWS, 10, 54, generator=gm) * 0.3)
    for b in (1, 32, 128, BULK_ROWS):
        xb = x_bulk_am[:b].clone()
        served_am.predict(xb).cpu()
        am_pred_lat[b] = host_median_ms(lambda: served_am.predict(xb).cpu())
    am_server = PredictionServer(served_am, port=0, warmup=True)
    am_server.start_background()
    payload = {"inputs": x_am[:1].tolist()}
    am_http_lat = host_median_ms(lambda: post(
        f"http://127.0.0.1:{am_server.port}", "/predict", payload))
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
        "Python / device (calls queued) / plain (bound ms, by; profiler "
        "device us/launch); launch: " + fmt_b4_times("amass", b4_t)
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

    # [17] the kernels at the angle and AIS paths' shapes; [18]-[20] those
    # paths, each from its CLI at its defaults to its served checkpoint
    models = cli_models(torch)
    new = new_shape_kernels(torch, dev, _build.load_library(), card, models)
    paths = angle_and_ais_paths(torch, np, dev, card, work, data_dir,
                                counters)

    # [21] checkpoint interchange; [22]-[23] the studies, each from its
    # module's main to its best trial served through its kernel
    interchange = checkpoint_interchange(torch, np, dev, card, work, data_dir,
                                         counters, steps_per_epoch)
    studies = study_paths(torch, np, dev, card, work, data_dir, counters)

    # [24] the parity runs at their full schedules, their trained models
    # through B2, B3 and B4; [25] the CMU pipeline to B4
    parity = parity_paths(torch, np, dev, card, work, counters)
    cmu = cmu_path(torch, np, dev, card, work, counters)

    # [26] the data-parallel mesh: NCCL ranks, gloo ranks, Predictor(mesh=);
    # [27] the bf16 compute dtype
    mesh = mesh_path(torch, np, dev, card, counters)
    bf16 = bf16_path(torch, np, dev, card, counters)

    def timed(v, **extra):
        """A times entry of b1_times, b2_times or b4_times as the kernels
        line's keys."""
        out = {"ms": v["ms"], "plain_ms": v["plain_ms"],
               "bound_ms": v["bound"][0], "bound_by": v["bound"][1]}
        out.update({k: v[k] for k in ("device_ms", "library_ms",
                                      "doubling_ms", "device_us") if k in v})
        return {**out, **extra}

    r0, rb = B1_BWD_ROWS  # the training step's rows; the bulk batch's
    fwd_t, bwd_t, b1_dev = b1t["fwd"], b1t["bwd"], b1t["device_us"]
    nb1 = new["b1_times"]
    kernels = [
        {"name": "conv_mixer_fused", "route": "cuda",
         "source": "motionmixerconv_tpu_torch/csrc/conv_mixer_fused.cu",
         "replaces": "motionmixerconv_tpu/ops/pallas_conv_mixer.py:579",
         "launches": launches["conv_mixer_fused"], "max_abs_err": max(
             b2_err, *(v["err"] for c in new["b2"].values()
                       for v in c.values())),
         **timed(b2[128], library_ms=None),
         "by_batch": {str(b): timed(v) for b, v in b2.items()},
         "new_shapes": {f"{t} B={b}": timed(
             v, max_abs_err=new["b2"][t][b]["err"])
             for t, c in new["b2_times"].items() for b, v in c.items()},
         "parity_trained_against_float64": parity["served"]["h36m"],
         "mesh_trained_against_float64": mesh["float64"]["B2"]},
        {"name": "harmonic_dense_fwd", "route": "cuda",
         "source": "motionmixerconv_tpu_torch/csrc/harmonic_dense.cu",
         "replaces": "motionmixerconv_tpu/ops/pallas_harmonic.py:54",
         "launches": launches["harmonic_dense_fwd"], "max_abs_err": max(
             b1_err, *new["b1_fwd"].values()),
         "device_launches_per_train_step": b1_train[B1_IN_RUN[0]] / steps,
         **timed(fwd_t[rb]),
         "library_note": "F.linear(embed, W, b), cuBLAS f32, on a precomputed "
                         "embedding: the contraction without the trig",
         "rows": rb,
         "by_rows": {str(r): timed(t, device_us={
             k: b1_dev[f"fwd R={r} {k}"] for k in B1_FWD_KERNELS})
             for r, t in fwd_t.items()},
         "angle_device_launches_per_train_step":
             paths["angle"]["b1_train"][B1_IN_RUN[0]] / paths["angle"]["steps"],
         "mesh_nccl_device_launches_per_train_step": mesh["b1_per_step"][0],
         "parity_device_launches_per_train_step": {
             run: parity["b1"][run][B1_IN_RUN[0]] / parity["steps"]
             for run in ("h36m_fused", "h36m_sync_fused")},
         "new_shapes": {f"angle (D, n, E) {B1_ANGLE_SHAPE} R={r}": timed(
             t, max_abs_err=new["b1_fwd"][("direct", r)])
             for r, t in nb1["fwd"].items()}},
        {"name": "harmonic_dense_bwd", "route": "cuda",
         "source": "motionmixerconv_tpu_torch/csrc/harmonic_dense.cu",
         "replaces": "motionmixerconv_tpu/ops/pallas_harmonic.py:104",
         "launches": train_launches["harmonic_dense_bwd"],
         "device_launches_per_train_step": b1_train[B1_IN_RUN[1]] / steps,
         "max_abs_err": max(bwd_err["dW"], bwd_err["db"]),
         "dx_err_over_max": bwd_err["dx_rel"],
         **timed(bwd_t[(r0, False)]),
         "library_note": "g.t() @ embed, cuBLAS f32, on a precomputed "
                         "embedding: dW's contraction without the trig or db",
         "rows": r0,
         "with_dx": timed(bwd_t[(r0, True)]),
         "by_rows": {str(r): timed(bwd_t[(r, False)], with_dx_ms=bwd_t[
             (r, True)]["ms"], device_us={
                 k: b1_dev[f"bwd+dx R={r} {k}"] for k in B1_BWD_KERNELS})
             for r in B1_BWD_ROWS},
         "angle_device_launches_per_train_step":
             paths["angle"]["b1_train"][B1_IN_RUN[1]] / paths["angle"]["steps"],
         "mesh_nccl_device_launches_per_train_step": mesh["b1_per_step"][1],
         "parity_device_launches_per_train_step": {
             run: parity["b1"][run][B1_IN_RUN[1]] / parity["steps"]
             for run in ("h36m_fused", "h36m_sync_fused")},
         "new_shapes": {
             f"angle (D, n, E) {B1_ANGLE_SHAPE} R={r} "
             f"{'dW+db+dx' if dx else 'dW+db'}": timed(t, err_over_max={
                 k: e[1] for k, e in new["b1_bwd"][("direct", r, dx)].items()})
             for (r, dx), t in nb1["bwd"].items()}},
        {"name": "conv_mixer_mc", "route": "cuda",
         "source": "motionmixerconv_tpu_torch/csrc/conv_mixer_mc.cu",
         "replaces": "motionmixerconv_tpu/ops/pallas_conv_mixer.py:465",
         "launches": ar_launches["conv_mixer_mc"], "max_abs_err": b3_err,
         "ms": b3_t[("autoregressive", 128)][0],
         "plain_ms": b3_t[("autoregressive", 128)][1],
         "bound_ms": b3_t[("autoregressive", 128)][2][0],
         "bound_by": b3_t[("autoregressive", 128)][2][1], "library_ms": None,
         "conv_study_grid_max_abs_err": studies["conv_study"]["grid_err"],
         "parity_trained_against_float64": parity["served"]["ar"],
         "mesh_trained_against_float64": mesh["float64"]["B3"],
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
         "launches": am_launches["mlp_mixer_fused"], "max_abs_err": max(
             b4_err, *(v["err"] for v in new["b4"].values())),
         "jax_ckpt_max_abs_err": interchange["anchor_err"],
         **timed(b4_t[128], library_ms=None),
         "by_batch": {str(b): timed(v) for b, v in b4_t.items()},
         "new_shapes": {**{f"angle_mlp B={b}": timed(
             v, max_abs_err=new["b4"][b]["err"])
             for b, v in new["b4_times"].items()},
             **{f"jax_ckpt B={b}": timed(
                 v, max_abs_err=interchange["anchor_err"])
                for b, v in interchange["b4_times"].items()},
             **{f"cmu B={b}": timed(v, err_against_float64=cmu["float64"][b][0])
                for b, v in cmu["times"].items()}},
         "parity_trained_against_float64": parity["served"]["amass"],
         "bf16_model_served_max_abs_err": bf16["b4_err"]},
    ]
    for k in kernels:
        k["launches_by_path"] = {"serve": launches.get(k["name"], 0),
                                 "train": train_launches.get(k["name"], 0),
                                 "autoregressive": ar_launches.get(k["name"], 0),
                                 "amass": am_launches[k["name"]],
                                 **{tag: paths[tag]["launches"][k["name"]]
                                    for tag in ("angle", "angle_autoregressive",
                                                "ais", "ais_autoregressive")},
                                 "jax_ckpt": interchange["launches"][k["name"]],
                                 **{tag: studies[tag]["launches"][k["name"]]
                                    for tag in ("conv_study", "mlp_study",
                                                "autoreg_study")},
                                 "parity": parity["launches"][k["name"]],
                                 "cmu": cmu["launches"][k["name"]],
                                 "mesh": mesh["launches"][k["name"]],
                                 "bf16": bf16["launches"][k["name"]]}
    say(f"[run] {time.perf_counter() - t_run:.1f} s, the kernels' build "
        f"included | phases 21-23: {interchange['seconds']:.1f} s "
        f"interchange, conv_study calls "
        f"{sum(studies['conv_study']['walls'].values()):.1f} s (and "
        f"{sum(studies['conv_study']['sequential_trial_s'].values()):.1f} s "
        f"the sequential reference), mlp_study "
        f"{studies['mlp_study']['wall']:.1f} s, autoreg_study "
        f"{studies['autoreg_study']['wall']:.1f} s | phase 24 (parity) "
        f"{parity['seconds']:.1f} s, phase 25 (cmu) {cmu['seconds']:.1f} s"
        f" | phase 26 (mesh) a {mesh['seconds']['a']:.1f} s, b "
        f"{mesh['seconds']['b']:.1f} s, c {mesh['seconds']['c']:.1f} s, "
        f"phase 27 (bf16) {bf16['seconds']:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

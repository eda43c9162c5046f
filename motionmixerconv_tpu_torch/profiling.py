"""Profiling and throughput observability on the card.

Counterpart of ``motionmixerconv_tpu/profiling.py``: the card's ceilings
(the one copy ``chip_smoke.py`` reads for its roofline bounds), the
physical-ceiling check and a ``torch.profiler`` trace context; and the
program's own spans, which the JAX package does not have.

Trace a training run with ``MMC_PROFILE_DIR=/path``: the runners
(``cli/_runner.py``) trace the first epoch, or the first chunk of
``--epochs_per_dispatch`` epochs, into a Chrome/Perfetto trace JSON there.

Spans. ``span(name)`` times a stretch of the program's host work and keeps,
per name, the count, the total and the self nanoseconds (the total less
the spans opened inside it on the same thread), in one of two buckets:
``traced`` where a torch profiler records at the span's entry, else
``untraced``, so that numbers read from untraced work carry nothing of the
tracer's cost. Under a recording profiler the span is also a
``record_function("mmc.<name>")`` on the profiler's host timeline. With no
profiler recording a span does two clock reads and a few integer adds under
a lock: no device work, no device synchronisation. ``snapshot()`` reads the totals,
``reset()`` clears them; ``epoch_numbers`` is the training CLIs' per-epoch
reading of them. The spans, all outside any captured CUDA graph's body
(a replay re-runs only device work):

- ``train.epoch``: ``Trainer.train_epoch``, ``train_epoch_ar``, whole;
- ``eval.pass``: ``Trainer.evaluate_grouped``, whole (``validate``,
  ``evaluate`` and ``evaluate_ar`` go through it);
- ``train.batches``: the epoch's shuffle, stacking and copy to the device;
- ``eval.stack``: the evaluation stacks' content keys and, on a miss, the
  stacking and copy;
- ``train.step`` / ``eval.step``: one batch of ``StepGraph.run`` (the
  batch's copies, the launch or eager body, and ``after``), holding one of
  ``train.launch`` / ``eval.launch`` (a graph's replay), ``train.eager`` /
  ``eval.eager`` (an eager body: the warm-up calls, every call on the CPU)
  or ``capture`` (a graph built, and its first replay);
- ``read``: each host read that waits for the device;
- ``data.read`` / ``data.fk``: ``AMASSDataset``'s walk over the npz
  archives / its batched SMPL forward kinematics.

Graphs. ``count_graph(kind, nodes)`` records, at capture, the nodes of a
step graph (``train/graphs.py``) by the step's kind ("train" or "eval"):
the graphs counted, their nodes together and the nodes of each CUDA node
type; ``graph_nodes()`` reads them. A replay records nothing.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time

import numpy as np
import torch

# Per-card ceilings by torch.cuda.get_device_name(): NVIDIA's data sheet
# for the H100 SXM at its full 700 W (dense rates, no sparsity), not
# measurements. PEAK_FLOPS is the bf16 tensor-core rate; PEAK_FLOPS_F32 is
# float32 outside the tensor cores, since the port pins TF32 off
# (serving.resolve_device); PEAK_BYTES is the HBM3 rate. A card set below
# 700 W runs slower under load.
H100 = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS = {H100: 989e12}
PEAK_FLOPS_F32 = {H100: 67e12}
PEAK_BYTES = {H100: 3.35e12}

# a byte count is a model of the traffic (each input read once, each
# output written once), so the bandwidth check allows this much headroom
# before it calls the timing broken; FLOP counts are exact, no slack there
_BYTES_CEILING_SLACK = 1.05


def peak_flops_for(device_kind: str, dtype) -> float | None:
    """Peak FLOP/s for ``device_kind`` at the given compute dtype: the
    tensor-core bf16 rate for 16-bit and narrower dtypes, the float32 rate
    for 32-bit ones, None for a kind with no table (the CPU). Wider dtypes
    raise: float64 has no table here, and checking it against a float32
    ceiling would pass an inflated measurement."""
    try:
        itemsize = np.dtype(dtype).itemsize
    except TypeError:  # "bfloat16", which numpy does not know
        itemsize = 2 if "16" in str(dtype) else 4
    if itemsize > 4:
        raise ValueError(
            f"no peak-FLOP/s ceiling for dtype {dtype!r} on {device_kind}; "
            "measure in f32/bf16 or add a bound")
    table = PEAK_FLOPS if itemsize <= 2 else PEAK_FLOPS_F32
    return table.get(device_kind)


def check_physical_ceilings(
    name: str,
    *,
    device_kind: str,
    dtype="float32",
    flops_per_s: float | None = None,
    bytes_per_s: float | None = None,
    strict_bytes: bool = True,
) -> bool:
    """Raise if a measurement implies more than the card can do.

    Achieved FLOP/s above the dtype's peak always raises: a FLOP count is
    exact, so only a broken timing gets there. Achieved bytes/s above the
    memory roof (with 5% slack) raises when ``strict_bytes``; otherwise
    the byte model may overcount (data a fused kernel keeps on chip), so
    the breach is reported and True returned. Unknown device kinds (the
    CPU) check nothing.

    Returns True if the bytes roof was breached but tolerated.
    """
    if flops_per_s is not None:
        peak = peak_flops_for(device_kind, dtype)
        if peak and flops_per_s > peak:
            raise RuntimeError(
                f"bench '{name}' implies {flops_per_s:.3g} FLOP/s > "
                f"{device_kind} {dtype} peak {peak:.3g} — timing or FLOP "
                f"accounting is broken")
    if bytes_per_s is not None:
        roof = PEAK_BYTES.get(device_kind)
        if roof and bytes_per_s > roof * _BYTES_CEILING_SLACK:
            if strict_bytes:
                raise RuntimeError(
                    f"bench '{name}' implies {bytes_per_s:.3g} HBM bytes/s > "
                    f"{device_kind} roof {roof:.3g} — timing or byte "
                    f"accounting is broken")
            print(f"# '{name}': modeled {bytes_per_s:.3g} B/s > roof "
                  f"{roof:.3g} — the byte model overcounts here; treating "
                  "bytes as an upper bound", file=sys.stderr)
            return True
    return False


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Trace the enclosed work with ``torch.profiler`` into a Chrome/
    Perfetto trace JSON, ``log_dir/trace_<pid>_<ns>.json`` (no-op for
    None): the host's activity, and the card's kernels and copies when
    torch sees a card."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    print(f"wrote the profiler trace {path}")


def profile_dir_from_env() -> str | None:
    return os.environ.get("MMC_PROFILE_DIR") or None


# per bucket, per span name: [count, total ns, self ns]
_TOTALS: dict = {"untraced": {}, "traced": {}}
# per step kind: {"graphs": graphs counted, "nodes": their nodes, and the
# nodes of each CUDA node type ("kernel", "memcpy", "memset", ...)}
_GRAPHS: dict = {}
_LOCK = threading.Lock()  # guards both tables, as ops/_build.Counter's lock
_OPEN = threading.local()  # .stack: this thread's open spans, innermost last


def recording() -> bool:
    """Whether a torch profiler records on this thread."""
    return torch._C._autograd._profiler_enabled()


def _stack() -> list:
    try:
        return _OPEN.stack
    except AttributeError:
        _OPEN.stack = []
        return _OPEN.stack


def _bump(bucket: dict, name: str, count: int, total_ns: int,
          self_ns: int) -> None:
    t = bucket.get(name)
    if t is None:
        t = bucket[name] = [0, 0, 0]
    t[0] += count
    t[1] += total_ns
    t[2] += self_ns


class span:
    """``with span(name):`` times the enclosed host work into ``name``'s
    totals (module docstring); nests per thread."""

    __slots__ = ("name", "child_ns", "_traced", "_mark", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "span":
        self._traced = recording()
        self._mark = None
        if self._traced:
            self._mark = torch.autograd.profiler.record_function(
                "mmc." + self.name)
            self._mark.__enter__()
        self.child_ns = 0
        _stack().append(self)
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        ns = time.perf_counter_ns() - self._t0
        stack = _stack()
        stack.pop()
        if self._mark is not None:
            self._mark.__exit__(*exc)
        with _LOCK:
            _bump(_TOTALS["traced" if self._traced else "untraced"],
                  self.name, 1, ns, ns - self.child_ns)
        if stack:
            stack[-1].child_ns += ns
        return False


def add(name: str, count: int, total_ns: int, children=()) -> None:
    """Add ``count`` untraced spans of ``name`` that took ``total_ns``
    together, as if each had been opened with ``span`` on this thread;
    ``children``: the (name, count, total ns) of the spans inside them,
    which hold none. A loop that times its iterations itself adds them
    once, for the cost of a few clock reads an iteration."""
    child_ns = 0
    with _LOCK:
        bucket = _TOTALS["untraced"]
        for cname, ccount, cns in children:
            _bump(bucket, cname, ccount, cns, cns)
            child_ns += cns
        _bump(bucket, name, count, total_ns, total_ns - child_ns)
    stack = _stack()
    if stack:
        stack[-1].child_ns += total_ns


def snapshot() -> dict:
    """``{"untraced": {...}, "traced": {...}}``, each span name mapped to
    ``{"count", "total_ns", "self_ns"}``."""
    with _LOCK:
        return {b: {n: {"count": c, "total_ns": t, "self_ns": s}
                    for n, (c, t, s) in names.items()}
                for b, names in _TOTALS.items()}


def reset() -> None:
    """Clear every total and graph count (spans open now still add
    theirs when they close)."""
    with _LOCK:
        for names in _TOTALS.values():
            names.clear()
        _GRAPHS.clear()


def count_graph(kind: str, nodes: dict) -> None:
    """Add one captured graph of ``kind`` and its ``nodes`` ({"nodes":
    all, type: count}) to the graph counts."""
    with _LOCK:
        t = _GRAPHS.setdefault(kind, {"graphs": 0})
        t["graphs"] += 1
        for name, n in nodes.items():
            t[name] = t.get(name, 0) + n


def graph_nodes() -> dict:
    """A copy of the graph counts: step kind -> {"graphs", "nodes",
    and a count per node type}."""
    with _LOCK:
        return {kind: dict(t) for kind, t in _GRAPHS.items()}


def epoch_numbers(now: dict, before: dict | None = None) -> dict:
    """The training path's three numbers over the spans of one bucket of
    ``snapshot()`` (``now``), less those of ``before``: ``graph_launch_us``,
    the host's microseconds in one training step's graph launch;
    ``step_host_us``, a training step's own host work outside it (the
    batch's copies, the schedule's advance); ``epoch_host_share``, the
    percentage of the epochs' and evaluations' host time outside their
    steps and reads, of their time less the one-time work in them (eager
    warm-ups, the first of which builds the kernels, and captures). Each
    None where its denominator is 0. The totals are the process's, every
    thread's together."""
    before = before or {}

    def get(name, field):
        return (now.get(name, {}).get(field, 0)
                - before.get(name, {}).get(field, 0))

    launches, steps = get("train.launch", "count"), get("train.step", "count")
    phases = get("train.epoch", "total_ns") + get("eval.pass", "total_ns")
    host = (phases - get("train.step", "total_ns") - get("eval.step", "total_ns")
            - get("read", "total_ns"))
    steady = phases - (get("train.eager", "total_ns")
                       + get("eval.eager", "total_ns") + get("capture", "total_ns"))
    return {
        "graph_launch_us": (get("train.launch", "total_ns") / launches / 1e3
                            if launches else None),
        "step_host_us": (get("train.step", "self_ns") / steps / 1e3
                         if steps else None),
        "epoch_host_share": host / steady * 100.0 if steady > 0 else None,
    }

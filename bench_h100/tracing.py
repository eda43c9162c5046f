"""The benchmark's own spans and its reading of a ``torch.profiler`` trace.

``Phases`` times set-up's phases on the host clock. ``Trace`` profiles a
steady stretch of the window (CPU and CUDA activities) and reduces it,
straight from the profiler's raw events, to: the seconds in which any operation ran on the device, the
traced window's length, each device operation's total time and count (in
all, and within each named span the harness opened), and the longest idle
gaps, named by what the host was doing.
"""

from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple


class Phases:
    """Host-clock seconds of set-up's phases, reported on standard error."""

    def __init__(self):
        self._t = time.perf_counter()
        self.rows: List[Tuple[str, float]] = []

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.rows.append((name, now - self._t))
        self._t = now

    def report(self) -> None:
        print("set-up phases: " + ", ".join(f"{n} {s:.3f} s"
                                            for n, s in self.rows),
              file=sys.stderr)


class TraceSummary:
    """What the metric readers take from a trace."""

    def __init__(self, busy_s: float, window_s: float,
                 ops: Dict[str, Tuple[float, int]],
                 ops_by_span: Dict[str, Dict[str, Tuple[float, int]]],
                 idle_gaps: List[Tuple[str, float]],
                 counters: Optional[dict] = None):
        self.busy_s = busy_s
        self.window_s = window_s
        self.ops = ops
        self.ops_by_span = ops_by_span
        self.idle_gaps = idle_gaps
        self.counters = counters or {}

    def op_stats(self, names, span: Optional[str] = None) -> Tuple[float, int]:
        """(total seconds, count) of the device operations whose name
        contains any of ``names``, in all or within ``span``."""
        table = self.ops if span is None else self.ops_by_span.get(span, {})
        total, count = 0.0, 0
        for op, (s, n) in table.items():
            if any(x in op for x in names):
                total += s
                count += n
        return total, count

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:10]
        return {"device_ops": [[n, s] for n, (s, _) in top],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps[:10]]}


class Trace:
    """A ``torch.profiler`` session over a stretch of the window; spans
    opened with ``span`` inside it are recorded on the host timeline and
    attribute each device operation that starts within them."""

    def __init__(self):
        self._prof = None
        self._t0 = self._t1 = None
        self.summary: Optional[TraceSummary] = None

    @staticmethod
    def _profile():
        from torch.profiler import ProfilerActivity, profile

        return profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    @classmethod
    def warm(cls) -> None:
        """Start and stop the profiler once, in set-up: its first start
        initialises the device tracer, which takes seconds, and would
        otherwise fall in the window."""
        with cls._profile():
            pass

    def __enter__(self):
        import torch

        torch.cuda.synchronize()
        self._prof = self._profile()
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        self._t1 = time.perf_counter()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(self._prof.profiler.kineto_results.events(),
                                     self._t1 - self._t0)
        return False

    @staticmethod
    def span(name: str):
        """A span on the profiler's host timeline, ``bench.<name>``."""
        from torch.profiler import record_function

        return record_function(f"bench.{name}")


def summarize(events, window_s: float) -> TraceSummary:
    """Reduce raw profiler events to a ``TraceSummary``."""
    dev, cpu, spans = [], [], []
    for e in events:
        kind = str(e.device_type())
        if kind.endswith("CUDA"):
            if e.is_user_annotation():
                continue
            dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                        e.name()))
        elif kind.endswith("CPU"):
            item = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            if e.name().startswith("bench."):
                spans.append(item)
            else:
                cpu.append(item)
    dev.sort()
    ops: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    by_span: Dict[str, Dict[str, List[float]]] = defaultdict(
        lambda: defaultdict(lambda: [0.0, 0]))
    spans.sort()
    busy_ns, cur_lo, cur_hi = 0, None, None
    gaps = []
    for lo, hi, name in dev:
        s = ops[name]
        s[0] += (hi - lo) / 1e9
        s[1] += 1
        for slo, shi, sname in spans:
            if slo <= lo < shi:
                t = by_span[sname[len("bench."):]][name]
                t[0] += (hi - lo) / 1e9
                t[1] += 1
                break
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                busy_ns += cur_hi - cur_lo
                gaps.append((lo - cur_hi, cur_hi))
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        busy_ns += cur_hi - cur_lo
    return TraceSummary(
        busy_ns / 1e9, window_s,
        {k: (v[0], int(v[1])) for k, v in ops.items()},
        {sp: {k: (v[0], int(v[1])) for k, v in t.items()}
         for sp, t in by_span.items()},
        _name_gaps(gaps, cpu))


def _name_gaps(gaps, cpu, longest: int = 2000) -> List[Tuple[str, float]]:
    """Idle seconds between device operations, summed by the innermost host
    operation running where each gap starts (the ``longest`` gaps)."""
    cpu.sort()
    starts = [c[0] for c in cpu]
    total: Dict[str, float] = defaultdict(float)
    for dur, at in sorted(gaps, reverse=True)[:longest]:
        name = "host: no operation recorded"
        i = bisect.bisect_right(starts, at) - 1
        seen = 0
        while i >= 0 and seen < 5000:
            lo, hi, n = cpu[i]
            if hi >= at:
                name = n
                break
            i -= 1
            seen += 1
        total[name] += dur / 1e9
    return sorted(total.items(), key=lambda kv: -kv[1])

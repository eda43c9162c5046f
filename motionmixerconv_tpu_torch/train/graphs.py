"""A sequence of batches as replays of one captured CUDA graph.

The port's counterpart of the JAX package's ``lax.scan`` over an epoch's
batches (``motionmixerconv_tpu/train/loop.py`` ``_train_epoch_scan_impl``,
and the scanned evaluation of ``evaluate_grouped``): the host launches a
step's few hundred to few thousand kernels once, at capture, and then
replays them with one call a batch. A step's body must do only device
work: whatever it decides on the host (a Python branch, a cache lookup, a
counter) is fixed at capture and is not re-run by a replay.

Concurrent trainers (a study's ``--n_jobs 2`` trials, threads of one
process on one card): every call of a CUDA ``StepGraph`` (an eager warm-up
call, the capture, a replay) holds ``GRAPH_LOCK``, and each capture is
thread-local (``capture_error_mode="thread_local"``) on the graph's own
side stream. The lock keeps every other trainer's step off the card's one
CUDA generator while a capture is underway: a dropout draw or a replay's
offset advance from another thread then raises ("Offset increment outside
graph capture"), and entering ``torch.cuda.graph`` synchronizes the device
and empties the allocator's cache, which the allocator refuses while
another capture is underway. Thread-local capture lets the other thread's
remaining CUDA calls (copies, allocations, host reads) neither fail nor
poison the capture. The studies run each trial on a stream of its own,
off the legacy default stream (``sweep/engine.py``). The lock serializes
only the host's enqueue of steps, which the interpreter lock serializes
anyway; the card still runs both trials' kernels.

Every call is a ``<kind>.step`` span of ``profiling``, holding a
``<kind>.launch`` (the replay), ``<kind>.eager`` or ``capture`` span; with
no profiler recording, ``run`` times its calls itself and adds the spans
once. No span is opened inside the captured body. Each capture records its
graph's nodes, by CUDA node type, in ``profiling.count_graph``: read from
the captured ``cudaGraph_t`` (kept until it is counted, then instantiated)
through the driver's ``cuGraphGetNodes``; a replay records nothing.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import gc
import threading
import time
from collections import Counter
from typing import Callable, Optional, Sequence

import torch

from .. import profiling

# eager calls on a side stream before the capture (PyTorch's recipe: lazy
# initialisation -- a library's load, cuBLAS workspaces, an optimizer's
# state -- must not land in the graph); they are real steps, the first
# batches of the sequence
WARMUP_CALLS = 3
GRAPH_LOCK = threading.Lock()  # held by every call of a CUDA StepGraph
# the driver API's CUgraphNodeType values a step's capture holds; any other
# type is counted as "type_<value>"
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset"}


@functools.lru_cache(maxsize=None)
def _driver() -> ctypes.CDLL:
    """The CUDA driver library, with the two graph queries declared."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_int)]
    lib.cuGraphNodeGetType.restype = ctypes.c_int
    return lib


def _checked(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} failed with CUresult {rc}")


def graph_node_counts(graph: torch.cuda.CUDAGraph) -> dict:
    """{"nodes": all, and a count per node type} of a graph captured with
    ``keep_graph=True``, before or after its instantiation."""
    lib = _driver()
    handle = ctypes.c_void_p(int(graph.raw_cuda_graph()))
    n = ctypes.c_size_t(0)
    _checked("cuGraphGetNodes", lib.cuGraphGetNodes(handle, None,
                                                    ctypes.byref(n)))
    nodes = (ctypes.c_void_p * n.value)()
    _checked("cuGraphGetNodes", lib.cuGraphGetNodes(handle, nodes,
                                                    ctypes.byref(n)))
    kinds: Counter = Counter()
    kind = ctypes.c_int()
    for node in nodes[: n.value]:
        _checked("cuGraphNodeGetType",
                 lib.cuGraphNodeGetType(node, ctypes.byref(kind)))
        kinds[NODE_TYPES.get(kind.value, f"type_{kind.value}")] += 1
    return {"nodes": n.value, **kinds}


class StepGraph:
    """Runs ``body(sums, *batch)`` once for each batch of stacked inputs;
    ``body`` adds what it measures into ``sums``, a device tensor of
    ``sums_shape`` that the runner owns.

    With ``capture`` (on a CUDA device only), the first ``WARMUP_CALLS``
    calls run eagerly on a side stream, the next one captures ``body`` on
    static copies of its batch into a ``torch.cuda.CUDAGraph``, and every
    call after that copies its batch into those static tensors on the
    device and replays the graph. A failed capture or replay raises; the
    runner never falls back to eager calls. Without ``capture`` every call
    runs eagerly on the current stream: the CPU's path, and the card's
    eager path that the graph is held against. ``kind`` ("train" or
    "eval") names the runner's spans.
    """

    def __init__(self, body: Callable[..., None], device: torch.device,
                 sums_shape: Sequence[int], capture: bool,
                 kind: str = "train"):
        if capture and device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
        self.body = body
        self.device = device
        self.capture = capture
        self.sums = torch.zeros(tuple(sums_shape), device=device)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.static: Optional[list] = None
        self.eager_calls = 0
        self._side = torch.cuda.Stream(device) if capture else None
        self._lock = GRAPH_LOCK if capture else contextlib.nullcontext()
        self.kind = kind
        self._step, self._launch, self._eager = (
            f"{kind}.step", f"{kind}.launch", f"{kind}.eager")

    def run(self, *stacked: torch.Tensor,
            after: Optional[Callable[[], None]] = None) -> torch.Tensor:
        """Zero the sums, run the body over ``stacked``'s leading axis
        (calling ``after`` on the host after each batch), and return a copy
        of the sums on the device. No host read."""
        self.sums.zero_()
        n = stacked[0].shape[0]
        if profiling.recording():
            for i in range(n):
                with profiling.span(self._step):
                    with self._lock:
                        name, call = self._next([t[i] for t in stacked])
                        with profiling.span(name):
                            call()
                    if after is not None:
                        after()
            return self.sums.clone()
        # the steps tile the loop, and two clock reads a step time its
        # inner span: the runner's usual one (a launch on the card, an eager
        # call on the CPU) summed in a local, the few others listed
        clock = time.perf_counter_ns
        usual = self._launch if self.capture else self._eager
        usual_ns, others = 0, []
        t_loop = clock()
        for i in range(n):
            with self._lock:
                name, call = self._next([t[i] for t in stacked])
                t1 = clock()
                call()
                t2 = clock()
            if after is not None:
                after()
            if name is usual:
                usual_ns += t2 - t1
            else:
                others.append((name, 1, t2 - t1))
        if n:
            inner = [(usual, n - len(others), usual_ns), *others]
            profiling.add(self._step, n, clock() - t_loop,
                          [c for c in inner if c[1]])
        return self.sums.clone()

    def _next(self, batch):
        """The next call on ``batch``: its span's name, and what runs it
        (the batch copied into the graph's static inputs first)."""
        if not self.capture:
            return self._eager, lambda: self.body(self.sums, *batch)
        if self.graph is not None:
            for s, b in zip(self.static, batch):
                s.copy_(b)
            return self._launch, self.graph.replay
        if self.eager_calls < WARMUP_CALLS:
            return self._eager, lambda: self._warm_up(batch)
        return "capture", lambda: self._capture_graph(batch)

    def _warm_up(self, batch) -> None:
        main = torch.cuda.current_stream(self.device)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            self.body(self.sums, *batch)
        main.wait_stream(self._side)
        self.eager_calls += 1

    def _capture_graph(self, batch) -> None:
        self.static = [b.clone() for b in batch]
        # kept after the capture, so that its nodes can be counted
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        # An unreachable CUDAGraph (an earlier trainer's, in a reference
        # cycle) that the cyclic collector frees inside the body destroys
        # its graph there, which invalidates the capture (PyTorch no longer
        # collects when a capture begins). So the collector stays off until
        # the capture ends; what it owes is collected after.
        was_enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=self._side,
                                  capture_error_mode="thread_local"):
                self.body(self.sums, *self.static)
        finally:
            if was_enabled:
                gc.enable()
        profiling.count_graph(self.kind, graph_node_counts(graph))
        graph.instantiate()
        self.graph = graph
        graph.replay()  # the capture ran nothing: this is the step

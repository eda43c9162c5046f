"""A sequence of batches as replays of one captured CUDA graph.

The port's counterpart of the JAX package's ``lax.scan`` over an epoch's
batches (``motionmixerconv_tpu/train/loop.py`` ``_train_epoch_scan_impl``,
and the scanned evaluation of ``evaluate_grouped``): the host launches a
step's few hundred to few thousand kernels once, at capture, and then
replays them with one call a batch. A step's body must do only device
work: whatever it decides on the host (a Python branch, a cache lookup, a
counter) is fixed at capture and is not re-run by a replay.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

# eager calls on a side stream before the capture (PyTorch's recipe: lazy
# initialisation -- a library's load, cuBLAS workspaces, an optimizer's
# state -- must not land in the graph); they are real steps, the first
# batches of the sequence
WARMUP_CALLS = 3


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
    eager path that the graph is held against.
    """

    def __init__(self, body: Callable[..., None], device: torch.device,
                 sums_shape: Sequence[int], capture: bool):
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

    def run(self, *stacked: torch.Tensor,
            after: Optional[Callable[[], None]] = None) -> torch.Tensor:
        """Zero the sums, run the body over ``stacked``'s leading axis
        (calling ``after`` on the host after each batch), and return a copy
        of the sums on the device. No host read."""
        self.sums.zero_()
        for i in range(stacked[0].shape[0]):
            self._call([t[i] for t in stacked])
            if after is not None:
                after()
        return self.sums.clone()

    def _call(self, batch) -> None:
        if self.graph is not None:
            for s, b in zip(self.static, batch):
                s.copy_(b)
            self.graph.replay()
        elif not self.capture:
            self.body(self.sums, *batch)
        elif self.eager_calls < WARMUP_CALLS:
            main = torch.cuda.current_stream(self.device)
            self._side.wait_stream(main)
            with torch.cuda.stream(self._side):
                self.body(self.sums, *batch)
            main.wait_stream(self._side)
            self.eager_calls += 1
        else:
            self.static = [b.clone() for b in batch]
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.body(self.sums, *self.static)
            self.graph = graph
            graph.replay()  # the capture ran nothing: this is the step

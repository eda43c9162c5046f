"""Windowed-corpus representation and samplers.

Counterpart of ``motionmixerconv_tpu/data/windows.py``. The whole
preprocessed corpus lives as one tensor on the training device and a
window is an index gather, ``frames[start + arange(seq_len)]``, done inside
the train step: no host-to-device copy per step and no loader workers.

``find_indices_256`` / ``find_indices_srnn`` reproduce the reference's
SRNN-seeded test-window selection bit for bit (the same numpy RandomState
consumption order; h36m/utils/data_utils.py:600-663), and ``batch_starts``
the JAX package's shuffle (``np.random.default_rng(seed)``), so one seed
gives both packages the same batches.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

SRNN_SEED = 1234567890  # h36m/utils/data_utils.py:611,643


def _find_indices(
    frame_num1: int, frame_num2: int, seq_len: int, input_n: int, count: int
) -> Tuple[np.ndarray, np.ndarray]:
    rng = np.random.RandomState(SRNN_SEED)
    T1 = frame_num1 - 150
    T2 = frame_num2 - 150
    idxo1, idxo2 = [], []
    for _ in range(count):
        idx_ran1 = rng.randint(16, T1)
        idx_ran2 = rng.randint(16, T2)
        idxo1.append(np.arange(idx_ran1 + 50 - input_n,
                               idx_ran1 + 50 - input_n + seq_len))
        idxo2.append(np.arange(idx_ran2 + 50 - input_n,
                               idx_ran2 + 50 - input_n + seq_len))
    return np.stack(idxo1), np.stack(idxo2)


def find_indices_256(frame_num1, frame_num2, seq_len, input_n=10):
    """128+128 SRNN-seeded test windows (h36m/utils/data_utils.py:600-629)."""
    return _find_indices(frame_num1, frame_num2, seq_len, input_n, 128)


def find_indices_srnn(frame_num1, frame_num2, seq_len, input_n=10):
    """4+4 SRNN-seeded test windows (h36m/utils/data_utils.py:632-663)."""
    return _find_indices(frame_num1, frame_num2, seq_len, input_n, 4)


@dataclasses.dataclass
class WindowedCorpus:
    """A preprocessed corpus: concatenated frames + window start indices.

    ``frames`` is (N_total, D) over all sequences laid end to end (numpy,
    on the host); ``window_starts`` are global frame indices such that
    ``frames[s : s + seq_len]`` never crosses a sequence boundary.
    """

    frames: np.ndarray
    window_starts: np.ndarray
    seq_len: int

    def __len__(self) -> int:
        return int(self.window_starts.shape[0])

    def __getitem__(self, item: int) -> np.ndarray:
        s = int(self.window_starts[item])
        return self.frames[s : s + self.seq_len]

    def frames_on(self, device) -> torch.Tensor:
        """The frames as one float32 tensor on ``device``."""
        return torch.as_tensor(self.frames, dtype=torch.float32).to(device)


def gather_windows(frames: torch.Tensor, starts: torch.Tensor,
                   seq_len: int) -> torch.Tensor:
    """Gather (B, seq_len, D) windows from an (N, D) corpus, on the corpus's
    device. ``starts`` must be in range (``batch_starts`` pads with the
    corpus's first window); an index out of range raises."""
    idx = starts[:, None] + torch.arange(seq_len, device=starts.device)
    return frames[idx]


def batch_starts(
    corpus: WindowedCorpus,
    batch_size: int,
    *,
    shuffle: bool,
    seed: Optional[int] = None,
    pad_to_full: bool = True,
    order: Optional[np.ndarray] = None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (starts, weight) batches covering every window exactly once.

    The last batch is padded up to ``batch_size`` by repeating window 0
    (``window_starts[0]``) with weight 0, so every step has one shape;
    ``weight`` is (B,) float32 in {0, 1}, and losses and metrics weighted by
    it equal the reference's ragged-batch averages. A padding row reads a
    valid window, so it is finite wherever the windows are: NaN times 0 is
    still NaN. (The JAX package pads with frame 0 of the corpus, the same
    start wherever the first window starts there.) ``pad_to_full=False``
    leaves the last batch ragged.

    ``order`` replaces the shuffle with an explicit window permutation: the
    lockstep parity runs replay a recorded reference's batch stream
    (``parity_runs.py``).
    """
    if order is not None:
        order = np.asarray(order)
        if order.shape[0] != len(corpus):
            raise ValueError(
                f"order has {order.shape[0]} entries for {len(corpus)} windows"
            )
    else:
        order = np.arange(len(corpus))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
    starts = corpus.window_starts[order]
    n = len(order)
    for lo in range(0, n, batch_size):
        chunk = starts[lo : lo + batch_size]
        w = np.ones(len(chunk), dtype=np.float32)
        if pad_to_full and len(chunk) < batch_size:
            pad = batch_size - len(chunk)
            chunk = np.concatenate(
                [chunk, np.full(pad, corpus.window_starts[0], chunk.dtype)])
            w = np.concatenate([w, np.zeros(pad, dtype=np.float32)])
        yield chunk.astype(np.int32), w

"""The benchmark's seeded Human3.6M corpus: raw expmap sequences in the
dataset's layout, made from ``--seed`` alone.

A copy of the port's ``data/fixtures.py`` generator (``_smooth_walk``: an
integrated, low-pass-filtered random walk per dimension; the fixtures'
random global translation is left out, as the data set-up zeroes dims
0:6 whatever they hold), drawn from a NumPy ``SeedSequence`` of (seed, subject,
action, subaction) so that any subset of the files is the same whichever
cell asks for it, and so that seeds beyond 32 bits work. Values are
multiples of 2**-8 written with their eight decimals, which every float
parser reads back exactly: the program, which parses the CSV, and the
reference, which takes these arrays, start from the same float32 numbers
(the harmonic encoder's top frequencies turn a one-ulp difference of an
input into a different feature).
"""

from __future__ import annotations

import os

import numpy as np

ACTIONS = ("walking", "eating", "smoking", "discussion", "directions",
           "greeting", "phoning", "posing", "purchases", "sitting",
           "sittingdown", "takingphoto", "waiting", "walkingdog",
           "walkingtogether")
SPLITS = {0: (1, 6, 7, 8, 9), 1: (11,), 2: (5,)}  # train, validation, test
RAW_DIMS = 99
STEP_SCALE = 0.02
SMOOTH = 9  # the low-pass filter's width, in frames
QUANTUM = 2.0 ** -8
# the eight decimals of j / 256, j = 0..255, as ASCII digits
_DECIMALS = np.array([list(f"{j * 390625:08d}".encode()) for j in range(256)],
                     np.uint8)


def sequence(seed: int, subject: int, action: int, subaction: int,
             n_frames: int) -> np.ndarray:
    """(n_frames, 99) float64 expmap frames at the raw 50 Hz, multiples of
    ``QUANTUM``."""
    rng = np.random.default_rng([int(seed), subject, action, subaction])
    steps = rng.standard_normal((n_frames, RAW_DIMS)) * STEP_SCALE
    half = SMOOTH // 2
    padded = np.concatenate([np.zeros((half + 1, RAW_DIMS)), steps,
                             np.zeros((half, RAW_DIMS))])
    c = np.cumsum(padded, axis=0)
    smooth = (c[SMOOTH:] - c[:-SMOOTH]) / SMOOTH  # 'same' moving average
    frames = np.cumsum(smooth, axis=0)
    return np.round(frames / QUANTUM) * QUANTUM


def split_sequences(seed: int, split: int, n_frames: int, actions=ACTIONS):
    """[(subject, action name, subaction, frames)] of a split, in the order
    the dataset concatenates them: subject, action, subaction."""
    return [(s, a, sub, sequence(seed, s, ACTIONS.index(a), sub, n_frames))
            for s in SPLITS[split] for a in actions for sub in (1, 2)]


def csv_bytes(frames: np.ndarray) -> bytes:
    """``frames`` (multiples of ``QUANTUM``, each under 10 in magnitude) as
    CSV text, every value in the fixed form ``+d.dddddddd``: the exact
    decimal of a multiple of 2**-8, which a float parser reads back
    exactly. Formatted with integer arithmetic, all values at once."""
    k = np.rint(frames / QUANTUM).astype(np.int64)
    if np.abs(k).max() >= 10 * 256:
        raise ValueError("corpus values must lie within (-10, 10)")
    a = np.abs(k)
    out = np.empty(k.shape + (12,), np.uint8)
    out[..., 0] = np.where(k < 0, ord("-"), ord("+"))
    out[..., 1] = ord("0") + a // 256
    out[..., 2] = ord(".")
    out[..., 3:11] = _DECIMALS[a % 256]
    out[..., 11] = ord(",")
    out[:, -1, 11] = ord("\n")
    return out.tobytes()


def write_csv(data_dir: str, seqs) -> str:
    """Write ``seqs`` (``split_sequences`` items) as the dataset's
    ``h3.6m/dataset/S{subject}/{action}_{subaction}.txt`` files."""
    for subject, action, sub, frames in seqs:
        d = os.path.join(data_dir, "h3.6m", "dataset", f"S{subject}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f"{action}_{sub}.txt"), "wb") as f:
            f.write(csv_bytes(frames))
    return data_dir

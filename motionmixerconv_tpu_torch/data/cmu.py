"""CMU-mocap data pipeline (expmap and 3D-xyz variants).

Counterpart of ``motionmixerconv_tpu/data/cmu.py`` (reference
h36m/utils/data_utils.py:310-464: ``define_actions_cmu``,
``load_data_cmu``, ``load_data_cmu_3d``). The reference never trains on
CMU, and its 3D loader cannot run as written (it calls
``expmap2xyz_torch_cmu``, data_utils.py:413, which is defined nowhere); the
xyz path here composes the batched ``fkl`` with ``cmu_skeleton()``, the
evident intent, as the JAX package does.

As ``data/h36m.py``: the corpus is one concatenated frame array (FK in one
call for xyz) plus window-start indices; the reference's dense
``sampled_seq`` (a (windows, seq_len, D) copy, stride 1) is built only by
the reference-signature loaders.

CMU frame layout: 117 dims = 3 root-translation + 38 joints x 3 expmap.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..geometry.forward_kinematics import cmu_skeleton, fkl
from .h36m import read_csv_floats
from .windows import WindowedCorpus

# data_utils.py:321-323
CMU_ACTIONS = (
    "basketball", "basketball_signal", "directing_traffic", "jumping",
    "running", "soccer", "walking", "washwindow",
)

CMU_SAMPLE_RATE = 2  # 2x downsample (data_utils.py:348-349)
CMU_TEST_SEED = 1234567890  # reseeded per FILE (data_utils.py:369-370)
_TEST_SOURCE_LEN = 50  # data_utils.py:365-368
_TEST_TARGET_LEN = 25
_TEST_WINDOWS_PER_FILE = 8

# 13 joints dropped from the 38-joint xyz skeleton (data_utils.py:452-453),
# in the reference's unsorted (x-block, y-block, z-block) order, which
# consumers index with directly
CMU_JOINT_TO_IGNORE_3D = np.array([0, 1, 2, 7, 8, 13, 16, 20, 29, 24, 27, 33,
                                   36])


def define_actions_cmu(action: str) -> list[str]:
    """Action name -> action list (data_utils.py:310-330)."""
    if action in CMU_ACTIONS:
        return [action]
    if action == "all":
        return list(CMU_ACTIONS)
    raise ValueError(f"Unrecognized CMU action: {action}")


def expmap2xyz_cmu(expmap: torch.Tensor) -> torch.Tensor:
    """(N, 117) CMU expmap frames -> (N, 38, 3) joint xyz: batched FK over
    the 38-joint tree of ``_some_variables_cmu`` (forward_kinematics.py:
    138-216) with ``fkl_torch``'s root-child semantics (:238-240), the
    working equivalent of the reference's missing ``expmap2xyz_torch_cmu``."""
    return fkl(expmap, cmu_skeleton())


def _action_files(path_to_dataset: str, action: str) -> list[str]:
    """One action's files as the reference enumerates them: count the
    directory's entries, then open {action}_{1..count}.txt
    (data_utils.py:340-345)."""
    adir = os.path.join(path_to_dataset, action)
    count = len(os.listdir(adir))
    return [os.path.join(adir, f"{action}_{i + 1}.txt") for i in range(count)]


def _load_sequences(path_to_dataset: str, actions) -> list[np.ndarray]:
    """The downsampled expmap sequence of each file, in the reference's
    order (the xyz mode's FK runs once over the concatenated corpus; FK is
    per frame, so the values are those of the reference's file-by-file
    conversion, data_utils.py:410-416)."""
    return [np.array(read_csv_floats(p)[::CMU_SAMPLE_RATE], dtype=np.float32)
            for action in actions
            for p in _action_files(path_to_dataset, action)]


def _train_starts(num_frames: int, seq_len: int) -> np.ndarray:
    """Every window, stride 1 (data_utils.py:351-356)."""
    return np.arange(0, num_frames - seq_len + 1)


def _test_starts(num_frames: int, input_n: int) -> np.ndarray:
    """8 SRNN-seeded windows; the RandomState is reseeded for every file
    (data_utils.py:364-377), so files of equal length draw the same
    windows."""
    rng = np.random.RandomState(CMU_TEST_SEED)
    total = _TEST_SOURCE_LEN + _TEST_TARGET_LEN
    idx = np.array([rng.randint(0, num_frames - total)
                    for _ in range(_TEST_WINDOWS_PER_FILE)])
    return idx + _TEST_SOURCE_LEN - input_n


class CMUDataset(WindowedCorpus):
    """CMU windowed corpus.

    Args:
        data_dir: root holding ``{action}/{action}_{i}.txt`` CSV files.
        input_n / output_n: window split (window length = input_n + output_n).
        actions: action subset (default: all 8, data_utils.py:321-323).
        split: 0 train (every stride-1 window) / 2 test (8 seeded windows a
            file at the reference's 50/25 source/target offsets).
        mode: 'expmap' (the raw 117-dim frames, ``load_data_cmu``) or 'xyz'
            (FK to 114-dim joint positions, ``load_data_cmu_3d``'s intent).
        data_mean / data_std: the train split's statistics, which the test
            split takes (the reference threads them through the same way).

    Attributes:
        data_mean / data_std: per-dim statistics of the concatenated corpus
            (train) or the values passed in (test), ignored dims at mean 0
            and std 1 (data_utils.py:385-391, 458-461).
        dimensions_to_ignore / dimensions_to_use: expmap: the std < 1e-4
            threshold; xyz: the fixed 13-joint table.
    """

    def __init__(self, data_dir: str, input_n: int, output_n: int,
                 actions=None, split: int = 0, mode: str = "expmap",
                 data_mean: Optional[np.ndarray] = None,
                 data_std: Optional[np.ndarray] = None):
        if mode not in ("expmap", "xyz"):
            raise ValueError(f"mode must be 'expmap' or 'xyz', got {mode}")
        if split not in (0, 2):
            raise ValueError("CMU has train (0) and test (2) splits only")
        self.mode = mode
        self.split = split
        self.in_n = input_n
        self.out_n = output_n
        seq_len = input_n + output_n
        acts = list(actions) if actions is not None else list(CMU_ACTIONS)

        raw_seqs = _load_sequences(data_dir, acts)
        lengths = np.array([s.shape[0] for s in raw_seqs])
        offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        local = [_train_starts(n, seq_len) if split == 0
                 else _test_starts(n, input_n) for n in lengths]
        window_starts = np.concatenate(
            [off + ls for off, ls in zip(offsets, local)]).astype(np.int64)

        raw = np.concatenate(raw_seqs, axis=0)  # (N, 117)
        if mode == "xyz":
            with torch.no_grad():  # one batched FK over the whole corpus
                frames = expmap2xyz_cmu(torch.from_numpy(raw)).reshape(
                    raw.shape[0], 38 * 3).numpy()
        else:
            frames = raw

        d = frames.shape[1]
        if split == 0:
            self.data_std = frames.std(axis=0)
            self.data_mean = frames.mean(axis=0)
        else:
            if data_std is None or data_mean is None:
                raise ValueError("test split needs train data_mean/data_std")
            self.data_std = np.array(data_std, dtype=np.float64)
            self.data_mean = np.array(data_mean, dtype=np.float64)
        if mode == "expmap":
            self.dimensions_to_ignore = np.where(self.data_std < 1e-4)[0]
            self.dimensions_to_use = np.where(self.data_std >= 1e-4)[0]
        else:
            j = CMU_JOINT_TO_IGNORE_3D
            self.dimensions_to_ignore = np.concatenate(
                (j * 3, j * 3 + 1, j * 3 + 2))
            self.dimensions_to_use = np.setdiff1d(np.arange(d),
                                                  self.dimensions_to_ignore)
        self.data_std[self.dimensions_to_ignore] = 1.0
        self.data_mean[self.dimensions_to_ignore] = 0.0
        self.dim_used = self.dimensions_to_use

        super().__init__(frames=frames, window_starts=window_starts,
                         seq_len=seq_len)

    def dense_windows(self) -> np.ndarray:
        """Every window as (n_windows, seq_len, D): the reference's
        ``sampled_seq``."""
        idx = self.window_starts[:, None] + np.arange(self.seq_len)[None, :]
        return self.frames[idx]


def _load_data_cmu_common(path_to_dataset, actions, input_n, output_n,
                          data_std, data_mean, is_test, mode):
    ds = CMUDataset(
        path_to_dataset, input_n, output_n, actions=actions,
        split=2 if is_test else 0, mode=mode,
        data_mean=np.asarray(data_mean, dtype=np.float64) if is_test else None,
        data_std=np.asarray(data_std, dtype=np.float64) if is_test else None)
    return (ds.dense_windows(), ds.dimensions_to_ignore, ds.dimensions_to_use,
            ds.data_mean, ds.data_std)


def load_data_cmu(path_to_dataset, actions, input_n, output_n, data_std=0,
                  data_mean=0, is_test=False):
    """The reference-signature expmap loader (data_utils.py:333-394):
    ``(sampled_seq, dimensions_to_ignore, dimensions_to_use, data_mean,
    data_std)``: stride-1 train windows or 8 seeded test windows a file,
    2x downsample, statistics over the concatenated corpus, the std < 1e-4
    ignore threshold."""
    return _load_data_cmu_common(path_to_dataset, actions, input_n, output_n,
                                 data_std, data_mean, is_test, mode="expmap")


def load_data_cmu_3d(path_to_dataset, actions, input_n, output_n, data_std=0,
                     data_mean=0, is_test=False):
    """The reference-signature xyz loader (data_utils.py:397-464, repaired
    as in the JAX package): every frame through FK to 38 x 3 xyz, then the
    same windows and statistics, with the fixed 13-joint ignore table
    (:452-455) in the reference's unsorted order."""
    return _load_data_cmu_common(path_to_dataset, actions, input_n, output_n,
                                 data_std, data_mean, is_test, mode="xyz")

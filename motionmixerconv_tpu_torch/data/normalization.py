"""SRNN-era normalization utilities (plain numpy).

Counterpart of ``motionmixerconv_tpu/data/normalization.py``: the
reference's call-site-free human-motion-prediction block
(h36m/utils/data_utils.py:128-277): ``unNormalizeData`` (:128-166),
``revert_output_format`` (:169-195), ``normalize_data`` (:218-248) and
``normalization_stats`` (:251-277). As in the JAX package, the reference's
``revert_output_format`` loops with Python 2's ``xrange`` (:192) and raises
NameError on Python 3; here the loop is ``range``, everything else the same.
"""

from __future__ import annotations

import numpy as np


def normalization_stats(complete_data: np.ndarray):
    """Mean and std over frames, and the constant-dimension split
    (data_utils.py:251-277): dimensions with std < 1e-4 are ignored and
    their std set to 1.0. Returns (data_mean (D,), data_std (D,),
    dimensions_to_ignore, dimensions_to_use), the index containers Python
    lists as the reference's ``.extend(list(np.where(...)))``."""
    data_mean = np.mean(complete_data, axis=0)
    data_std = np.std(complete_data, axis=0)
    dimensions_to_ignore = list(np.where(data_std < 1e-4)[0])
    dimensions_to_use = list(np.where(data_std >= 1e-4)[0])
    data_std = data_std.copy()
    data_std[dimensions_to_ignore] = 1.0
    return data_mean, data_std, dimensions_to_ignore, dimensions_to_use


def normalize_data(data: dict, data_mean: np.ndarray, data_std: np.ndarray,
                   dim_to_use, actions, one_hot: bool) -> dict:
    """Z-score every (N, D) sequence of ``data`` and keep ``dim_to_use``
    (data_utils.py:218-248). With ``one_hot`` the pose part is the first 99
    columns and the trailing ``len(actions)`` one-hot columns pass through
    unnormalized."""
    data_out = {}
    n_actions = len(actions)
    if not one_hot:
        for key in data:
            normed = (data[key] - data_mean) / data_std
            data_out[key] = normed[:, dim_to_use]
    else:
        for key in data:
            normed = (data[key][:, 0:99] - data_mean) / data_std
            data_out[key] = np.hstack(
                (normed[:, dim_to_use], data[key][:, -n_actions:]))
    return data_out


def unNormalizeData(normalized_data: np.ndarray, data_mean: np.ndarray,
                    data_std: np.ndarray, dimensions_to_ignore, actions,
                    one_hot: bool) -> np.ndarray:
    """Invert ``normalize_data`` to the full-D layout (data_utils.py:
    128-166): ignored dimensions come back as their mean (zeros are
    scattered there, then ``* std + mean`` runs over every column); with
    ``one_hot`` the trailing ``len(actions)`` input columns are dropped.
    The buffer is float32, as the reference's."""
    T = normalized_data.shape[0]
    D = data_mean.shape[0]
    ignore = set(int(i) for i in np.asarray(dimensions_to_ignore).ravel())
    dimensions_to_use = np.array([i for i in range(D) if i not in ignore])

    orig_data = np.zeros((T, D), dtype=np.float32)
    if one_hot:
        orig_data[:, dimensions_to_use] = normalized_data[:, :-len(actions)]
    else:
        orig_data[:, dimensions_to_use] = normalized_data
    return orig_data * data_std.reshape(1, D) + data_mean.reshape(1, D)


def revert_output_format(poses, data_mean: np.ndarray, data_std: np.ndarray,
                         dim_to_ignore, actions, one_hot: bool):
    """A length-``seq_len`` list of (batch, dim) model outputs -> a
    length-``batch`` list of (seq_len, D) unnormalized poses
    (data_utils.py:169-195)."""
    seq_len = len(poses)
    if seq_len == 0:
        return []
    batch_size, dim = poses[0].shape
    poses_out = np.concatenate(poses).reshape(seq_len, batch_size, dim)
    poses_out = np.transpose(poses_out, [1, 0, 2])
    return [
        unNormalizeData(poses_out[i], data_mean, data_std, dim_to_ignore,
                        actions, one_hot)
        for i in range(poses_out.shape[0])
    ]

"""AMASS skeleton graph helpers (spatio-temporal adjacency construction).

Counterpart of ``motionmixerconv_tpu/geometry/graph.py`` (reference
amass/dataloader_amass.py:154-213, defined for a GCN baseline that no
training path invokes). Plain numpy: the reference builds the adjacency
through networkx; the same symmetric 0/1 matrix is built directly.
"""

from __future__ import annotations

import numpy as np

# 22-joint AMASS edge list (dataloader_amass.py:192-205, with the two cross
# edges (1, 16) and (2, 17); the commented-out wrist and head edges are
# left out, as in the reference)
AMASS_EDGES_22 = [
    (0, 1), (0, 2),
    (1, 4), (5, 2),
    (7, 4), (8, 5),
    (7, 10), (8, 11),
    (12, 15),
    (12, 16), (12, 17),
    (16, 18), (19, 17), (20, 18), (21, 19),
    (1, 16), (2, 17),
]


def normalize_A(A: np.ndarray) -> np.ndarray:
    """Symmetric degree normalisation D^-1/2 (A + I) D^-1/2
    (dataloader_amass.py:154-167): the degree is taken after the
    self-loops are added, and D^-1/2 is the dense diagonal matrix's
    elementwise power with its off-diagonal infinities zeroed."""
    A = np.asarray(A, dtype=np.float64) + np.eye(A.shape[0])
    D = np.diag(np.sum(A, axis=0))
    with np.errstate(divide="ignore"):
        D_inv = D ** -0.5
    D_inv[np.isinf(D_inv)] = 0.0
    return D_inv @ A @ D_inv


def spatio_temporal_graph(joints_to_consider: int, temporal_kernel_size: int,
                          spatial_adjacency_matrix: np.ndarray) -> np.ndarray:
    """A normalized spatial adjacency tiled to (t, J, J) with unit
    self-edges per frame (dataloader_amass.py:173-185); the reference
    writes the self-edge, then overwrites it with the normalized value
    wherever A[i, i] != 0, which the masked copy reproduces."""
    J, t = joints_to_consider, temporal_kernel_size
    A = np.asarray(spatial_adjacency_matrix, dtype=np.float64)[:J, :J]
    frame = np.eye(J)
    mask = A != 0
    frame[mask] = A[mask]
    return np.broadcast_to(frame, (t, J, J)).copy()


def get_adj_AMASS(joints_to_consider: int,
                  temporal_kernel_size: int) -> np.ndarray:
    """The normalized spatio-temporal adjacency of the 22-joint AMASS
    skeleton (dataloader_amass.py:191-213), float32 as the reference's
    tensor. Only 22 joints have an edge list (the reference raises
    NameError otherwise; here ValueError)."""
    if joints_to_consider != 22:
        raise ValueError("only the 22-joint AMASS skeleton has an edge list")
    A = np.zeros((joints_to_consider, joints_to_consider), np.float64)
    for i, j in AMASS_EDGES_22:
        A[i, j] = A[j, i] = 1.0
    return spatio_temporal_graph(
        joints_to_consider, temporal_kernel_size, normalize_A(A)
    ).astype(np.float32)

"""Skeleton GIF rendering (matplotlib), format parity with the reference.

Counterpart of ``motionmixerconv_tpu/viz/gif.py``. ``visualize_batch``
renders the input sequence in blue, then the predicted skeleton in yellow
over the blue ground truth, frame by frame, and writes a pillow GIF — same
visual contract as conv_mixer/utils/visualization_helpers_h3m.py:70-197
(H3.6M, 26-edge tree, OpenCV->matplotlib axis swap y=-z, z=y, coordinates
/1000) and visualization_helpers_ais.py:123-263 (AIS, 19-joint parent tree,
no scaling).

Arrays or tensors in (a tensor is copied to the host first), GIF out.
matplotlib (and Pillow, its GIF writer) is imported inside the functions
only: the package imports without them.
"""

from __future__ import annotations

import numpy as np
import torch

# H3.6M 26-edge skeleton connectivity (visualization_helpers_h3m.py:102-110)
H36M_CONNECT = np.array([
    (1, 2), (2, 3), (3, 4), (4, 5),
    (6, 7), (7, 8), (8, 9), (9, 10),
    (0, 1), (0, 6),
    (6, 17), (17, 18), (18, 19), (19, 20), (20, 21), (21, 22),
    (1, 25), (25, 26), (26, 27), (27, 28), (28, 29), (29, 30),
    (24, 25), (24, 17),
    (24, 14), (14, 15),
])

# AIS 19-joint parent tree (visualization_helpers_ais.py:129)
AIS_KPS_PARENT = [-1, 0, 1, 2, 3, 1, 5, 6, 1, 8, 9, 10, 8, 12, 13, 0, 0, 15, 16]

_BLUE = "#07529a"
_YELLOW = "#eab90c"


def _host(x) -> np.ndarray:
    """``x`` as a host numpy array (a tensor from any device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _split_xyz_h36m(batch: np.ndarray):
    """(T, 96) mm -> axis-swapped meter coords (T, 32) each."""
    xs = batch[:, 0::3] / 1000.0
    ys = -batch[:, 2::3] / 1000.0
    zs = batch[:, 1::3] / 1000.0
    return xs, ys, zs


def _canvas_rgb(fig):
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    return buf.copy()


def _render_frames(ax, fig, frames_xyz, edges_fn, color, lims, title):
    images = []
    xs, ys, zs = frames_xyz
    for j in range(xs.shape[0]):
        ax.clear()
        ax.set_xlim3d(lims[0]); ax.set_xlabel("X")
        ax.set_ylim3d(lims[1]); ax.set_ylabel("Y")
        ax.set_zlim3d(lims[2]); ax.set_zlabel("Z")
        edges_fn(ax, xs[j], ys[j], zs[j], color)
        ax.set_title(title)
        images.append(_canvas_rgb(fig))
    return images


def _h36m_edges(ax, x, y, z, color):
    ax.scatter(x, y, z, c=color)
    for a, b in H36M_CONNECT:
        ax.plot([x[a], x[b]], [y[a], y[b]], [z[a], z[b]], c=color)


def _ais_edges(ax, x, y, z, color):
    ax.scatter(x, y, z, c=color)
    for k, p in enumerate(AIS_KPS_PARENT):
        if p >= 0:
            ax.plot([x[p], x[k]], [y[p], y[k]], [z[p], z[k]], c=color)


def _write_gif(images, save_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    fig = plt.figure()
    plt.axis("off")
    ims = [[plt.imshow(im, animated=True)] for im in images]
    ani = animation.ArtistAnimation(fig, ims, interval=200, repeat_delay=200, blit=True)
    ani.save(save_path, writer="pillow")
    plt.close(fig)


def _visualize(batch_full, save_path, batch_gt, batch_train, split_fn, edges_fn):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    batch_full = _host(batch_full)
    xs, ys, zs = split_fn(batch_full)
    lims = ((xs.min(), xs.max()), (ys.min(), ys.max()), (zs.min(), zs.max()))

    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    images = []

    if batch_train is not None:
        train_xyz = split_fn(_host(batch_train))
        images += _render_frames(ax, fig, train_xyz, edges_fn, _BLUE, lims, "Input")

    gt_xyz = split_fn(_host(batch_gt)) if batch_gt is not None else None
    for j in range(batch_full.shape[0]):
        ax.clear()
        ax.set_xlim3d(lims[0]); ax.set_xlabel("X")
        ax.set_ylim3d(lims[1]); ax.set_ylabel("Y")
        ax.set_zlim3d(lims[2]); ax.set_zlabel("Z")
        if gt_xyz is not None:
            edges_fn(ax, gt_xyz[0][j], gt_xyz[1][j], gt_xyz[2][j], _BLUE)
        edges_fn(ax, xs[j], ys[j], zs[j], _YELLOW)
        ax.set_title("Prediction")
        images.append(_canvas_rgb(fig))
    plt.close(fig)

    _write_gif(images, save_path)


def visualize_batch(batch_full, save_path, batch_gt=None, batch_train=None):
    """H3.6M sequence GIF: input (blue) then prediction (yellow) vs gt (blue).

    Args:
        batch_full: (T_out, 96) predicted full-skeleton frames in mm.
        save_path: output .gif path.
        batch_gt: optional (T_out, 96) ground truth.
        batch_train: optional (T_in, 96) input frames.
    """
    _visualize(batch_full, save_path, batch_gt, batch_train, _split_xyz_h36m, _h36m_edges)


def visualize_batch_ais(batch_full, save_path, batch_gt=None, batch_train=None):
    """AIS sequence GIF (57-dim frames, meters, no axis swap)."""

    def split(b):
        return b[:, 0::3], b[:, 1::3], b[:, 2::3]

    _visualize(batch_full, save_path, batch_gt, batch_train, split, _ais_edges)

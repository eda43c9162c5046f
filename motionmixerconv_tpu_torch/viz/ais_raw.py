"""Raw AIS keypoint-JSON viewer.

Counterpart of ``motionmixerconv_tpu/viz/ais_raw.py`` (host only: it runs
no model). Parity with conv_mixer/utils/visualize_ais_data.py: renders the
raw per-frame keypoints of an ``{action}.json`` recording with
per-keypoint colors and exports a GIF (and MP4 when ffmpeg is available).
Zero-score (failed) keypoints are skipped per frame.

Run: python -m motionmixerconv_tpu_torch.viz.ais_raw --data_dir ... \
    --action <name>
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from .gif import AIS_KPS_PARENT, _canvas_rgb, _write_gif


def load_raw_action(data_dir: str, action: str):
    """-> (positions (T, K, 3), scores (T, K)) from {action}.json."""
    with open(os.path.join(data_dir, f"{action}.json")) as f:
        frames = json.load(f)
    pos, score = [], []
    for fr in frames:
        kps = fr["person"]["keypoints"]
        pos.append([k["pos"] for k in kps])
        score.append([k["score"] for k in kps])
    return np.asarray(pos, np.float32), np.asarray(score, np.float32)


def visualize_raw_action(
    data_dir: str, action: str, save_path: str, max_frames: int = 200,
    stride: int = 1, mp4: bool = False,
):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pos, score = load_raw_action(data_dir, action)
    pos = pos[::stride][:max_frames]
    score = score[::stride][:max_frames]
    k_used = min(pos.shape[1], len(AIS_KPS_PARENT))
    colors = matplotlib.colormaps["tab20"](np.linspace(0, 1, k_used))

    valid = score > 0
    lims = [
        (pos[..., d][valid].min(), pos[..., d][valid].max()) for d in range(3)
    ]

    fig = plt.figure()
    ax = fig.add_subplot(111, projection="3d")
    images = []
    for t in range(pos.shape[0]):
        ax.clear()
        for d, lab in zip(range(3), "XYZ"):
            getattr(ax, f"set_{lab.lower()}lim3d")(lims[d])
            getattr(ax, f"set_{lab.lower()}label")(lab)
        for k in range(k_used):
            if score[t, k] <= 0:
                continue
            x, y, z = pos[t, k]
            ax.scatter([x], [y], [z], color=colors[k], s=12)
            p = AIS_KPS_PARENT[k]
            if p >= 0 and score[t, p] > 0:
                ax.plot(
                    [pos[t, p, 0], x], [pos[t, p, 1], y], [pos[t, p, 2], z],
                    color=colors[k], linewidth=1,
                )
        ax.set_title(f"{action} frame {t * stride}")
        images.append(_canvas_rgb(fig))
    plt.close(fig)

    _write_gif(images, save_path)
    if mp4:
        try:
            import matplotlib.animation as animation

            fig = plt.figure()
            plt.axis("off")
            ims = [[plt.imshow(im, animated=True)] for im in images]
            ani = animation.ArtistAnimation(fig, ims, interval=100, blit=True)
            ani.save(os.path.splitext(save_path)[0] + ".mp4", writer="ffmpeg")
            plt.close(fig)
        except Exception as e:  # ffmpeg missing — GIF already written
            print(f"mp4 export skipped: {e}")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--action", type=str, required=True)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--max_frames", type=int, default=200)
    parser.add_argument("--stride", type=int, default=1)
    parser.add_argument("--mp4", action="store_true")
    args = parser.parse_args(argv)
    out = args.out or f"{args.action}.gif"
    visualize_raw_action(
        args.data_dir, args.action, out,
        max_frames=args.max_frames, stride=args.stride, mp4=args.mp4,
    )
    print(f"wrote {out}")


if __name__ == "__main__":
    main()

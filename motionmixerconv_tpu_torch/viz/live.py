"""Interactive 3D prediction viewer — h36m/h36_3d_viz.py, working.

Counterpart of ``motionmixerconv_tpu/viz/live.py``; the predictions run on
``--dev`` (default ``cuda``, which raises without a card; ``--dev cpu`` on
the CPU), the rendering on the host with matplotlib, imported only by
``pose_animation`` and the ``--save``/``--show`` branch.

The reference ships an interactive FuncAnimation viewer at
h36m/h36_3d_viz.py:1-244 that is broken as-is (it imports
an undefined ``Datasets``, :10-11), but its intent is clear: load a trained
model, predict test windows, and animate ground truth (grey, dashed)
against the prediction (purple/green by body side) skeleton frame-by-frame,
with the axes re-centred on the root joint each frame (r=0.75 m,
h36_3d_viz.py:112-121). This module is the working equivalent and closes
the last unported reference file:

    python -m motionmixerconv_tpu_torch.viz.live --checkpoint run/model.pt \
        --data_dir <h36m root> --action walking --n_viz 2 \
        [--save out_dir | --show]

``--show`` opens the interactive matplotlib window (needs a display);
``--save`` writes the same animations as GIFs, so the viewer also works
headless. viz/gif.py renders the OTHER reference format (visualize_batch's
blue-input/yellow-prediction GIFs); this one renders h36_3d_viz.py's
GT-vs-pred overlay with its left/right coloring.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# h36m 32-joint edge list + left/right flags (data contract,
# h36_3d_viz.py:51-68 — same table the broken reference viewer uses)
H36M_CONNECT = [
    (1, 2), (2, 3), (3, 4), (4, 5),
    (6, 7), (7, 8), (8, 9), (9, 10),
    (0, 1), (0, 6),
    (6, 17), (17, 18), (18, 19), (19, 20), (20, 21), (21, 22),
    (1, 25), (25, 26), (26, 27), (27, 28), (28, 29), (29, 30),
    (24, 25), (24, 17),
    (24, 14), (14, 15),
]
_LR_JOINT = [
    False, True, True, True, True,
    True, False, False, False, False,
    False, True, True, True, True,
    True, True, False, False, False,
    False, False, False, False, True,
    False, True, True, True, True,
    True, True,
]
H36M_EDGE_IS_LEFT = [(_LR_JOINT[a] or _LR_JOINT[b]) for a, b in H36M_CONNECT]

PRED_COLORS = ("#9b59b6", "#2ecc71")  # left / right (h36_3d_viz.py:76-78)
GT_COLORS = ("#8e8e8e", "#383838")


def pose_animation(gt_seq: np.ndarray, pred_seq: np.ndarray, fps: int = 10,
                   title: str = ""):
    """FuncAnimation of gt (dashed grey) vs prediction over T frames.

    gt_seq/pred_seq: (T, 32, 3) joint positions (h36m layout, any unit —
    the frame limits follow the root joint at the data's own scale,
    h36_3d_viz.py:112-121).

    Returns (fig, animation); caller saves or shows it.
    """
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    gt_seq = np.asarray(gt_seq)
    pred_seq = np.asarray(pred_seq)
    assert gt_seq.shape == pred_seq.shape and gt_seq.shape[1:] == (32, 3)
    n_frames = gt_seq.shape[0]
    # radius: 0.75 at metre scale, scale-following otherwise
    r = 0.75 * max(1.0, float(np.percentile(
        np.abs(gt_seq - gt_seq[:, :1]), 99)) / 0.75)

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    if title:
        ax.set_title(title)

    def edge_xyz(vals, i):
        a, b = H36M_CONNECT[i]
        # reference swaps y/z for display (h36_3d_viz.py:84-86)
        x = np.array([vals[a, 0], vals[b, 0]])
        z = np.array([vals[a, 1], vals[b, 1]])
        y = np.array([vals[a, 2], vals[b, 2]])
        return x, y, z

    lines = []
    for seq, colors, style, label in ((gt_seq, GT_COLORS, "--", "GT"),
                                      (pred_seq, PRED_COLORS, "-", "Pred")):
        for i in range(len(H36M_CONNECT)):
            x, y, z = edge_xyz(seq[0], i)
            c = colors[0] if H36M_EDGE_IS_LEFT[i] else colors[1]
            (ln,) = ax.plot(x, y, z, lw=2, linestyle=style, c=c,
                            label=label if i == 0 else None)
            lines.append(ln)
    ax.legend(loc="lower left")

    def update(num):
        k = 0
        for seq in (gt_seq, pred_seq):
            for i in range(len(H36M_CONNECT)):
                x, y, z = edge_xyz(seq[num], i)
                lines[k].set_data_3d(x, y, z)
                k += 1
        xroot, zroot, yroot = gt_seq[num, 0]
        ax.set_xlim3d([-r + xroot, r + xroot])
        ax.set_ylim3d([-r + yroot, r + yroot])
        ax.set_zlim3d([-r + zroot, r + zroot])
        return lines

    anim = animation.FuncAnimation(fig, update, n_frames,
                                   interval=1000 / fps, blit=False)
    return fig, anim


def predict_windows(checkpoint: str, data_dir: str, action: str,
                    visualize_from: str = "test", n_viz: int = 2,
                    args_override=None, overrides=None, device="cuda"):
    """Load an H36M xyz checkpoint (``.pt`` or JAX ``.ckpt``) and return
    full-skeleton (gt, pred) sequences, each (n_viz, T_out, 32, 3) numpy,
    for ``n_viz`` windows of ``action`` — equal-joint re-insertion included
    (test_mpjpe parity, train_mixer_h36m.py:368-378). The forward runs on
    ``device``, through the trainer's window preparation (delta encoding
    and ``delta_2_gt`` decoding for a velocity-mode checkpoint).
    """
    from ..cli._runner import h36m_visualization_arrays
    from ..data.constants import H36M_DIM_USED_XYZ
    from ..data.h36m import H36MDataset
    from ..serving import resolve_device
    from ..train.loop import Trainer
    from ._meta import load_h36m_xyz_model, resolve_h36m_eval_args

    dev = resolve_device(device)
    if args_override is not None:
        args = args_override
        model = load_h36m_xyz_model(checkpoint, args)
    else:
        # the checkpoint's stored training args beat CLI defaults;
        # explicit viewer flags (``overrides``) beat both.
        args, model = resolve_h36m_eval_args(
            checkpoint, data_dir, os.path.dirname(checkpoint) or ".",
            overrides=overrides)
    split = {"train": 0, "validation": 1, "test": 2}[visualize_from]
    ds = H36MDataset(data_dir, args.input_n, args.output_n, args.skip_rate,
                     actions=[action], split=split, mode="xyz")
    trainer = Trainer(model.to(dev), None, loss_type="mpjpe",
                      dim_used=H36M_DIM_USED_XYZ, input_n=args.input_n,
                      output_n=args.output_n, input_scale=1e-3,
                      delta_x=getattr(args, "delta_x", False))
    full_pred, full_gt, _ = h36m_visualization_arrays(trainer, ds, n_viz,
                                                      first=0)
    n = full_gt.shape[0]
    return full_gt.reshape(n, -1, 32, 3), full_pred.reshape(n, -1, 32, 3)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--action", default="walking")
    ap.add_argument("--visualize_from", default="test",
                    choices=["train", "validation", "test"])
    ap.add_argument("--n_viz", type=int, default=2)
    ap.add_argument("--fps", type=int, default=10)
    ap.add_argument("--save", help="directory for GIFs (headless mode)")
    ap.add_argument("--show", action="store_true",
                    help="open the interactive window (needs a display)")
    ap.add_argument("--num_blocks", type=int)
    ap.add_argument("--hidden_dim", type=int)
    ap.add_argument("--skip_rate", type=int)
    ap.add_argument("--dev", default="cuda",
                    help="torch device of the predictions; 'cuda' (default) "
                         "raises when there is no card")
    args = ap.parse_args(argv)

    # model architecture resolves from the checkpoint's stored training args;
    # these flags override it (and cover pre-meta checkpoints).
    ov = {k: getattr(args, k) for k in ("num_blocks", "hidden_dim", "skip_rate")
          if getattr(args, k) is not None}
    gts, preds = predict_windows(
        args.checkpoint, args.data_dir, args.action, args.visualize_from,
        args.n_viz, overrides=ov, device=args.dev)

    import matplotlib

    if args.save and not args.show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for i, (gt, pred) in enumerate(zip(gts, preds)):
        fig, anim = pose_animation(gt, pred, fps=args.fps,
                                   title=f"{args.action} #{i}")
        if args.save:
            os.makedirs(args.save, exist_ok=True)
            path = os.path.join(args.save, f"live_{args.action}_{i}.gif")
            anim.save(path, writer="pillow", fps=args.fps)
            print(f"wrote {path}")
        if args.show:
            plt.show()
        plt.close(fig)


if __name__ == "__main__":
    main()

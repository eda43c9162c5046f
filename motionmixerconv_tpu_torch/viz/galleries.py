"""Result galleries: the reference's ``visualization.ipynb`` as a tool.

Counterpart of ``motionmixerconv_tpu/viz/galleries.py``. The reference
ships its qualitative GIF galleries and quantitative result tables as
notebook *artifacts* (conv_mixer/visualization.ipynb, 70 cells: dataset
docs, per-action tables, GIF galleries; optuna_visualization.ipynb: study
dataframes). This module reproduces both as a single tool:

    python -m motionmixerconv_tpu_torch.viz.galleries \
        --checkpoint runs/h36m/train_state.pt --data_dir <h36m root> \
        --out galleries/

writes, into ``--out``:
- ``tables.md`` — per-action MPJPE / AUC-PCK tables in the notebook's layout
  (cells 51-66 of visualization.ipynb; baseline numbers in BASELINE.md),
  evaluated on ``--dev`` (default ``cuda``; ``--dev cpu`` on the CPU),
- ``visualization/<action>_<i>.gif`` — input (blue) -> prediction (yellow)
  vs gt (blue) skeleton animations per action (visualize_batch format,
  conv_mixer/utils/visualization_helpers_h3m.py:70-197), for the first
  ``--max_gifs`` actions; rendering needs matplotlib and Pillow, and
  ``--max_gifs 0`` needs neither,
- optionally ``study.md`` — kernel-grid + best-trials tables from a sweep
  directory (--study_dir, read on the host with pandas), the
  optuna_visualization.ipynb content.

``--checkpoint`` is a ``.pt`` (a trainer's ``train_state.pt``) or a JAX
``.ckpt``; its stored training args rebuild the model.
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def h36m_galleries(checkpoint: str, data_dir: str, out_dir: str,
                   args_override=None, actions=None, max_gifs: int = 3,
                   device="cuda"):
    """Per-action tables + GIF galleries for a trained H36M checkpoint,
    evaluated on ``device``. Returns [(action, mpjpe, auc_pck)]."""
    from ..cli._runner import export_h36m_visualizations
    from ..data.constants import H36M_DIM_USED_XYZ, define_actions
    from ..data.h36m import H36MDataset
    from ..serving import resolve_device
    from ..train.loop import Trainer
    from ._meta import load_h36m_xyz_model, resolve_h36m_eval_args

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    if args_override is not None:
        args = args_override
        model = load_h36m_xyz_model(checkpoint, args)
    else:
        # rebuild the EXACT trained architecture from the checkpoint's stored
        # training args instead of CLI defaults — a non-default
        # --output_n/--hidden_dim/... checkpoint renders correctly without
        # the caller re-specifying its flags.
        args, model = resolve_h36m_eval_args(checkpoint, data_dir, out_dir)
    trainer = Trainer(
        model.to(dev), None, loss_type="mpjpe", dim_used=H36M_DIM_USED_XYZ,
        input_n=args.input_n, output_n=args.output_n, input_scale=1e-3,
        delta_x=getattr(args, "delta_x", False),
    )

    acts = list(actions) if actions else define_actions("all")
    rows = []
    for i, action in enumerate(acts):
        ds = H36MDataset(data_dir, args.input_n, args.output_n,
                         args.skip_rate, actions=[action], split=2, mode="xyz")
        mpjpe, auc = trainer.evaluate(ds, ds.frames_on(dev), batch_size=256,
                                      kind="h36m_xyz")
        rows.append((action, mpjpe, auc))
        if i < max_gifs:
            export_h36m_visualizations(trainer, ds, out_dir, action)
        print(f"{action}: mpjpe {mpjpe:.2f} mm, auc_pck {auc:.3f}")

    lines = [
        "# H36M result tables (visualization.ipynb cells 51-66 layout)",
        "",
        "| action | MPJPE (mm) | AUC-PCK |",
        "|---|---|---|",
    ]
    for action, mpjpe, auc in rows:
        lines.append(f"| {action} | {mpjpe:.2f} | {auc:.3f} |")
    m = np.mean([r[1] for r in rows])
    a = np.mean([r[2] for r in rows])
    lines.append(f"| **average** | **{m:.2f}** | **{a:.3f}** |")
    with open(os.path.join(out_dir, "tables.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    where = f" and GIFs under {out_dir}/visualization" if max_gifs else ""
    print(f"wrote {out_dir}/tables.md{where}")
    return rows


def study_tables(study_dir: str, out_dir: str):
    """Kernel-grid + best-trials + per-action tables from a sweep directory
    (the optuna_visualization.ipynb dataframes)."""
    from ..sweep.analysis import (best_trials_table, kernel_grid_table,
                                  load_study_dataframe, per_action_table)

    os.makedirs(out_dir, exist_ok=True)
    df = load_study_dataframe(study_dir)
    lines = ["# Study analysis (optuna_visualization.ipynb layout)", ""]
    for title, table in (
        ("Kernel grid (mean objective)", kernel_grid_table(df)),
        ("Best trials", best_trials_table(df)),
        ("Per-action metrics (best trial)", per_action_table(df)),
    ):
        lines += [f"## {title}", "", str(table), ""]
    path = os.path.join(out_dir, "study.md")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {path}")
    return path


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--checkpoint",
                    help="trained H36M checkpoint (.pt or JAX .ckpt)")
    ap.add_argument("--data_dir", help="H36M corpus root")
    ap.add_argument("--study_dir", help="sweep study directory (optional)")
    ap.add_argument("--out", required=True)
    ap.add_argument("--actions", nargs="*", default=None)
    ap.add_argument("--max_gifs", type=int, default=3)
    ap.add_argument("--dev", default="cuda",
                    help="torch device of the evaluation; 'cuda' (default) "
                         "raises when there is no card")
    args = ap.parse_args(argv)
    if bool(args.checkpoint) != bool(args.data_dir):
        ap.error("--checkpoint and --data_dir must be given together")
    if not args.checkpoint and not args.study_dir:
        ap.error("nothing to do: pass --checkpoint + --data_dir for "
                 "galleries and/or --study_dir for study tables")
    return args


def main(argv=None):
    args = parse_args(argv)
    rows = None
    if args.checkpoint and args.data_dir:
        rows = h36m_galleries(args.checkpoint, args.data_dir, args.out,
                              actions=args.actions, max_gifs=args.max_gifs,
                              device=args.dev)
    if args.study_dir:
        study_tables(args.study_dir, args.out)
    return rows


if __name__ == "__main__":
    main()

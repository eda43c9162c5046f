"""Study-results analysis: dataframes and result tables from sqlite studies.

Counterpart of ``motionmixerconv_tpu/sweep/analysis.py``, unchanged: a
CPU-side tool that needs ``pandas`` (imported when a table is made; the
card's machine has none), reading either package's ``results.db``.

Replaces the reference's analysis notebook (conv_mixer/optuna_visualization.ipynb):
loads studies into pandas, builds the kernel-grid result tables
(kernel1_x_Time x kernel1_y_Pose -> metric) and exports markdown/LaTeX.

Run: python -m motionmixerconv_tpu_torch.sweep.analysis --study_dir ./studies/s1
"""

from __future__ import annotations

import argparse
import os

from .engine import Study


def load_study_dataframe(study_dir: str):
    """All trials of the study at ``study_dir`` as a pandas DataFrame."""
    study = Study(
        study_name=os.path.basename(study_dir),
        storage=f"sqlite:///{study_dir}/results.db",
    )
    return study.trials_dataframe()


def kernel_grid_table(df, value_col: str = "values_0"):
    """Pivot the kernel search grid into a (k1x x k1y) result table."""
    need = {"params_kernel1_x_Time", "params_kernel1_y_Pose", value_col}
    if not need.issubset(df.columns):
        raise ValueError(f"study has no kernel grid columns ({need - set(df.columns)})")
    ok = df[df["state"] == "COMPLETE"]
    return ok.pivot_table(
        index="params_kernel1_x_Time",
        columns="params_kernel1_y_Pose",
        values=value_col,
        aggfunc="min",
    )


def best_trials_table(df, value_col: str = "values_0", top: int = 10):
    ok = df[df["state"] == "COMPLETE"].sort_values(value_col)
    return ok.head(top)


def per_action_table(df, metric: str = "mpjpe", trial_number=None):
    """Per-action metric row for one trial (default: best), like the
    published tables in conv_mixer/visualization.ipynb."""
    ok = df[df["state"] == "COMPLETE"]
    row = (
        ok[ok["number"] == trial_number].iloc[0]
        if trial_number is not None
        else ok.sort_values("values_0").iloc[0]
    )
    cols = [c for c in df.columns if c.endswith(f"/{metric}")]
    return {
        c.replace("user_attrs_", "").replace(f"/{metric}", ""): row[c] for c in cols
    }


def learning_curves(study_dir: str):
    """Per-trial learning curves (epoch x trial -> reported value) from the
    intermediate values the studies report each epoch. NaN where a
    trial never reached that epoch (pruned / shorter run)."""
    import pandas as pd

    study = Study(
        study_name=os.path.basename(study_dir),
        storage=f"sqlite:///{study_dir}/results.db",
    )
    series = {
        t.number: pd.Series(t.intermediate_values)
        for t in study.trials if t.intermediate_values
    }
    if not series:
        raise ValueError("study has no reported intermediate values")
    df = pd.DataFrame(series).sort_index()
    df.index.name = "step"
    return df


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--study_dir", type=str, required=True)
    parser.add_argument("--value_col", type=str, default="values_0")
    parser.add_argument("--format", choices=["markdown", "latex"], default="markdown")
    parser.add_argument("--curves", action="store_true",
                        help="also print the per-trial learning curves")
    args = parser.parse_args(argv)

    df = load_study_dataframe(args.study_dir)
    print(f"{len(df)} trials ({(df['state'] == 'COMPLETE').sum()} complete)\n")
    try:
        grid = kernel_grid_table(df, args.value_col)
        out = grid.to_markdown() if args.format == "markdown" else grid.to_latex()
        print("## kernel grid\n", out, "\n")
    except ValueError:
        pass
    best = best_trials_table(df, args.value_col)
    out = best.to_markdown() if args.format == "markdown" else best.to_latex()
    print("## best trials\n", out)
    if args.curves:
        try:
            curves = learning_curves(args.study_dir)
            out = (curves.to_markdown() if args.format == "markdown"
                   else curves.to_latex())
            print("\n## learning curves\n", out)
        except ValueError as e:
            print(f"\n## learning curves\n ({e})")
    return df


if __name__ == "__main__":
    main()

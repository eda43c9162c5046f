"""Full-schedule convergence parity with the recorded reference runs.

The port's counterpart of the JAX side of ``tools/parity_runs.py``. The
repo holds the torch reference's own full runs on synthetic corpora
(``tests/golden/parity_runs.json``), each run's initial weights in the
reference ``state_dict`` layout (``parity_init.npz``) and the final
parameters of the lockstep drift pair (``parity_drift.npz``). Each run here
starts from the recorded init, trains through the port's CLI runners with
the argv the JAX side used, and ``compare`` holds it to the recorded torch
run at the tolerances of ``tests/test_parity_runs.py``:

- ``h36m``: the flagship ConvMixer, matched init, own shuffle and dropout,
  20 epochs, milestone 15;
- ``h36m_sync``: the lockstep run, dropout off and the recorded batch order
  (``_sync_order``); again from the ``h36m_sync_drift`` init (the final
  parameters' distance to the reference's) and at lr/10 from the
  ``h36m_sync_lowlr`` init, whose distance must be smaller;
- ``amass``: the AMASS MlpMixer, 30 epochs, milestone 22;
- ``h36m_autoreg``: the autoregressive ConvMixer at ``AR_CFG`` (its
  flagship widths) and at ``AR_SMALL_CFG``.

Usage (on the card; ``--dev cpu`` runs on the CPU, slowly)::

    python -m motionmixerconv_tpu_torch.parity_runs --golden tests/golden \\
        --work DIR [--runs h36m h36m_fused h36m_sync ...]

The ``*_fused`` runs train with ``--fused_encoder`` (B1 in every step). It
prints one line a run and exits non-zero if any run misses a tolerance.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

# ---- the run configurations (tools/parity_runs.py:50-114, the same values)

H36M_CFG = dict(
    n_frames=400, data_seed=11, n_epochs=20, batch_size=50, batch_size_test=256,
    lr=1e-3, milestones=[15], gamma=0.1, input_n=10, output_n=25, skip_rate=5,
    actions="walking", torch_seed=100,
    # the flagship ConvMixer at the reference mpjpe CLI defaults
    # (train_mixer_h36m.py:575-595)
    num_blocks=4, dimPosEmb=50, k1=(1, 3), activation="mish",
    regularization=0.1, r_se=8, nharm=64, omega0=0.1,
)
AMASS_CFG = dict(
    n_frames=2000, data_seed=13, n_epochs=30, batch_size=50, batch_size_test=256,
    lr=1e-3, milestones=[22], gamma=0.1, input_n=10, output_n=25, skip_rate=5,
    torch_seed=101,
    # the MlpMixer at the reference AMASS CLI defaults
    # (train_mixer_amass.py:235-246)
    num_blocks=5, hidden_dim=128, tokens_mlp_dim=20, channels_mlp_dim=128,
    activation="gelu", regularization=0.1, r_se=8,
)
AR_CFG = dict(
    n_epochs=12, n_epochs_teacher_forcing=6, milestones=[9], gamma=0.1,
    batch_size=50, batch_size_test=256, lr=1e-3, skip_rate=5,
    input_n_dataset=10, output_n_dataset=25, input_n_model=10,
    output_n_model=5, step_window=5, torch_seed=102,
    # the autoregressive ConvMixer at the reference autoreg CLI defaults
    # (train_autoreg_mixer_h36m.py:486-548): hidden 192, 8 conv channels,
    # (5,5) kernels, BatchNorm (regularization -1), no harmonic encoding
    num_blocks=4, hidden_dim=192, conv_nChan=8, k1=(5, 5),
    activation="mish", regularization=-1.0, r_se=8,
)
AR_SMALL_CFG = dict(
    # AR_CFG's trainer semantics (teacher-forcing schedule, closed loop,
    # BatchNorm, (5,5) 2-channel convs) at ~1/60 of its operations
    n_epochs=10, n_epochs_teacher_forcing=5, milestones=[8], gamma=0.1,
    batch_size=50, batch_size_test=256, lr=1e-3, skip_rate=5,
    input_n_dataset=10, output_n_dataset=25, input_n_model=10,
    output_n_model=5, step_window=5, torch_seed=103,
    num_blocks=2, hidden_dim=48, conv_nChan=2, k1=(5, 5),
    activation="mish", regularization=-1.0, r_se=8,
)
H36M_SYNC_CFG = dict(
    H36M_CFG,
    # the lockstep variant: dropout off and the same per-epoch batch-order
    # stream on both sides, so only numerics separate the runs
    regularization=0.0, torch_seed=104, order_seed=977,
)
H36M_SYNC_LOWLR_CFG = dict(
    # the drift control: the lockstep protocol at lr/10; accumulated f32
    # round-off amplified by the step size shrinks with it
    H36M_SYNC_CFG, lr=1e-4, torch_seed=105,
)

INIT_KINDS = ("h36m", "h36m_sync", "h36m_sync_drift", "h36m_sync_lowlr",
              "amass", "ar", "ar_small")


def _sync_order(n: int, epoch: int) -> np.ndarray:
    """The shared epoch -> window-permutation stream of the lockstep runs."""
    return np.random.RandomState(
        H36M_SYNC_CFG["order_seed"] + epoch).permutation(n)


# ---------------------------------------------------------------- inputs


def load_recorded(golden: str) -> dict:
    """``parity_runs.json``: the corpora's configurations and the recorded
    runs."""
    with open(os.path.join(golden, "parity_runs.json")) as f:
        return json.load(f)


def load_init(golden: str, kind: str) -> dict:
    """The recorded init ``kind`` (one of ``INIT_KINDS``) of
    ``parity_init.npz`` as a reference-layout state_dict."""
    if kind not in INIT_KINDS:
        raise ValueError(f"unknown init {kind!r}; one of {INIT_KINDS}")
    return _npz_state_dict(os.path.join(golden, "parity_init.npz"), kind)


def _npz_state_dict(path: str, kind: str) -> dict:
    data = np.load(path)
    prefix = kind + "::"
    sd = {k[len(prefix):]: torch.from_numpy(np.array(data[k]))
          for k in data.files if k.startswith(prefix)}
    if not sd:
        raise KeyError(f"{path} holds no {kind!r} entries")
    return sd


def make_corpora(work: str, recorded: dict) -> tuple:
    """The synthetic H36M and AMASS corpora of the recorded runs (their
    ``h36m_cfg`` and ``amass_cfg`` frames and seeds) under ``work``,
    written once; returns (h36m_dir, amass_dir)."""
    from .data import fixtures

    h36m_dir = os.path.join(work, "h36m")
    amass_dir = os.path.join(work, "amass2k")
    c, a = recorded["h36m_cfg"], recorded["amass_cfg"]
    if not os.path.isdir(h36m_dir):
        fixtures.make_h36m_corpus(h36m_dir, n_frames=c["n_frames"],
                                  seed=c["data_seed"])
    if not os.path.isdir(amass_dir):
        fixtures.make_amass_corpus(amass_dir, n_frames=a["n_frames"],
                                   seed=a["data_seed"])
    return h36m_dir, amass_dir


# ------------------------------------------------------------------ runs


def _common_argv(c: dict, data_dir: str, save: str, dev: str) -> list:
    return ["--data_dir", data_dir, "--save_path", save,
            "--batch_size", str(c["batch_size"]),
            "--batch_size_test", str(c["batch_size_test"]),
            "--skip_rate", str(c["skip_rate"]), "--lr", str(c["lr"]),
            "--milestones", *[str(m) for m in c["milestones"]],
            "--gamma", str(c["gamma"]), "--num_blocks", str(c["num_blocks"]),
            "--dev", dev]


def _h36m_argv(c: dict, data_dir: str, save: str, dev: str, fused: bool,
               n_epochs: Optional[int]) -> list:
    """``jax_h36m``'s argv (tools/parity_runs.py:538-548) on the port's
    CLI, with ``--dev`` and, for the fused runs, ``--fused_encoder``."""
    return [*_common_argv(c, data_dir, save, dev),
            "--loss_type", "mpjpe",
            "--n_epochs", str(n_epochs or c["n_epochs"]),
            "--input_n", str(c["input_n"]), "--output_n", str(c["output_n"]),
            "--hidden_dim", str(c["dimPosEmb"]),
            "--activation", c["activation"],
            "--regularization", str(c["regularization"]),
            "--r_se", str(c["r_se"]), "--actions_to_consider", c["actions"],
            *(["--fused_encoder"] if fused else [])]


def _result(history: dict, t0: float, checkpoint: str,
            with_test: bool = True) -> dict:
    """The run's record, with the keys of the recorded runs."""
    out = {
        "train_per_epoch": [float(x) for x in history["train"]],
        "val_per_epoch": [float(x) for x in history["val"]],
        "train": float(history["train"][-1]),
        "val": float(history["val"][-1]),
        "test_mpjpe": float(history["test"][-1]),
    }
    if with_test:
        out["test_per_epoch"] = [float(x) for x in history["metrics"]["mpjpe"]]
        out["test_mpjpe"] = float(history["metrics"]["mpjpe"][-1])
        out["test_auc_pck"] = float(history["metrics"]["auc_pck"][-1])
    out["wall_s"] = time.perf_counter() - t0
    out["checkpoint"] = checkpoint
    return out


def h36m(data_dir: str, work: str, init_state_dict: dict, *,
         dev: str = "cuda", fused: bool = False, tag: str = "h36m",
         n_epochs: Optional[int] = None) -> dict:
    """``jax_h36m`` (tools/parity_runs.py:528): the flagship ConvMixer from
    the recorded init, 20 epochs, milestone 15, its own shuffle and
    dropout; ``fused`` trains with ``--fused_encoder`` (B1 in every
    step)."""
    from .cli._runner import STATE_FILE, run_h36m
    from .cli.train_mixer_h36m import parse_args

    save = os.path.join(work, f"port_{tag}")
    args = parse_args(_h36m_argv(H36M_CFG, data_dir, save, dev, fused,
                                 n_epochs))
    t0 = time.perf_counter()
    history, _ = run_h36m(args, init_state_dict=init_state_dict)
    return _result(history, t0, os.path.join(
        save, f"h36_3d_{args.output_n}frames_ckpt", STATE_FILE))


def h36m_sync(data_dir: str, work: str, init_state_dict: dict, *,
              c: Optional[dict] = None, dev: str = "cuda",
              fused: bool = False, tag: str = "h36m_sync",
              n_epochs: Optional[int] = None) -> dict:
    """``jax_h36m_sync`` (tools/parity_runs.py:564): dropout off, the
    recorded per-epoch batch order (``_sync_order``) through
    ``run_h36m(batch_order_fn=)``. On a card cuDNN runs deterministically
    for the run, so that a failure reproduces."""
    from .cli._runner import STATE_FILE, run_h36m
    from .cli.train_mixer_h36m import parse_args
    from .data import H36MDataset

    c = c or H36M_SYNC_CFG
    n_train = len(H36MDataset(data_dir, c["input_n"], c["output_n"],
                              c["skip_rate"], split=0, mode="xyz"))
    save = os.path.join(work, f"port_{tag}")
    args = parse_args(_h36m_argv(c, data_dir, save, dev, fused, n_epochs))
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    try:
        history, _ = run_h36m(args, init_state_dict=init_state_dict,
                              batch_order_fn=lambda ep: _sync_order(n_train,
                                                                    ep))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return _result(history, t0, os.path.join(
        save, f"h36_3d_{args.output_n}frames_ckpt", STATE_FILE))


def amass(data_dir: str, work: str, init_state_dict: dict, *,
          dev: str = "cuda", tag: str = "amass",
          n_epochs: Optional[int] = None) -> dict:
    """``jax_amass`` (tools/parity_runs.py:652): the AMASS MlpMixer from the
    recorded init, 30 epochs, milestone 22."""
    from .cli._runner import STATE_FILE, run_amass
    from .cli.train_mixer_amass import parse_args

    c = AMASS_CFG
    save = os.path.join(work, f"port_{tag}")
    argv = [*_common_argv(c, data_dir, save, dev),
            "--n_epochs", str(n_epochs or c["n_epochs"]),
            "--input_n", str(c["input_n"]), "--output_n", str(c["output_n"]),
            "--hidden_dim", str(c["hidden_dim"]),
            "--tokens_mlp_dim", str(c["tokens_mlp_dim"]),
            "--channels_mlp_dim", str(c["channels_mlp_dim"]),
            "--activation", c["activation"],
            "--regularization", str(c["regularization"]),
            "--r_se", str(c["r_se"]),
            "--model_path", os.path.join(work, f"port_{tag}_ckpt")]
    args = parse_args(argv)
    t0 = time.perf_counter()
    history, _ = run_amass(args, init_state_dict=init_state_dict)
    return _result(history, t0, os.path.join(
        save, f"amass_3d_{args.output_n}frames_ckpt", STATE_FILE),
        with_test=False)


def h36m_autoreg(data_dir: str, work: str, init_state_dict: dict, *,
                 c: Optional[dict] = None, dev: str = "cuda",
                 tag: str = "ar", n_epochs: Optional[int] = None) -> dict:
    """``jax_h36m_autoreg`` (tools/parity_runs.py:688): the autoregressive
    ConvMixer at ``c`` (``AR_CFG`` by default, or ``AR_SMALL_CFG``) from
    the recorded init, teacher forcing, then the closed loop."""
    from .cli._runner import STATE_FILE, run_h36m_autoregressive
    from .cli.train_autoreg_mixer_h36m import parse_args

    c = c or AR_CFG
    save = os.path.join(work, f"port_{tag}")
    argv = [*_common_argv(c, data_dir, save, dev),
            "--n_epochs", str(n_epochs or c["n_epochs"]),
            "--n_epochs_teacher_forcing", str(c["n_epochs_teacher_forcing"]),
            "--hidden_dim", str(c["hidden_dim"]),
            "--conv_nChan", str(c["conv_nChan"])]
    args = parse_args(argv)
    args.conv1_kernel_shape = (args.kernel1_x, args.kernel1_y)
    t0 = time.perf_counter()
    history, _ = run_h36m_autoregressive(args, init_state_dict=init_state_dict)
    return _result(history, t0, os.path.join(
        save, f"h36_ar_{args.output_n_dataset}frames_ckpt", STATE_FILE))


# run name -> (function, its keyword arguments, recorded torch run, init)
RUNS = {
    "h36m": (h36m, {}, "torch_h36m", "h36m"),
    "h36m_fused": (h36m, {"fused": True}, "torch_h36m", "h36m"),
    "h36m_sync": (h36m_sync, {}, "torch_h36m_sync", "h36m_sync"),
    "h36m_sync_fused": (h36m_sync, {"fused": True}, "torch_h36m_sync",
                        "h36m_sync"),
    "h36m_sync_drift": (h36m_sync, {}, "torch_h36m_sync_drift",
                        "h36m_sync_drift"),
    "h36m_sync_lowlr": (h36m_sync, {"c": H36M_SYNC_LOWLR_CFG},
                        "torch_h36m_sync_lowlr", "h36m_sync_lowlr"),
    "amass": (amass, {}, "torch_amass", "amass"),
    "ar": (h36m_autoreg, {"c": AR_CFG}, "torch_ar", "ar"),
    "ar_small": (h36m_autoreg, {"c": AR_SMALL_CFG}, "torch_ar_small",
                 "ar_small"),
}
DRIFT_RUNS = ("h36m_sync_drift", "h36m_sync_lowlr")


def run(name: str, golden: str, h36m_dir: str, amass_dir: str, work: str,
        dev: str = "cuda", n_epochs: Optional[int] = None) -> dict:
    """Run ``name`` (a key of ``RUNS``) from its recorded init."""
    fn, kw, _, init = RUNS[name]
    data_dir = amass_dir if fn is amass else h36m_dir
    return fn(data_dir, work, load_init(golden, init), dev=dev, tag=name,
              n_epochs=n_epochs, **kw)


# ----------------------------------------------------------------- checks


def param_drift(checkpoint: str, golden: str, kind: str) -> float:
    """The relative L2 distance of a run's final parameters (its
    ``train_state.pt``) to the reference's final parameters of ``kind``
    in ``parity_drift.npz``, over the model's parameters (buffers out), as
    ``test_h36m_lockstep_drift_endpoint_reproduces`` takes it."""
    from .cli._runner import model_from_checkpoint_meta
    from .models.torch_io import read_weights

    ours, meta = read_weights(checkpoint)
    ref = _npz_state_dict(os.path.join(golden, "parity_drift.npz"), kind)
    names = [n for n, _ in model_from_checkpoint_meta(meta).named_parameters()]
    a = torch.cat([ours[n].double().flatten() for n in names])
    b = torch.cat([ref[n].double().flatten() for n in names])
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def _curve_rel(ours, ref) -> float:
    """The largest per-epoch |ours - ref| / |ref| (``assert_allclose``'s
    rtol test passes when it is within the rtol)."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    if ours.shape != ref.shape:
        return float("inf")
    return float(np.max(np.abs(ours - ref) / np.abs(ref)))


# tolerances of tests/test_parity_runs.py: endpoint relative gaps, the
# AUC-PCK's absolute gap, the train trajectory's rtol, and the lockstep's
# first-5-test-epochs rtol
MATCHED = dict(train=0.15, val=0.12, test_mpjpe=0.15, auc=0.05, traj=0.2)
LOCKSTEP = dict(train=0.02, val=0.02, test_mpjpe=0.06, auc=0.03, traj=0.025,
                test5=0.01)
TOLS = {
    "torch_h36m": MATCHED,
    "torch_h36m_sync": LOCKSTEP,
    "torch_amass": dict(train=0.05, val=0.05, test_mpjpe=0.05, traj=0.1),
    "torch_ar": dict(train=0.05, val=0.05, test_mpjpe=0.05, auc=0.02,
                     traj=0.06),
    "torch_ar_small": dict(train=0.05, val=0.05, test_mpjpe=0.05, auc=0.05,
                           traj=0.05, falls=3.0),
}


def _check_run(ours: dict, ref: dict, tol: dict) -> tuple:
    """(rows, failures) of one run against its recorded reference: each
    row (what, ours, reference, gap, tolerance)."""
    rows, bad = [], []

    def hold(what, a, b, gap, limit, ok):
        rows.append((what, a, b, gap, limit))
        if not ok:
            bad.append(f"{what}: ours {a}, reference {b}, gap {gap:.4g} "
                       f"(tol {limit:g})")

    for key in ("train", "val", "test_mpjpe"):
        gap = _rel(ours[key], ref[key])
        hold(key, ours[key], ref[key], gap, tol[key], gap < tol[key])
    if "auc" in tol:
        gap = abs(ours["test_auc_pck"] - ref["test_auc_pck"])
        hold("test_auc_pck", ours["test_auc_pck"], ref["test_auc_pck"], gap,
             tol["auc"], gap < tol["auc"])
    # assert_allclose's rtol test: |ours - ref| <= rtol * |ref|
    gap = _curve_rel(ours["train_per_epoch"], ref["train_per_epoch"])
    hold("train_per_epoch", None, None, gap, tol["traj"], gap <= tol["traj"])
    if "test5" in tol:
        gap = _curve_rel(ours["test_per_epoch"][:5], ref["test_per_epoch"][:5])
        hold("test_per_epoch[:5]", None, None, gap, tol["test5"],
             gap <= tol["test5"])
    if "falls" in tol:
        # both curves descend the plateau: the last epoch more than
        # ``falls`` below the first
        for who, curve in (("ours", ours["train_per_epoch"]),
                           ("reference", ref["train_per_epoch"])):
            drop = curve[0] - curve[-1]
            hold(f"{who} train curve drop", curve[0], curve[-1], drop,
                 tol["falls"], drop > tol["falls"])
    return rows, bad


def compare(results: dict, recorded: dict, golden: Optional[str] = None
            ) -> dict:
    """Hold each run of ``results`` (run name -> the dict a run returns) to
    its recorded torch run at the tolerances of
    ``tests/test_parity_runs.py``; with ``golden``, also the drift
    endpoints of ``DRIFT_RUNS`` (each finite and below 1.0, the lr/10
    endpoint below 0.7 x the full-lr one, the lr/10 run's last test gap
    below the full-lr run's). Returns {"rows": {run: rows}, "drift": {...},
    "failures": [...]}; empty failures mean every check passed."""
    rec = recorded["results"]
    out = {"rows": {}, "drift": {}, "failures": []}
    for name, ours in results.items():
        ref_key = RUNS[name][2]
        if ref_key not in TOLS:
            continue
        rows, bad = _check_run(ours, rec[ref_key], TOLS[ref_key])
        out["rows"][name] = rows
        out["failures"] += [f"{name}: {b}" for b in bad]
    if golden is not None and all(k in results for k in DRIFT_RUNS):
        drift = {k: param_drift(results[k]["checkpoint"], golden, k)
                 for k in DRIFT_RUNS}
        gaps = {k: _rel(results[k]["test_per_epoch"][-1],
                        rec[RUNS[k][2]]["test_per_epoch"][-1])
                for k in DRIFT_RUNS}
        full, low = DRIFT_RUNS
        out["drift"] = {"param_drift_rel": drift, "last_test_gap": gaps,
                        "jax_recorded": {
                            k: rec[f"jax_{k}"]["param_drift_rel"][-1]
                            for k in DRIFT_RUNS if f"jax_{k}" in rec}}
        for k, d in drift.items():
            if not (np.isfinite(d) and d < 1.0):
                out["failures"].append(f"{k}: drift endpoint {d} not finite "
                                       "and below 1.0")
        if not drift[low] < 0.7 * drift[full]:
            out["failures"].append(
                f"lr/10 drift endpoint {drift[low]:.4g} not below 0.7 x the "
                f"full-lr one {drift[full]:.4g}")
        if not gaps[low] < gaps[full]:
            out["failures"].append(
                f"lr/10 last test gap {gaps[low]:.4g} not below the full-lr "
                f"one {gaps[full]:.4g}")
    return out


def report(name: str, ours: dict, recorded: dict) -> str:
    """One line: each endpoint, ours beside the recorded torch and JAX
    runs', with the relative gaps, and the run's wall seconds."""
    rec = recorded["results"]
    ref_key = RUNS[name][2]
    torch_run = rec[ref_key]
    jax_run = rec.get(ref_key.replace("torch_", "jax_"), {})
    parts = []
    for key in ("train", "val", "test_mpjpe", "test_auc_pck"):
        if key not in ours or key not in torch_run:
            continue
        j = jax_run.get(key)
        parts.append(
            f"{key} {ours[key]:.6g} (torch {torch_run[key]:.6g}, gap "
            f"{_rel(ours[key], torch_run[key]):.3e}; JAX "
            + ("not recorded" if j is None else
               f"{j:.6g}, gap {_rel(j, torch_run[key]):.3e}") + ")")
    return (f"{name}: " + "; ".join(parts) + f"; wall_s {ours['wall_s']:.2f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--golden", default="tests/golden")
    ap.add_argument("--work", required=True)
    ap.add_argument("--runs", nargs="*", default=list(RUNS),
                    choices=list(RUNS))
    ap.add_argument("--dev", default="cuda")
    args = ap.parse_args(argv)
    from .serving import resolve_device

    resolve_device(args.dev)  # TF32 off on a card; raises without one
    recorded = load_recorded(args.golden)
    os.makedirs(args.work, exist_ok=True)
    h36m_dir, amass_dir = make_corpora(args.work, recorded)
    results = {}
    for name in args.runs:
        results[name] = run(name, args.golden, h36m_dir, amass_dir,
                            args.work, args.dev)
        print(report(name, results[name], recorded), flush=True)
    verdict = compare(results, recorded, args.golden)
    if verdict["drift"]:
        print(f"drift: {verdict['drift']}")
    for line in verdict["failures"]:
        print(f"FAIL {line}")
    print("parity: " + ("ok" if not verdict["failures"] else
                        f"{len(verdict['failures'])} checks failed"))
    return 1 if verdict["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())

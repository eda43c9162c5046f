#!/usr/bin/env python3
"""Time the harmonic encoder kernels (B1-fwd and B1-bwd) of this checkout
against those of another checkout of the repository, in turns on one card.

    python3 chip_ab.py --other path/to/other/checkout [--reps 20]

Both trees' ``motionmixerconv_tpu_torch`` are imported side by side (the
other one under the package name ``mmc_other``); each builds its kernels
from its own ``csrc/`` into its own ``build/``. For every case, at the
flagship encoder's shape (D = 66, n = 64, E = 50, random weights from a
seed), the script checks this tree's kernel against the plain version
(``chip_smoke.py``'s tolerances) and against the other tree's kernel, then
times by CUDA events other, this, this, other on the same inputs, and the
plain version once. With ``--step-seeds``, it also replays ``chip_smoke.py``
phase 8 (one flagship training step, fused encoder against plain) for each
seed with both trees' fused encoders and prints each one's worst gradient
difference. It prints the card's name and power limit and one JSON line
with every result; it exits non-zero if a check fails or there is no card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the tolerances, timers and card line)

D, N, E = 66, 64, 50
FWD_CASES = [("direct", 500), ("direct", 1280), ("direct", 2560),
             ("doubling", 500), ("doubling", 2560)]
BWD_CASES = [("direct", 500, False), ("direct", 2560, False),
             ("direct", 500, True), ("direct", 2560, True),
             ("doubling", 500, False)]


def load_other(path: Path):
    """The other checkout's port package, imported as ``mmc_other``."""
    pkg_dir = path.resolve() / "motionmixerconv_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "mmc_other", pkg_dir / "__init__.py",
        submodule_search_locations=[str(pkg_dir)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["mmc_other"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("mmc_other.ops.harmonic")


def step_grads(torch, model, seq):
    """The gradients of one phase-8 training step of ``model`` on ``seq``."""
    pred = model(seq[:, :10] * 1e-3)
    diff = (seq[:, 10:] - pred).reshape(seq.shape[0], -1, 3)
    torch.linalg.norm(diff, dim=-1).mean().backward()
    return {k: p.grad for k, p in model.named_parameters()}


def replay_step(torch, dev, seeds, fused_models):
    """Phase 8 of chip_smoke.py for each seed: every fused model of
    ``fused_models`` (name -> ConvMixer class) against the plain one; the
    worst gradient difference relative to max(its gradient's max,
    STEP_FLOOR x the tree's largest), and the parameter it is at."""
    from motionmixerconv_tpu_torch.models import ConvMixer

    cfg = dict(chip_smoke.FLAGSHIP, regularization=0.0)  # dropout off
    out = []
    for seed in seeds:
        plain = ConvMixer(**cfg, generator=torch.Generator().manual_seed(seed))
        state = plain.state_dict()
        gs = torch.Generator().manual_seed(seed + 1)
        seq = (torch.randn(chip_smoke.TRAIN_BATCH, 35, 66, generator=gs)
               * 300.0).to(dev)
        gp = step_grads(torch, plain.to(dev).train(), seq)
        tree_max = max(float(g.abs().max()) for g in gp.values())
        row = {"seed": seed}
        for name, cls in fused_models.items():
            fused = cls(**cfg, encoder_fused=True)
            fused.load_state_dict(state, strict=True)
            gf = step_grads(torch, fused.to(dev).train(), seq)
            rel = {k: float((gf[k] - g).abs().max()) / max(
                float(g.abs().max()), chip_smoke.STEP_FLOOR * tree_max)
                for k, g in gp.items()}
            worst = max(rel, key=rel.get)
            row[name] = {"worst": worst, "rel": rel[worst]}
        out.append(row)
        chip_smoke.say(json.dumps(row))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--step-seeds", default="",
                    help="comma-separated seeds for the phase-8 replay")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch sees no CUDA device")
    from motionmixerconv_tpu_torch.models import ConvMixer
    from motionmixerconv_tpu_torch.models.encoding import harmonic_frequencies
    from motionmixerconv_tpu_torch.ops import harmonic as this
    from motionmixerconv_tpu_torch.serving import resolve_device

    other = load_other(args.other)
    card = chip_smoke.card_line()
    dev = torch.device(chip_smoke.DEVICE)
    torch.cuda.set_device(dev)
    resolve_device(dev)  # float32 convolutions and products, as the port runs
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    rows = max(r for _, r in FWD_CASES)
    x_all = (torch.randn(rows, D, generator=gen) * 0.5).to(dev)
    g_all = torch.randn(rows, E, generator=gen).to(dev)
    w = ((torch.rand(E, 2 * N * D, generator=gen) * 2 - 1)
         / (2 * N * D) ** 0.5).to(dev)
    b = ((torch.rand(E, generator=gen) * 2 - 1) / (2 * N * D) ** 0.5).to(dev)
    freqs = harmonic_frequencies(N, 0.1).to(dev)
    wi = this.reorder_weight(w, N, D)
    this.load_library()
    importlib.import_module("mmc_other.ops._build").load_library()

    def turns(f_other, f_this):
        t = [chip_smoke.cuda_ms(torch, f, reps=args.reps)
             for f in (f_other, f_this, f_this, f_other)]
        return {"other": [t[0], t[3]], "this": [t[1], t[2]]}

    results = []
    with torch.no_grad():
        for impl, r in FWD_CASES:
            x2d = x_all[:r].contiguous()
            got = this.harmonic_dense_fwd(x2d, w, b, freqs, impl, wi)
            again = this.harmonic_dense_fwd(x2d, w, b, freqs, impl, wi)
            old = other.harmonic_dense_fwd(x2d, w, b, freqs, impl, wi)
            want = this.harmonic_dense_plain(x2d, w, b, freqs, impl)
            err = float((got - want).abs().max())
            if not torch.equal(got, again):
                chip_smoke.fail(f"B1-fwd {impl} R={r}: two launches differ")
            if not err <= chip_smoke.TOL_B1:
                chip_smoke.fail(f"B1-fwd {impl} R={r}: {err:.3e} from plain")
            results.append({
                "kernel": "B1-fwd", "impl": impl, "rows": r,
                "err_vs_plain": err,
                "err_vs_other": float((got - old).abs().max()),
                **turns(lambda: other.harmonic_dense_fwd(
                            x2d, w, b, freqs, impl, wi),
                        lambda: this.harmonic_dense_fwd(
                            x2d, w, b, freqs, impl, wi)),
                "plain": chip_smoke.cuda_ms(torch, lambda: this.harmonic_dense_plain(
                    x2d, w, b, freqs, impl), reps=args.reps)})
            chip_smoke.say(json.dumps(results[-1]))
        for impl, r, dx_on in BWD_CASES:
            x2d, gr = x_all[:r].contiguous(), g_all[:r].contiguous()
            got = this.harmonic_dense_bwd(x2d, gr, w, freqs, impl, wi, dx_on)
            again = this.harmonic_dense_bwd(x2d, gr, w, freqs, impl, wi, dx_on)
            want = this.harmonic_dense_bwd_plain(x2d, gr, w, freqs, impl, dx_on)
            errs = {}
            for name, a, a2, ref in zip(("dx", "dW", "db"), got, again, want):
                if a is None:
                    continue
                if not torch.equal(a, a2):
                    chip_smoke.fail(f"B1-bwd {impl} R={r} {name}: two launches "
                                    "differ")
                errs[name] = float((a - ref).abs().max() / ref.abs().max())
                if not errs[name] <= chip_smoke.TOL_B1_BWD:
                    chip_smoke.fail(f"B1-bwd {impl} R={r} {name}: "
                                    f"{errs[name]:.3e} of max|ref|")
            results.append({
                "kernel": "B1-bwd", "impl": impl, "rows": r, "dx": dx_on,
                "rel_err_vs_plain": errs,
                **turns(lambda: other.harmonic_dense_bwd(
                            x2d, gr, w, freqs, impl, wi, need_dx=dx_on),
                        lambda: this.harmonic_dense_bwd(
                            x2d, gr, w, freqs, impl, wi, need_dx=dx_on)),
                "plain": chip_smoke.cuda_ms(torch, lambda: this.harmonic_dense_bwd_plain(
                    x2d, gr, w, freqs, impl, need_dx=dx_on), reps=args.reps)})
            chip_smoke.say(json.dumps(results[-1]))
    steps = []
    if args.step_seeds:
        steps = replay_step(
            torch, dev, [int(v) for v in args.step_seeds.split(",")],
            {"this": ConvMixer,
             "other": importlib.import_module("mmc_other.models").ConvMixer})
    chip_smoke.say(card)
    chip_smoke.say(json.dumps({"card": card, "ab": results, "steps": steps}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Time the port's kernels of this checkout against those of another
checkout of the repository, in turns on one card.

    python3 chip_ab.py --other path/to/other/checkout [--reps 20]
        [--kernels B1,B2,B3,B4] [--b1-shape 66,64,50] [--step-seeds 4,11,12]
        [--b2-plans] [--b3-plans]

Both trees' ``motionmixerconv_tpu_torch`` are imported side by side (the
other one under the package name ``mmc_other``); each builds its kernels
from its own ``csrc/`` into its own ``build/``. The cases: the harmonic
encoder kernels B1-fwd and B1-bwd at the flagship encoder's shape (D = 66,
n = 64, E = 50, or the D, n, E of ``--b1-shape``: 48,64,60 is the H36M angle
encoder's); the single-channel ConvMixer core B2 at B = 1, 7, 32 and
128 for the flagship and a BatchNorm + max-pool + 'once' model; the
multi-channel ConvMixer core B3 at B = 1 and 128 for the autoregressive and
the study shape; the fused MlpMixer B4 at B = 1, 32 and 128 for the AMASS
shape (random weights and inputs from a seed; each tree packs the same
model). For every case the script checks this tree's
kernel against the plain version (``chip_smoke.py``'s tolerances, and a
second launch bit-identical) and against the other tree's kernel, then
times by CUDA events around calls made from Python (``chip_smoke.cuda_ms``)
other, this, this, other on the same inputs, and the plain version once;
B2 and B4 are timed in turns a second time with their calls queued behind
a spin kernel (``chip_smoke.queued_ms``, key ``device``), so the events
time the device and not Python's pace of launching. With ``--kernels B2``
it also times the flagship's ``serving.Predictor.predict`` (encoder and B2)
of both trees at b = 1 and 32 on the host clock, in turns. With
``--step-seeds``, it also replays
``chip_smoke.py`` phase 8 (``step_check``: one flagship training step of
the plain model and of both trees' fused encoders, each float32 gradient
held to a float64 step) for each seed. With ``--b2-plans``, it times this
tree's B2 under every warp count its kernel takes (one block a sample;
``b2_plan`` picks min(T, 16)), launched through the library directly; with
``--b3-plans``, this tree's B3 under every
cluster size and stencil tile the shapes allow. It
prints the card's name and power limit and one JSON line with every
result; it exits non-zero if a check fails or there is no card.
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

FWD_CASES = [("direct", 500), ("direct", 1280), ("direct", 2560),
             ("doubling", 500), ("doubling", 2560)]
BWD_CASES = [("direct", 500, False), ("direct", 2560, False),
             ("direct", 500, True), ("direct", 2560, True),
             ("doubling", 500, False)]


B2_BATCHES = (1, 7, 32, 128)
B3_CASES = [("autoregressive", 1), ("autoregressive", 128), ("study", 1),
            ("study", 128)]
B4_BATCHES = (1, 32, 128)


def load_other(path: Path):
    """The other checkout's port package, imported as ``mmc_other``."""
    pkg_dir = path.resolve() / "motionmixerconv_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "mmc_other", pkg_dir / "__init__.py",
        submodule_search_locations=[str(pkg_dir)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["mmc_other"] = mod
    spec.loader.exec_module(mod)
    return mod


def replay_step(torch, dev, seeds, fused_models):
    """Phase 8 of chip_smoke.py for each seed (model seed, data seed + 1):
    the plain float32 step and every fused model of ``fused_models`` (name
    -> ConvMixer class), each held to the float64 step; per run the loss,
    the worst gradient against TOL_STEP and each ROUNDING_FLOOR gradient
    against its rounding bound, and whether every one is within."""
    out = []
    for seed in seeds:
        res = chip_smoke.step_check(torch, dev, seed, seed + 1, fused_models)
        row = {"seed": seed, "loss_float64": res["float64"][0]}
        for name in ("plain", *fused_models):
            loss, _, checks = res[name]
            floor = {k: checks[k][0] for k in chip_smoke.ROUNDING_FLOOR}
            rest = {k: v[0] for k, v in checks.items() if k not in floor}
            worst = max(rest, key=rest.get)
            row[name] = {"loss": loss, "worst": worst, "rel": rest[worst],
                         "rounding_floor": floor,
                         "ok": all(e <= t for e, t in checks.values())}
        out.append(row)
        chip_smoke.say(json.dumps(row))
    return out


def turns(torch, reps, f_other, f_this, timer=None):
    """CUDA-event ms per call of ``f_other`` and ``f_this``, timed other,
    this, this, other (by ``timer``, ``chip_smoke.cuda_ms`` by default)."""
    timer = timer or chip_smoke.cuda_ms
    t = [timer(torch, f, reps=reps) for f in (f_other, f_this, f_this, f_other)]
    return {"other": [t[0], t[3]], "this": [t[1], t[2]]}


def b1_cases(torch, dev, reps, shape):
    """B1-fwd and B1-bwd at the encoder shape (D, n, E)."""
    from motionmixerconv_tpu_torch.models.encoding import harmonic_frequencies
    from motionmixerconv_tpu_torch.ops import harmonic as this

    other = importlib.import_module("mmc_other.ops.harmonic")
    D, N, E = shape
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    rows = max(r for _, r in FWD_CASES)
    x_all = (torch.randn(rows, D, generator=gen) * 0.5).to(dev)
    g_all = torch.randn(rows, E, generator=gen).to(dev)
    w = ((torch.rand(E, 2 * N * D, generator=gen) * 2 - 1)
         / (2 * N * D) ** 0.5).to(dev)
    b = ((torch.rand(E, generator=gen) * 2 - 1) / (2 * N * D) ** 0.5).to(dev)
    freqs = harmonic_frequencies(N, 0.1).to(dev)
    wi = this.reorder_weight(w, N, D)
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
                "kernel": "B1-fwd", "shape": shape, "impl": impl, "rows": r,
                "err_vs_plain": err,
                "err_vs_other": float((got - old).abs().max()),
                **turns(torch, reps, lambda: other.harmonic_dense_fwd(
                            x2d, w, b, freqs, impl, wi),
                        lambda: this.harmonic_dense_fwd(
                            x2d, w, b, freqs, impl, wi)),
                "plain": chip_smoke.cuda_ms(torch, lambda: this.harmonic_dense_plain(
                    x2d, w, b, freqs, impl), reps=reps)})
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
                "kernel": "B1-bwd", "shape": shape, "impl": impl, "rows": r,
                "dx": dx_on,
                "rel_err_vs_plain": errs,
                **turns(torch, reps, lambda: other.harmonic_dense_bwd(
                            x2d, gr, w, freqs, impl, wi, need_dx=dx_on),
                        lambda: this.harmonic_dense_bwd(
                            x2d, gr, w, freqs, impl, wi, need_dx=dx_on)),
                "plain": chip_smoke.cuda_ms(torch, lambda: this.harmonic_dense_bwd_plain(
                    x2d, gr, w, freqs, impl, need_dx=dx_on), reps=reps)})
            chip_smoke.say(json.dumps(results[-1]))
    return results


def ab_case(torch, reps, name, tol, this_fn, other_fn, plain_fn, extra,
            device=False):
    """One kernel case: this tree's kernel against the plain version and a
    second launch of itself, against the other tree's kernel, then timed in
    turns per call from Python and, with ``device``, again with the calls
    queued (``chip_smoke.queued_ms``); the plain version timed once."""
    got, again = this_fn(), this_fn()
    want, old = plain_fn(), other_fn()
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.isfinite(got).all() or not err <= tol:
        chip_smoke.fail(f"{name}: {err:.3e} from the plain version (tol {tol:g})")
    if not torch.equal(got, again):
        chip_smoke.fail(f"{name}: two launches differ")
    row = {"kernel": name, **extra, "err_vs_plain": err,
           "err_vs_other": float((got - old).abs().max()),
           **turns(torch, reps, other_fn, this_fn),
           "plain": chip_smoke.cuda_ms(torch, plain_fn, reps=reps)}
    if device:
        row["device"] = turns(torch, reps, other_fn, this_fn,
                              chip_smoke.queued_ms)
    chip_smoke.say(json.dumps(row))
    return row


def b2_models(torch, dev):
    """The flagship and a BatchNorm + max-pool + 'once' model (warmed
    BatchNorm statistics) with 128 encoded samples each."""
    from motionmixerconv_tpu_torch.models import ConvMixer
    from motionmixerconv_tpu_torch.ops import conv_mixer

    gb = torch.Generator().manual_seed(chip_smoke.SEED + 11)
    x = (torch.randn(128, 10, 66, generator=gb) * 0.5).to(dev)
    cfgs = {"flagship": chip_smoke.FLAGSHIP,
            "bn+maxpool+once": dict(chip_smoke.FLAGSHIP, regularization=-1.0,
                                    use_max_pooling=True, mode_conv="once")}
    out = {}
    with torch.no_grad():
        for tag, cfg in cfgs.items():
            model = chip_smoke.warm_batchnorm(
                torch, ConvMixer(**cfg, generator=gb).eval(), gb).to(dev)
            fused = conv_mixer.make_fused_conv_mixer(model)
            out[tag] = (model, fused,
                        fused.encoder(x)[..., 0].contiguous())
    return out


def b2_cases(torch, dev, reps):
    """B2 at B = 1, 7, 32 and 128 for the flagship and the bn+maxpool+once
    model, each tree packing the same model; then each tree's flagship
    ``Predictor.predict`` at b = 1 and 32 on the host clock, in turns."""
    from motionmixerconv_tpu_torch import serving
    from motionmixerconv_tpu_torch.ops import conv_mixer as this

    other = importlib.import_module("mmc_other.ops.conv_mixer")
    results = []
    models = b2_models(torch, dev)
    with torch.no_grad():
        for tag, (model, fused, y_all) in models.items():
            spec, wts = fused.spec, fused.weights
            o_spec, o_wts = other.pack_conv_mixer(model)
            for b in B2_BATCHES:
                y = y_all[:b].contiguous()
                plan = this.b2_plan(spec, b)
                results.append(ab_case(
                    torch, reps, "B2", chip_smoke.TOL_B2,
                    lambda: this.conv_mixer_fused(y, wts, spec),
                    lambda: other.conv_mixer_fused(y, o_wts, o_spec),
                    lambda: this.conv_mixer_plain(y, wts, spec),
                    {"shape": tag, "batch": b, "plan": {
                        "warps": plan.warps, "blocks": plan.blocks}},
                    device=True))
    model = models["flagship"][0]
    # each tree's Predictor routes only its own model classes to a kernel
    other_model = importlib.import_module("mmc_other.models").ConvMixer(
        **chip_smoke.FLAGSHIP)
    other_model.load_state_dict(model.state_dict(), strict=True)
    this_p = serving.Predictor(model, device=dev)
    other_p = importlib.import_module("mmc_other.serving").Predictor(
        other_model, device=dev)
    if this_p._fused is None or other_p._fused is None:
        chip_smoke.fail("a tree's Predictor does not serve the flagship "
                        "through B2")
    gx = torch.Generator().manual_seed(chip_smoke.SEED + 13)
    x = torch.randn(32, 10, 66, generator=gx) * 0.5
    for b in (1, 32):
        xb = x[:b].clone()
        fns = {k: (lambda p=p: p.predict(xb).cpu())
               for k, p in (("this", this_p), ("other", other_p))}
        err = float((fns["this"]() - fns["other"]()).abs().max())
        t = [chip_smoke.host_median_ms(fns[k], reps=200)
             for k in ("other", "this", "this", "other")]
        results.append({"kernel": "B2 serving", "what": "Predictor.predict",
                        "batch": b, "err_vs_other": err,
                        "other": [t[0], t[3]], "this": [t[1], t[2]]})
        chip_smoke.say(json.dumps(results[-1]))
    return results


def b2_plans(torch, dev, reps):
    """This tree's B2 under every warp count its kernel takes (1 to
    min(T, 16), one block a sample), launched through the library with the
    wrapper's arguments, at B = 1, 32 and 128 for the flagship and the
    bn+maxpool+once model, each checked against the plain version: which
    count ``b2_plan`` should pick."""
    from motionmixerconv_tpu_torch.ops import _build, conv_mixer as this

    lib = _build.load_library()
    results = []
    with torch.no_grad():
        for tag, (_, fused, y_all) in b2_models(torch, dev).items():
            spec, wts = fused.spec, fused.weights
            chosen = this.b2_plan(spec, 1).warps
            for b in (1, 32, 128):
                y = y_all[:b].contiguous()
                want = this.conv_mixer_plain(y, wts, spec)
                out = torch.empty_like(want)

                def launch(warps):
                    _build.check(lib, lib.mmc_conv_mixer_fused(
                        y.data_ptr(), wts.data_ptr(), out.data_ptr(), b,
                        *spec.kernel_args(), warps, _build.stream_ptr(dev)),
                        "conv_mixer_fused")
                    return out

                for w in range(1, min(spec.T, this.MAX_WARPS) + 1):
                    err = float((launch(w) - want).abs().max())
                    if not err <= chip_smoke.TOL_B2:
                        chip_smoke.fail(f"B2 {tag} B={b} {w} warps: {err:.3e}")
                    results.append({
                        "kernel": "B2 plan", "shape": tag, "batch": b,
                        "warps": w, "chosen": w == chosen,
                        "ms": chip_smoke.queued_ms(
                            torch, lambda: launch(w), reps=reps)})
                    chip_smoke.say(json.dumps(results[-1]))
    return results


def b3_cases(torch, dev, reps):
    """B3 at the autoregressive and the study shape (warmed BatchNorm
    statistics), each tree packing the same model."""
    from motionmixerconv_tpu_torch.models import ConvMixer
    from motionmixerconv_tpu_torch.ops import conv_mixer, conv_mixer_mc as this

    other = importlib.import_module("mmc_other.ops.conv_mixer_mc")
    gb = torch.Generator().manual_seed(chip_smoke.SEED + 7)
    x = (torch.randn(128, 10, 66, generator=gb) * 0.5).to(dev)
    shapes = {"autoregressive": chip_smoke.AUTOREG, "study": chip_smoke.STUDY}
    results = []
    with torch.no_grad():
        for tag, cfg in shapes.items():
            model = chip_smoke.warm_batchnorm(
                torch, ConvMixer(**cfg, generator=gb).eval(), gb).to(dev)
            fused = conv_mixer.make_fused_conv_mixer(model)
            spec, wts = fused.spec, fused.weights
            o_spec, o_wts = other.pack_conv_mixer_mc(model)
            y_all = fused.encoder(x).permute(0, 3, 1, 2).contiguous()
            for t, b in B3_CASES:
                if t != tag:
                    continue
                y = y_all[:b].contiguous()
                plan = this.mc_plan(spec, b, this.cluster_slots(y.device.index))
                results.append(ab_case(
                    torch, reps, "B3", chip_smoke.TOL_B3,
                    lambda: this.conv_mixer_mc_fused(y, wts, spec),
                    lambda: other.conv_mixer_mc_fused(y, o_wts, o_spec),
                    lambda: this.conv_mixer_mc_plain(y, wts, spec),
                    {"shape": tag, "batch": b, "plan": {
                        "K": plan.K, "threads": plan.threads,
                        "tile": this.TILES[plan.tile]}}))
    return results


def b3_plans(torch, dev, reps):
    """This tree's B3 under every launch plan its shapes allow (each cluster
    size and stencil tile), at B = 1, 32 and 128 for the autoregressive
    and the study shape, each checked against the plain version: which
    plan ``mc_plan`` should pick."""
    from motionmixerconv_tpu_torch.models import ConvMixer
    from motionmixerconv_tpu_torch.ops import conv_mixer, conv_mixer_mc as this

    gb = torch.Generator().manual_seed(chip_smoke.SEED + 7)
    x = (torch.randn(128, 10, 66, generator=gb) * 0.5).to(dev)
    shapes = {"autoregressive": chip_smoke.AUTOREG, "study": chip_smoke.STUDY}
    results = []
    with torch.no_grad():
        for tag, cfg in shapes.items():
            model = chip_smoke.warm_batchnorm(
                torch, ConvMixer(**cfg, generator=gb).eval(), gb).to(dev)
            fused = conv_mixer.make_fused_conv_mixer(model)
            spec, wts = fused.spec, fused.weights
            y_all = fused.encoder(x).permute(0, 3, 1, 2).contiguous()
            for b in (1, 32, 128):
                y = y_all[:b].contiguous()
                want = this.conv_mixer_mc_plain(y, wts, spec)
                slots = this.cluster_slots(y.device.index)
                chosen = this.mc_plan(spec, b, slots)
                for k in spec.cluster_sizes():
                    for t in range(len(this.TILES)):
                        plan = this.mc_plan(spec, b, slots, K=k, tile=t)
                        got = this.conv_mixer_mc_fused(y, wts, spec, plan)
                        err = float((got - want).abs().max())
                        if not err <= chip_smoke.TOL_B3:
                            chip_smoke.fail(f"B3 {tag} B={b} {plan}: {err:.3e}")
                        results.append({
                            "kernel": "B3 plan", "shape": tag, "batch": b,
                            "K": k, "tile": this.TILES[t],
                            "threads": plan.threads, "chosen": plan == chosen,
                            "ms": chip_smoke.cuda_ms(
                                torch, lambda: this.conv_mixer_mc_fused(
                                    y, wts, spec, plan), reps=reps)})
                        chip_smoke.say(json.dumps(results[-1]))
    return results


def b4_cases(torch, dev, reps):
    """B4 at the AMASS shape (warmed BatchNorm statistics), each tree
    packing the same model."""
    from motionmixerconv_tpu_torch.models import MlpMixer
    from motionmixerconv_tpu_torch.ops import mlp_mixer as this

    other = importlib.import_module("mmc_other.ops.mlp_mixer")
    gm = torch.Generator().manual_seed(chip_smoke.SEED + 9)
    results = []
    with torch.no_grad():
        model = chip_smoke.warm_batchnorm(
            torch, MlpMixer(**chip_smoke.AMASS_MLP, generator=gm).eval(),
            gm).to(dev)
        fused = this.make_fused_mlp_mixer(model)
        spec, wts = fused.spec, fused.weights
        o_spec, o_wts = other.pack_mlp_mixer(model)
        x = (torch.randn(max(B4_BATCHES), spec.T, spec.D, generator=gm)
             * 0.5).to(dev)
        for b in B4_BATCHES:
            xb = x[:b].contiguous()
            results.append(ab_case(
                torch, reps, "B4", chip_smoke.TOL_B4,
                lambda: this.mlp_mixer_fused(xb, wts, spec),
                lambda: other.mlp_mixer_fused(xb, o_wts, o_spec),
                lambda: this.mlp_mixer_plain(xb, wts, spec),
                {"shape": "amass", "batch": b}, device=True))
    return results


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", default="B1,B2,B3,B4",
                    help="comma-separated kernels to time: B1, B2, B3, B4")
    ap.add_argument("--b1-shape", default="66,64,50",
                    help="B1's encoder shape D,n,E (the flagship's by default)")
    ap.add_argument("--step-seeds", default="",
                    help="comma-separated seeds for the phase-8 replay")
    ap.add_argument("--b2-plans", action="store_true",
                    help="also time this tree's B2 under every warp count")
    ap.add_argument("--b3-plans", action="store_true",
                    help="also time this tree's B3 under every launch plan")
    args = ap.parse_args()
    kernels = {k for k in args.kernels.split(",") if k}
    known = {"B1", "B2", "B3", "B4"}
    if not kernels <= known:
        chip_smoke.fail(f"unknown kernels {kernels - known}")

    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch sees no CUDA device")
    from motionmixerconv_tpu_torch.models import ConvMixer
    from motionmixerconv_tpu_torch.ops import _build
    from motionmixerconv_tpu_torch.serving import resolve_device

    load_other(args.other)
    card = chip_smoke.card_line()
    dev = torch.device(chip_smoke.DEVICE)
    torch.cuda.set_device(dev)
    resolve_device(dev)  # float32 convolutions and products, as the port runs
    _build.load_library()
    importlib.import_module("mmc_other.ops._build").load_library()

    results = []
    if "B1" in kernels:
        results += b1_cases(torch, dev, args.reps,
                            tuple(int(v) for v in args.b1_shape.split(",")))
    if "B2" in kernels:
        results += b2_cases(torch, dev, args.reps)
    if "B3" in kernels:
        results += b3_cases(torch, dev, args.reps)
    if "B4" in kernels:
        results += b4_cases(torch, dev, args.reps)
    if args.b2_plans:
        results += b2_plans(torch, dev, args.reps)
    if args.b3_plans:
        results += b3_plans(torch, dev, args.reps)
    steps = []
    if args.step_seeds:
        steps = replay_step(
            torch, dev, [int(v) for v in args.step_seeds.split(",")],
            {"this": ConvMixer,
             "other": importlib.import_module("mmc_other.models").ConvMixer})
    chip_smoke.say(card)
    chip_smoke.say(json.dumps({"card": card, "ab": results, "steps": steps}))
    if not all(r[k]["ok"] for r in steps for k in ("plain", "this", "other")):
        chip_smoke.fail("a replayed training step is outside its bounds")


if __name__ == "__main__":
    main()

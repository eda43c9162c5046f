#!/usr/bin/env python3
"""Hold kernels B2 and B4 against their plain versions across their
domains on one NVIDIA card.

    python3 tools/kernel_domain_sweep.py [--out file.json]

``chip_smoke.py`` checks B2 at the flagship and one BatchNorm + max-pool +
'once' model, and B4 at six shapes. This sweep adds the edges of both
domains: for B2, stencils that span time rows with and without SE (the
barrier cases of ``csrc/conv_mixer_fused.cu``), even kernels (torch's extra
right pad), one time row (a one-warp group), more rows than warps, a
decoder plane wider than the residual planes, and a wide embedding; for
B4, widths that are not multiples of 4, every block type with and without
SE, one block, odd windows, and shapes that take two, one and no shared
weight buffers and activations in device scratch. Every
case runs at several batches, twice for bit-identity, against the plain
version at chip_smoke's tolerances. Random weights from a seed. Prints the
card's name and power limit and one JSON line; exits non-zero on any
disagreement or without a card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the tolerances, shapes, card line, fail)

F = chip_smoke.FLAGSHIP
SAME = dict(conv1_padding=None)
B2_CASES = {
    "flagship": dict(F),
    "k33_se": dict(F, **SAME, conv1_kernel_shape=(3, 3)),
    "k33_no_se": dict(F, **SAME, conv1_kernel_shape=(3, 3), use_se=False),
    "k24_even_gelu": dict(F, **SAME, conv1_kernel_shape=(2, 4),
                          activation="gelu"),
    "k51_once_max": dict(F, **SAME, conv1_kernel_shape=(5, 1),
                         mode_conv="once", use_max_pooling=True),
    "one_row": dict(F, in_nTP=1, r_se=1),
    "rows_past_warps": dict(F, **SAME, in_nTP=23, r_se=4, dimPosEmb=40,
                            conv1_kernel_shape=(3, 5)),
    "short_horizon": dict(F, out_nTP=5, dimPosEmb=70),
    "wide_E": dict(F, **SAME, dimPosEmb=400, num_blocks=2),
}
B2_BATCHES = (1, 7, 33, 128)

M = chip_smoke.AMASS_MLP
B4_CASES = {
    "amass": dict(M),
    "odd_widths": dict(M, hidden_dim=50, tokens_mlp_dim=21,
                       channels_mlp_dim=54, num_classes=66, input_size=66,
                       r_se=4),
    "no_se": dict(M, use_se=False),
    "channel_only_no_se": dict(M, mlp_block_type="channel_only",
                               use_se=False),
    "token_only_max": dict(M, mlp_block_type="token_only",
                           use_max_pooling=True, regularization=-1.0),
    "one_block_odd_window": dict(M, num_blocks=1, seq_len=7, pred_len=13,
                                 r_se=2),
    "one_buffer": dict(M, hidden_dim=160, channels_mlp_dim=160,
                       num_blocks=2),
    "in_place": dict(M, hidden_dim=300, channels_mlp_dim=260,
                     num_blocks=1),
    "scratch_no_se": dict(M, seq_len=240, pred_len=60, num_blocks=1,
                          use_se=False),
}
B4_BATCHES = (1, 7, 33)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch sees no CUDA device")
    from motionmixerconv_tpu_torch.models import ConvMixer, MlpMixer
    from motionmixerconv_tpu_torch.ops import conv_mixer, mlp_mixer
    from motionmixerconv_tpu_torch.serving import resolve_device

    card = chip_smoke.card_line()
    dev = torch.device(chip_smoke.DEVICE)
    torch.cuda.set_device(dev)
    resolve_device(dev)
    gen = torch.Generator().manual_seed(chip_smoke.SEED + 12)
    rows = []

    def check(name, got, again, want, tol):
        err = float((got - want).abs().max())
        if not torch.isfinite(got).all() or not err <= tol:
            chip_smoke.fail(f"{name}: {err:.3e} from the plain version")
        if not torch.equal(got, again):
            chip_smoke.fail(f"{name}: two launches differ")
        return err

    with torch.no_grad():
        for tag, cfg in B2_CASES.items():
            model = chip_smoke.warm_batchnorm(
                torch, ConvMixer(**cfg, generator=gen).eval(), gen).to(dev)
            fused = conv_mixer.make_fused_conv_mixer(model)
            spec, wts = fused.spec, fused.weights
            x = (torch.randn(max(B2_BATCHES), spec.T, cfg["dimPosIn"],
                             generator=gen) * 0.5).to(dev)
            y_all = fused.encoder(x)[..., 0].contiguous()
            for b in B2_BATCHES:
                y = y_all[:b].contiguous()
                want = conv_mixer.conv_mixer_plain(y, wts, spec)
                err = check(f"B2 {tag} B={b}",
                            conv_mixer.conv_mixer_fused(y, wts, spec),
                            conv_mixer.conv_mixer_fused(y, wts, spec),
                            want, chip_smoke.TOL_B2)
                rows.append({"kernel": "B2", "shape": tag, "batch": b,
                             "warps": conv_mixer.b2_plan(spec, b).warps,
                             "max_abs_err": err})
        for tag, cfg in B4_CASES.items():
            model = chip_smoke.warm_batchnorm(
                torch, MlpMixer(**cfg, generator=gen).eval(), gen).to(dev)
            fused = mlp_mixer.make_fused_mlp_mixer(model)
            spec, wts = fused.spec, fused.weights
            x = (torch.randn(max(B4_BATCHES), spec.T, spec.D, generator=gen)
                 * 0.5).to(dev)
            for b in B4_BATCHES:
                xb = x[:b].contiguous()
                want = mlp_mixer.mlp_mixer_plain(xb, wts, spec)
                err = check(f"B4 {tag} B={b}",
                            mlp_mixer.mlp_mixer_fused(xb, wts, spec),
                            mlp_mixer.mlp_mixer_fused(xb, wts, spec),
                            want, chip_smoke.TOL_B4)
                rows.append({"kernel": "B4", "shape": tag, "batch": b,
                             "scratch": spec.uses_scratch,
                             "nbuf": spec.nbufs(), "max_abs_err": err})
    worst = {k: max(r["max_abs_err"] for r in rows if r["kernel"] == k)
             for k in ("B2", "B4")}
    chip_smoke.say(f"[sweep] {card} | {len(rows)} cases, each against its "
                   f"plain version and bit-identical twice | worst "
                   f"max_abs_err B2 {worst['B2']:.3e} (tol "
                   f"{chip_smoke.TOL_B2:g}), B4 {worst['B4']:.3e} (tol "
                   f"{chip_smoke.TOL_B4:g})")
    line = json.dumps({"card": card, "cases": rows})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    chip_smoke.say(card)
    chip_smoke.say(json.dumps({"cases": len(rows), "worst": worst}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The H100 benchmark of ``motionmixerconv_tpu_torch``: one cell of
``BENCHMARK.json`` per run.

    python3 bench_h100/run.py --workload flagship.train --seed 7 \\
        --seconds 20 --trace 0

Prints, as its last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device`` and, last,
``checks``: each compared number beside its limit, which are also the last
lines of standard error. Exits non-zero, printing no result, without a
CUDA card (or with fewer than the cell asks for), or when a module of JAX,
flax or the JAX package is loaded once the window has closed.

The program's build and kernel caches are kept inside the checkout, under
``build/``, at fixed paths.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "CUDA_CACHE_PATH": "cuda_cache"}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "bench_cache" / sub)
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_h100 import harness

    cell = harness.resolve(harness.load_benchmark(), args.workload)
    chips = cell.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_h100: the cell needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from motionmixerconv_tpu_torch.serving import resolve_device

    device = resolve_device("cuda")
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device, T_START)
    if out["forbidden"]:
        print(f"bench_h100: loaded after the window: {out['forbidden']}",
              file=sys.stderr)
        return 3
    for name, value, limit in out["rows"]:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The readings a cell's limits are set from, on the card: for each seed,
the compared numbers of the program, of the control (the reference with
TF32 allowed, put in the program's place: the precision just below the
configuration's float32 with TF32 off) and, in a training cell, of a
planted fault (half of each batch left out, the mean over the rest).

    python3 bench_h100/control.py --workload flagship.train \\
        --seeds 11,12,13 [--seconds 4]

Every cell runs a short window of ``--seconds`` first: a serving cell's
answers come from it, and a training cell's step after the window starts
from the state it leaves. One JSON line per seed; the benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    os.environ.setdefault("CUDA_CACHE_PATH",
                          str(ROOT / "build" / "bench_cache" / "cuda_cache"))
    sys.path.insert(0, str(ROOT))
    import torch

    from bench_h100 import harness
    from motionmixerconv_tpu_torch.serving import resolve_device

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    device = resolve_device("cuda")
    r = harness.resolve(harness.load_benchmark(), args.workload)
    drv = harness.driver_module(r.driver)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            ctx = SimpleNamespace(workload=args.workload, config=r.config,
                                  traffic=r.traffic, seed=seed, device=device,
                                  seconds=args.seconds, trace=False, tmp=tmp)
            state = drv.setup(ctx)
            drv.window(state, args.seconds, False)
            out = drv.control_readings(state)
        del state
        torch.cuda.empty_cache()
        print(json.dumps({"seed": seed, "s": time.perf_counter() - t0,
                          **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Resolve a cell of ``BENCHMARK.json`` to its files, run it, and assemble
its result.

A cell names a configuration (``configs/<config>.json``, found through
``BENCHMARK.json``) and a traffic mix (``traffic/<traffic>.json``), whose
``driver`` names ``drivers/<driver>.py``; its limits are
``limits/<cell>.json``; each per-layer metric is ``metrics/<metric>.py``.
Adding a cell, a mix, a driver or a metric adds files and edits none.

A driver module has ``setup(ctx)``, ``window(state, seconds, trace)``
and ``check(state)``; a metric module has ``read(run)``, which returns
the metric's value or None where it finds nothing to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Optional

from . import checks

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "motionmixerconv_tpu")


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(bench: dict, workload: str) -> SimpleNamespace:
    """The cell's entry, configuration, traffic mix, driver name, and the
    names of its end-to-end and per-layer metrics."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])
                 and m["moves"] in e2e_names]
    return SimpleNamespace(cell=cell, config=config, traffic=traffic,
                           driver=traffic["driver"], end_to_end=e2e,
                           per_layer=per_layer)


def driver_module(name: str):
    return importlib.import_module(f"bench_h100.drivers.{name}")


def metric_module(name: str):
    """``metrics/<name>.py`` (a metric's name may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_h100_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: the port's name begins with the JAX
    package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, overrides: Optional[dict] = None) -> dict:
    """Run one cell on ``device`` and return its result (not yet printed).
    ``overrides`` ({"config": {...}, "traffic": {...}}) serve the tests
    that run the harness small on the CPU."""
    import torch

    r = resolve(load_benchmark(), workload)
    for part in ("config", "traffic"):
        getattr(r, part).update((overrides or {}).get(part, {}))
    drv = driver_module(r.driver)
    print(f"before set-up: {time.perf_counter() - t_start:.3f} s "
          "(interpreter, imports)", file=sys.stderr)
    with tempfile.TemporaryDirectory() as tmpdir:
        ctx = SimpleNamespace(workload=workload, config=r.config,
                              traffic=r.traffic, seed=int(seed), device=device,
                              seconds=seconds, trace=trace, tmp=tmpdir)
        state = drv.setup(ctx)
        setup_s = time.perf_counter() - t_start
        out = drv.window(state, seconds, trace)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    bad = forbidden_modules()
    values = drv.check(state)
    correct, rows = checks.judge(values, checks.limits_for(workload))
    compared = {name for name, _, _ in rows}
    print("not compared: " + ", ".join(
        f"{k} {v!r}" for k, v in values.items() if k not in compared),
        file=sys.stderr)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)
    run = SimpleNamespace(workload=workload, config=r.config,
                          traffic=r.traffic, counters=out["counters"],
                          trace=out["trace"], e2e=out["e2e"], device_kind=kind)
    metrics = {}
    if trace:
        for m in r.per_layer:
            v = metric_module(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in r.end_to_end:
            v = setup_s if m["name"] == "setup_s" else out["e2e"][m["name"]]
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": kind,
           "count": r.cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(out["attempted"]),
              "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    if trace and out["trace"] is not None:
        dev["busy_s"] = out["trace"].busy_s
        dev["window_s"] = out["trace"].window_s
        result["breakdown"] = out["trace"].breakdown()
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return {"result": result, "forbidden": bad, "rows": rows}

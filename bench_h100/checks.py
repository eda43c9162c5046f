"""The arithmetic of the comparison that decides ``correct``, and the limits.

Each cell's limits sit in ``limits/<cell>.json``: for every compared
number its limit and the two readings it was set between (the largest
the program gave over a dozen seeds or more, the smallest the control or
a planted fault gave).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict

import numpy as np
import torch

LIMITS = Path(__file__).resolve().parent / "limits"


def rel_gap(a: float, b: float) -> float:
    """|a - b| / |b|."""
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def leaf_gap(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]):
    """(gap, leaf, median): the worst leaf's gap between the program's norm and the
    reference's, against the reference's norm of that leaf or of the median
    leaf, whichever is larger (some leaves are all but zero); and the
    median of the leaves' gaps."""
    rn = {k: float(ref[k].double().norm()) for k in ref}
    med = float(np.median(list(rn.values())))
    gaps = {k: _ratio(abs(float(prog[k].double().norm()) - rn[k]),
                      max(rn[k], med)) for k in ref}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst, float(np.median(list(gaps.values())))


def global_gap(prog: Dict[str, torch.Tensor],
               ref: Dict[str, torch.Tensor]) -> float:
    """The gap between the program's and the reference's norms over all
    leaves together, against the reference's."""
    pn = sum(float(prog[k].double().norm()) ** 2 for k in ref) ** 0.5
    rn = sum(float(ref[k].double().norm()) ** 2 for k in ref) ** 0.5
    return _ratio(abs(pn - rn), rn)


def _ratio(gap: float, scale: float) -> float:
    """gap / scale; 0 where both are 0, infinite where only the scale is."""
    if scale > 0:
        return gap / scale
    return 0.0 if gap == 0 else float("inf")


def limits_for(workload: str) -> Dict[str, float]:
    """{number: limit} of a cell."""
    with open(LIMITS / f"{workload}.json") as f:
        data = json.load(f)
    return {k: float(v["limit"]) for k, v in data["numbers"].items()}


def judge(values: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): every number that has a limit at
    or under it; a limited number not computed is not correct. Numbers
    with no limit are not compared."""
    rows = [(k, values.get(k), limits[k]) for k in limits]
    ok = all(v is not None and np.isfinite(v) and v <= lim
             for _, v, lim in rows)
    return ok, rows

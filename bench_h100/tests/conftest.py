"""Shared settings of the benchmark's own tests, which run on the CPU at a
small size (the card's tests carry the ``card`` marker and skip without
one). The repository root goes on ``sys.path`` so that ``bench_h100`` and
the port import by name."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# two actions, skip 5 and two blocks at the published widths: a run the CPU
# holds in seconds, whose first epoch passes a milestone of the
# schedule (14 steps); the serving mixes at a rate the CPU's plain kernels keep
SMALL = {"config": {"actions": ["walking", "eating"], "skip_rate": 5,
                    "num_blocks": 2,
                    "milestones": [1]},
         "traffic": {"rate_per_s": 20.0, "warmup_requests": 4,
                     "sample_answers": 16}}
SEED = 2 ** 31 + 77  # beyond 32 signed bits, as a run's --seed may be


@pytest.fixture(autouse=True)
def _few_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

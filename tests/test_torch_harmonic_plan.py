"""The harmonic encoder kernels' launch plans (``ops/harmonic.py``
``fwd_plan`` and ``bwd_plan``) and the exact-argument identity their design
relies on, on the CPU.

The plans are plain Python: how many blocks, harmonic groups, row chunks
and floats of scratch the CUDA kernels take at the flagship encoder's shape
(D = 66, n = 64, E = 50) for the training step's R = 500 rows, the bulk
Predictor's R = 2560 and a single row, and where they raise
NotImplementedError. ``chip_smoke.py`` checks on the card that the kernels'
library agrees with them.
"""

import numpy as np
import pytest

from motionmixerconv_tpu_torch.models.encoding import harmonic_frequencies
from motionmixerconv_tpu_torch.ops import harmonic
from motionmixerconv_tpu_torch.ops._build import MAX_SMEM_BYTES

D, N, E = 66, 64, 50
H100_SMS = 132

# rows -> (blocks, harmonic groups, harmonics per group, scratch floats)
FWD_EXPECTED = {
    1: (64, 64, 1, 64 * 1 * E),
    500: (256, 16, 4, 16 * 500 * E),
    2560: (1280, 16, 4, 16 * 2560 * E),
}
# rows -> (dW blocks, row chunks, rows per chunk, dx groups, dx blocks,
#          scratch floats)
BWD_EXPECTED = {
    1: (64, 1, 32, 64, 64, 1 * N * 2 * D * E),
    500: (256, 4, 128, 8, 256, 4 * N * 2 * D * E),
    2560: (256, 4, 640, 8, 1280, 4 * N * 2 * D * E),
}


@pytest.mark.parametrize("rows", sorted(FWD_EXPECTED))
def test_forward_plan_at_the_flagship_rows(rows):
    plan = harmonic.fwd_plan(rows, D, E, N, H100_SMS)
    assert (plan.blocks, plan.groups, plan.hg, plan.scratch) == \
        FWD_EXPECTED[rows]
    assert (plan.cols, plan.col_tiles, plan.threads) == (52, 1, 256)
    assert plan.blocks == plan.row_tiles * plan.col_tiles * plan.groups
    assert plan.row_tiles == -(-rows // harmonic.FWD_ROWS)
    # two blocks share an SM; the training step's grid fills the card once
    assert plan.blocks_per_sm == 2
    assert plan.blocks_per_sm * (plan.smem + 1024) <= harmonic.SM_SMEM_BYTES
    if rows == 500:
        assert H100_SMS <= plan.blocks <= plan.blocks_per_sm * H100_SMS


@pytest.mark.parametrize("rows", sorted(BWD_EXPECTED))
def test_backward_plan_at_the_flagship_rows(rows):
    plan = harmonic.bwd_plan(rows, D, E, N, True, H100_SMS)
    assert (plan.blocks, plan.chunks, plan.chunk_rows, plan.dx_groups,
            plan.dx_blocks, plan.scratch) == BWD_EXPECTED[rows]
    # one dW block per (harmonic, chunk): its sin and its cos slab together
    assert plan.blocks == N * plan.chunks * plan.col_tiles
    assert plan.chunks * plan.chunk_rows >= rows
    assert (plan.chunks - 1) * plan.chunk_rows < rows
    assert (plan.cols, plan.col_tiles, plan.threads) == (52, 1, 448)
    assert plan.finish_smem == 4 * E * (N + 1)
    assert plan.dx_ld % 2 == 1
    if rows == 500:
        assert plan.blocks >= H100_SMS and plan.dx_blocks >= H100_SMS
    no_dx = harmonic.bwd_plan(rows, D, E, N, False, H100_SMS)
    assert (no_dx.dx_blocks, no_dx.dx_groups, no_dx.blocks) == \
        (0, 0, plan.blocks)
    assert no_dx.scratch == N * plan.chunks * 2 * D * E


@pytest.mark.parametrize("shape", [(7, 5, 7, 3), (33, 11, 9, 1),
                                   (45, 7, 70, 5), (300, 13, 3, 6),
                                   (1000, 66, 120, 64), (129, 128, 50, 16)])
@pytest.mark.parametrize("sms", [4, 132])
def test_plans_cover_every_row_column_and_harmonic(shape, sms):
    r, d, e, n = shape
    fp = harmonic.fwd_plan(r, d, e, n, sms)
    assert fp.cols % 4 == 0 and fp.cols <= harmonic.FWD_MAX_COLS
    assert fp.cols * fp.col_tiles >= e > fp.cols * (fp.col_tiles - 1)
    assert fp.row_tiles * harmonic.FWD_ROWS >= r
    assert fp.groups * fp.hg >= n > (fp.groups - 1) * fp.hg
    assert fp.hg & (fp.hg - 1) == 0
    assert fp.scratch == (fp.groups * r * e if fp.groups > 1 else 0)
    assert fp.smem <= MAX_SMEM_BYTES
    # each thread half owns 4 x 4 outputs of the 32-row tile
    assert (harmonic.FWD_ROWS // 4) * (fp.cols // 4) <= fp.threads // 2
    bp = harmonic.bwd_plan(r, d, e, n, True, sms)
    kgs = -(-2 * d // 4)
    assert bp.threads % 32 == 0 and bp.threads <= harmonic.MAX_THREADS
    assert bp.threads >= kgs * (bp.cols // 4)
    assert bp.cols * bp.col_tiles >= e
    assert bp.chunk_rows % harmonic.DW_ROWS == 0
    assert bp.chunks * bp.chunk_rows >= r > (bp.chunks - 1) * bp.chunk_rows
    assert bp.dx_groups * bp.dx_hg >= n > (bp.dx_groups - 1) * bp.dx_hg
    assert bp.dx_threads % 32 == 0 and bp.dx_threads >= 4 * d
    assert bp.scratch >= bp.chunks * n * 2 * d * e
    if bp.dx_groups > 1:
        assert bp.scratch >= bp.dx_groups * r * d
    assert max(bp.smem, bp.finish_smem, bp.dx_smem) <= MAX_SMEM_BYTES


@pytest.mark.parametrize("call, match", [
    (lambda: harmonic.fwd_plan(8, 200, 50, 4), "shared memory"),
    (lambda: harmonic.bwd_plan(8, 66, 1000, 64, False), "shared memory"),
    (lambda: harmonic.bwd_plan(8, 2100, 4, 1, False), "thread limit"),
    (lambda: harmonic.bwd_plan(8, 300, 4, 1, True), "dx kernel"),
])
def test_plans_raise_outside_the_kernels_domain(call, match):
    with pytest.raises(NotImplementedError, match=match):
        call()


def test_dx_limit_applies_only_when_dx_is_asked_for():
    plan = harmonic.bwd_plan(8, 300, 4, 1, False)
    assert plan.dx_blocks == 0 and plan.threads <= harmonic.MAX_THREADS


def test_harmonic_frequencies_double_exactly():
    """f_i = fl32(omega0 * 2**i) is exactly f_0 * 2**i; the port's buffer is
    the frequencies the JAX kernel takes (pallas_harmonic.py's
    ``omega0 * 2.0 ** np.arange(n)`` in float32)."""
    for omega0 in (0.1, 1.0, 0.3):
        f = harmonic_frequencies(64, omega0).numpy()
        assert f.dtype == np.float32
        np.testing.assert_array_equal(
            f, np.ldexp(f[0], np.arange(64)).astype(np.float32))
        np.testing.assert_array_equal(
            f, (omega0 * (2.0 ** np.arange(64))).astype(np.float32))


def test_every_harmonic_argument_is_the_first_scaled():
    """fl32(x * f_i) == fl32(x * f_0) * 2**i bit for bit, for inputs from a
    seed across the training input range (pose coordinates in mm times
    input_scale 1e-3) and beyond, outside subnormals and overflow: every
    harmonic of one input shares one 24-bit mantissa."""
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.uniform(-3.0, 3.0, 100_000),
        rng.standard_normal(10_000) * 1e-3,
        rng.uniform(-1e4, 1e4, 10_000),
    ]).astype(np.float32)
    f = harmonic_frequencies(64, 0.1).numpy()
    a0 = x * f[0]
    for i in range(64):
        ai = x * f[i]
        ok = np.isfinite(ai) & (np.abs(a0) >= np.finfo(np.float32).tiny)
        np.testing.assert_array_equal(
            ai[ok].view(np.uint32),
            np.ldexp(a0[ok], i).astype(np.float32).view(np.uint32))

"""The control comes out not correct: the reference put in the program's
place, one precision below the configuration's float32 with TF32 off.
On the CPU, TF32 is emulated by rounding every forward matmul's and
convolution's operands to TF32's 10-bit mantissa; on a card (``card`` marker) it is the
card's own TF32."""

import pytest
import torch

from conftest import SEED, SMALL

from bench_h100 import checks, harness
from bench_h100.reference import convmixer
import torch.nn.functional as F


def tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to TF32 (round to nearest even on the 13 bits
    dropped); the gradient passes through unrounded."""
    if t is None or t.dtype != torch.float32:
        return t
    i = t.detach().contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return t + (i.view(torch.float32) - t.detach())


class TF32Functional:
    """``torch.nn.functional`` with linear and conv2d on TF32 operands."""

    def __getattr__(self, name):
        return getattr(F, name)

    @staticmethod
    def linear(x, w, b=None):
        return F.linear(tf32(x), tf32(w), b)

    @staticmethod
    def conv2d(x, w, b=None, *args, **kw):
        return F.conv2d(tf32(x), tf32(w), b, *args, **kw)


def _state(cell, device):
    r = harness.resolve(harness.load_benchmark(), cell)
    r.config.update(SMALL["config"])
    r.traffic.update(SMALL["traffic"])
    import tempfile
    from types import SimpleNamespace

    drv = harness.driver_module(r.driver)
    tmp = tempfile.TemporaryDirectory()
    ctx = SimpleNamespace(workload=cell, config=r.config, traffic=r.traffic,
                          seed=SEED, device=device, seconds=1.0, trace=False,
                          tmp=tmp.name)
    state = drv.setup(ctx)
    drv.window(state, 0.01, False)
    return drv, state, tmp


def _fails(readings: dict, cell: str) -> bool:
    limits = checks.limits_for(cell)
    return any(readings[k] > limits[k] for k in limits)


@pytest.mark.parametrize("cell", ["flagship.train", "autoreg.train_closed_loop"])
def test_training_control_on_the_cpu(cell, monkeypatch):
    from bench_h100.drivers import train_epochs

    drv, state, tmp = _state(cell, torch.device("cpu"))
    with tmp:
        late = train_epochs.late_step(state)
        drv.free_program(state)
        ref = train_epochs.reference_run(state, late)
        monkeypatch.setattr(convmixer, "F", TF32Functional())
        ctl = train_epochs.reference_run(state, late)
    p0 = state.check["params0"]
    program = train_epochs.numbers(state.program, late, ref, p0)
    control = train_epochs.numbers(*train_epochs.as_program(ctl), ref, p0)
    assert not _fails(program, cell)
    assert _fails(control, cell), control


@pytest.mark.card
@pytest.mark.parametrize("cell", ["flagship.train", "autoreg.train_closed_loop"])
def test_control_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from motionmixerconv_tpu_torch.serving import resolve_device

    drv, state, tmp = _state(cell, resolve_device("cuda"))
    with tmp:
        out = drv.control_readings(state)
    assert not _fails(out["program"], cell)
    assert _fails(out["control"], cell), out["control"]

"""The plain reference against the port on the CPU at a small size: the
data set-up (bit for bit), the forward, the closed-loop rollout, and the
first training steps and validation of each training cell."""

import numpy as np
import pytest
import torch

from conftest import SEED, SMALL

from bench_h100 import corpus, harness
from bench_h100.drivers import train_epochs
from bench_h100.reference import convmixer, h36m as ref_h36m


def config(cell):
    c = harness.resolve(harness.load_benchmark(), cell).config
    c.update(SMALL["config"])
    return c


def test_data_setup_is_the_ports_bit_for_bit(tmp_path):
    from motionmixerconv_tpu_torch.data import H36MDataset

    raw = corpus.split_sequences(SEED, 0, 400, ("walking", "eating"))
    corpus.write_csv(str(tmp_path), raw)
    ds = H36MDataset(str(tmp_path), 10, 25, 5, actions=["walking", "eating"],
                     split=0, mode="xyz")
    frames, starts = ref_h36m.xyz_corpus([r[3] for r in raw], 35, 5)
    assert np.array_equal(ds.frames, frames)
    assert np.array_equal(ds.window_starts, starts)
    assert np.array_equal(np.asarray(ds.dim_used), ref_h36m.DIM_USED_XYZ)


@pytest.mark.parametrize("cell", ["flagship.train", "autoreg.train_closed_loop"])
def test_forward(cell):
    c = config(cell)
    cfg = train_epochs.model_cfg(c)
    p = convmixer.init_params(cfg, SEED, "cpu")
    model = train_epochs.build_program_model(c, p, torch.device("cpu")).eval()
    x = torch.randn(7, 10, 66, generator=torch.Generator().manual_seed(1))
    x = x * c["input_scale"] * 300
    with torch.no_grad():
        got, want = model(x), convmixer.forward(p, x, cfg)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_train_mode_forward_draws_the_same_dropout_masks():
    c = config("flagship.train")
    cfg = train_epochs.model_cfg(c)
    p = convmixer.init_params(cfg, SEED, "cpu")
    model = train_epochs.build_program_model(c, p, torch.device("cpu")).train()
    x = torch.rand(5, 10, 66)
    torch.manual_seed(3)
    got = model(x)
    torch.manual_seed(3)
    want = convmixer.forward(p, x, cfg, train=True)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_rollout_against_the_ports_predictor():
    from motionmixerconv_tpu_torch.serving import Predictor

    c = config("autoreg.train_closed_loop")
    cfg = train_epochs.model_cfg(c)
    p = convmixer.init_params(cfg, SEED, "cpu")
    pred = Predictor(train_epochs.build_program_model(c, p, torch.device("cpu")),
                     device="cpu")
    x = torch.randn(3, 10, 66) * 200
    got = pred.predict_autoregressive(x, horizon=25)
    want = convmixer.rollout(lambda w: convmixer.forward(p, w, cfg), x, 5, 5)
    assert got.shape == want.shape == (3, 25, 66)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("cell", ["flagship.train", "autoreg.train_closed_loop"])
def test_first_steps_test_and_late_step(cell):
    """The training driver's own comparison, small: every number a fifth of its
    limit or less."""
    out = harness.run_cell(cell, SEED, 0.01, False, torch.device("cpu"), 0.0,
                           overrides=SMALL)
    limits = {k: lim for k, _, lim in out["rows"]}
    for name, value, _ in out["rows"]:
        assert value < limits[name] / 5, (name, value)
    assert out["result"]["correct"]

"""The port's MlpMixer and kernel B4 on the CPU, against the reference
goldens and the JAX package: strict loading of reference state_dicts, the
forward of every block variant against the flax module, the 1-D BatchNorm's
running statistics, the 30-step training trajectories of
tests/golden/train_parity.npz, and B4's plain version (from the port's
packed weights, with the BatchNorm folds) against the JAX package's
FusedMlpMixer in interpret mode and the flax forward.

The CUDA kernel itself runs only on a card; ``chip_smoke.py`` holds it
against this plain version there.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionmixerconv_tpu.models import MlpMixer as JaxMlpMixer
from motionmixerconv_tpu.models.torch_io import export_mlp_mixer
from motionmixerconv_tpu.ops.pallas_mixer import FusedMlpMixer as JaxFused
from motionmixerconv_tpu.train import Trainer as JaxTrainer
from motionmixerconv_tpu.train import make_optimizer as jax_make_optimizer
from motionmixerconv_tpu.train.state import TrainState
from motionmixerconv_tpu_torch.models import (MixerBlockChannel,
                                              MixerBlockToken, MlpMixer,
                                              state_dict_from_jax)
from motionmixerconv_tpu_torch.models.common import BatchNorm1d
from motionmixerconv_tpu_torch.ops import mlp_mixer
from motionmixerconv_tpu_torch.train import Trainer, make_optimizer

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests compute small tensors, which one intra-op thread does as
    fast as eight; the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden(name, prefix="sd::"):
    g = np.load(os.path.join(GOLDEN, name))
    sd = {k[len(prefix):]: torch.from_numpy(g[k]) for k in g.files
          if k.startswith(prefix)}
    return g, sd


# tests/test_models.py TestMlpMixerParity configurations
GOLDEN_CASES = {
    "model_mlp_mixer.npz": dict(
        num_classes=66, num_blocks=2, hidden_dim=50, tokens_mlp_dim=20,
        channels_mlp_dim=50, seq_len=10, pred_len=25, activation="mish",
        regularization=0.1, input_size=66, r_se=8, use_se=True),
    "model_mlp_mixer_bn.npz": dict(
        num_classes=48, num_blocks=2, hidden_dim=60, tokens_mlp_dim=40,
        channels_mlp_dim=60, seq_len=10, pred_len=10, activation="gelu",
        regularization=-1.0, input_size=48, r_se=4, use_se=True),
}


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_golden_strict_load_and_forward(name):
    """The reference state_dict loads strictly and the eval forward equals
    the reference's output (atol 2e-5, as tests/test_models.py)."""
    g, sd = _golden(name)
    model = MlpMixer(**GOLDEN_CASES[name])
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(g["x"])).numpy()
    np.testing.assert_allclose(got, g["out"], atol=2e-5)
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(v.numel() for k, v in sd.items()
                           if "running" not in k and "num_batches" not in k)


@pytest.mark.parametrize("variant", ["tok", "ch"])
def test_variant_blocks_match_golden(variant):
    """The reference's token-only (x + 2 * se(...)) and channel-only
    (leading x + se(x)) blocks, strict load, atol 2e-5."""
    g, sd = _golden("mixer_variants.npz", f"{variant}::")
    if variant == "tok":
        block = MixerBlockToken(20, 10, 50, "gelu", 0.0, 4, use_se=True)
    else:
        block = MixerBlockChannel(30, 10, 50, "gelu", 0.0, 4, use_se=True)
    block.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = block.eval()(torch.from_numpy(g["x"])).numpy()
    np.testing.assert_allclose(got, g[f"out_{variant}"], atol=2e-5)


def _cfg(**kw):
    """tests/test_pallas.py ``_case`` defaults."""
    cfg = dict(num_classes=66, num_blocks=2, hidden_dim=50, tokens_mlp_dim=20,
               channels_mlp_dim=50, seq_len=10, pred_len=25,
               activation="gelu", regularization=0.1, input_size=66, r_se=4,
               use_se=True, use_max_pooling=False, mlp_block_type="normal")
    cfg.update(kw)
    return cfg


def _flax(cfg, batch=37, warm_bn=None):
    """The flax model, its variables (BatchNorm stats warmed as
    tests/test_pallas.py warms them) as numpy, x, and the flax output."""
    jmodel = JaxMlpMixer(**cfg)
    rs = np.random.RandomState(0)
    x = (rs.randn(batch, cfg["seq_len"], cfg["input_size"]) * 0.5).astype(
        np.float32)
    variables = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(x),
                            training=False)
    if warm_bn is None:
        warm_bn = cfg["regularization"] == -1.0
    if warm_bn:
        for i in range(3):
            _, upd = jmodel.apply(variables, jnp.asarray(x) + 0.1 * i,
                                  training=True, mutable=["batch_stats"])
            variables = {**variables, "batch_stats": upd["batch_stats"]}
    variables = jax.tree_util.tree_map(np.asarray, variables)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), training=False))
    return jmodel, variables, x, want


def _port(cfg, variables):
    model = MlpMixer(**cfg)
    model.load_state_dict(state_dict_from_jax(variables, cfg["num_blocks"]),
                          strict=True)
    return model.eval()


FLAX_CASES = {
    f"{bt}_se{int(se)}": _cfg(mlp_block_type=bt, use_se=se)
    for bt in ("normal", "channel_only", "token_only") for se in (True, False)
}
FLAX_CASES.update({
    "batchnorm": _cfg(regularization=-1.0),
    "max_pool_bn_mish": _cfg(regularization=-1.0, use_max_pooling=True,
                             activation="mish"),
    "token_only_bn_max_pool": _cfg(regularization=-1.0, use_max_pooling=True,
                                   mlp_block_type="token_only"),
})


@pytest.mark.parametrize("name", sorted(FLAX_CASES))
def test_forward_matches_flax(name):
    """The port's forward against the flax forward on exported weights,
    every block variant with SE on and off, BatchNorm (warmed stats) and
    max-pool SE; atol 2e-5 (float32 sums in another order)."""
    cfg = FLAX_CASES[name]
    _, variables, x, want = _flax(cfg, batch=5)
    with torch.no_grad():
        got = _port(cfg, variables)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("name", ["normal_se1", "batchnorm"])
def test_state_dict_from_jax_equals_export(name):
    """The port's own export equals the JAX package's export_mlp_mixer."""
    cfg = FLAX_CASES[name]
    _, variables, _, _ = _flax(cfg, batch=2)
    want = export_mlp_mixer(variables, cfg["num_blocks"])
    got = state_dict_from_jax(variables, cfg["num_blocks"])
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    assert got["conv.weight"].shape == (50, 1, 1, 66)
    assert got["conv_out.weight"].shape == (25, 10, 1)
    assert "Mixer_Block.0.se.excitation.0.weight" in got


def test_batchnorm1d_running_stats_match_flax():
    """One train step of the BatchNorm MlpMixer (regularization -1), port
    against JAX from the same init: every 1-D BatchNorm's running mean and
    variance agree to 1e-6 relative to the tensor's largest element (torch's
    own BatchNorm1d moves running_var with the unbiased variance and would
    not), and so does the loss."""
    cfg = _cfg(regularization=-1.0, num_classes=12, input_size=12,
               hidden_dim=16, tokens_mlp_dim=8, channels_mlp_dim=16,
               pred_len=5, num_blocks=1)
    jmodel, variables, _, _ = _flax(cfg, batch=2, warm_bn=False)
    rs = np.random.RandomState(5)
    frames = (rs.randn(6 * 15, 12) * 0.5).astype(np.float32)
    starts = np.arange(6, dtype=np.int64) * 15
    geometry = dict(dim_used=np.arange(12), input_n=10, output_n=5)

    jopt = jax_make_optimizer(lr=1e-3, use_scheduler=False)
    jtr = JaxTrainer(jmodel, jopt, loss_type="mpjpe", **geometry)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=variables["batch_stats"],
                       opt_state=jopt.init(params), rng=jax.random.PRNGKey(0))
    state, jloss = jtr._train_step(state, jnp.asarray(frames),
                                   jnp.asarray(starts, jnp.int32),
                                   jnp.ones(6, jnp.float32))
    want = {k: v for k, v in export_mlp_mixer(
        jax.tree_util.tree_map(np.asarray, {"params": state.params,
                                            "batch_stats": state.batch_stats}),
        1).items() if k.endswith(("running_mean", "running_var"))}

    model = _port(cfg, variables).train()
    assert sum(isinstance(m, BatchNorm1d) for m in model.modules()) == 4
    trainer = Trainer(model, make_optimizer(model.parameters(), lr=1e-3,
                                            use_scheduler=False),
                      loss_type="mpjpe", **geometry)
    loss = trainer.train_step(torch.from_numpy(frames),
                              torch.from_numpy(starts), torch.ones(6))
    got = model.state_dict()
    assert len(want) == 8
    for k, v in want.items():
        err = np.abs(got[k].numpy() - v).max() / np.abs(v).max()
        assert err <= 1e-6, (k, err)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)


# ------------------------------------------------------------------- B4

# tests/test_pallas.py's cases: (config, Pallas block_b)
B4_CASES = {
    **{f"{act}_se{int(se)}": (_cfg(activation=act, use_se=se), 16)
       for act in ("gelu", "mish") for se in (True, False)},
    "amass_3_blocks": (_cfg(num_blocks=3, hidden_dim=128, tokens_mlp_dim=20,
                            channels_mlp_dim=128, num_classes=54,
                            input_size=54, r_se=8), 8),
    "batchnorm": (_cfg(regularization=-1.0), 8),
    "max_pool": (_cfg(use_max_pooling=True), 8),
    "max_pool_bn_mish": (_cfg(activation="mish", use_max_pooling=True,
                              regularization=-1.0), 8),
    **{f"{bt}_se{int(se)}": (_cfg(mlp_block_type=bt, use_se=se), 8)
       for bt in ("channel_only", "token_only") for se in (True, False)},
    "channel_only_bn_mish": (_cfg(activation="mish", regularization=-1.0,
                                  mlp_block_type="channel_only"), 8),
    "token_only_bn_max_pool": (_cfg(regularization=-1.0, use_max_pooling=True,
                                    mlp_block_type="token_only"), 8),
}


@pytest.mark.parametrize("name", sorted(B4_CASES))
def test_b4_plain_matches_pallas_and_flax(name):
    """B4's plain version, from the port's packed weights (BatchNorm folded
    in torch from the module's buffers), against the JAX FusedMlpMixer in
    interpret mode and the flax forward: atol 2e-4, tests/test_pallas.py's
    tolerance (its in-kernel erf is a polynomial)."""
    cfg, block_b = B4_CASES[name]
    jmodel, variables, x, want = _flax(cfg)
    pallas = np.asarray(JaxFused(jmodel, variables)(
        jnp.asarray(x), block_b=block_b, interpret=True))
    fused = mlp_mixer.make_fused_mlp_mixer(_port(cfg, variables))
    got = fused(torch.from_numpy(x)).numpy()
    assert got.shape == (37, cfg["pred_len"], cfg["num_classes"])
    np.testing.assert_allclose(got, pallas, atol=2e-4)
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_b4_wrapper_runs_plain_on_the_cpu_and_checks_inputs():
    """On the CPU the wrapper runs the plain version and launches nothing;
    it refuses the wrong type, shape or device instead of guessing."""
    cfg = _cfg(num_blocks=1, hidden_dim=16, tokens_mlp_dim=8,
               channels_mlp_dim=16)
    model = MlpMixer(**cfg, generator=torch.Generator().manual_seed(0)).eval()
    fused = mlp_mixer.FusedMlpMixer(model)
    spec, w = fused.spec, fused.weights
    assert (spec.block_type, spec.S, w.numel()) == ("normal", 2, spec.numel())
    x = torch.randn(3, 10, 66)
    before = (mlp_mixer.PLAIN_CALLS.value, mlp_mixer.LAUNCHES.value)
    got = mlp_mixer.mlp_mixer_fused(x, w, spec)
    assert (mlp_mixer.PLAIN_CALLS.value, mlp_mixer.LAUNCHES.value) == (
        before[0] + 1, before[1])
    with torch.no_grad():
        torch.testing.assert_close(got, model(x), rtol=0, atol=2e-5)
    with pytest.raises(TypeError):
        mlp_mixer.mlp_mixer_fused(x.double(), w, spec)
    with pytest.raises(ValueError):
        mlp_mixer.mlp_mixer_fused(x[:, :9].contiguous(), w, spec)
    with pytest.raises(ValueError):
        mlp_mixer.mlp_mixer_fused(x.transpose(0, 1), w, spec)
    with pytest.raises(RuntimeError, match="no kernel"):
        mlp_mixer.mlp_mixer_fused(x.to("meta"), w.to("meta"), spec)


def test_b4_activations_move_to_device_memory_when_they_outgrow_smem():
    """A sample's activations sit in shared memory up to one block's
    232,448 bytes and in a device scratch buffer above; the function is the
    same (plain version against the module at a long window)."""
    amass = mlp_mixer.FusedMlpMixer(MlpMixer(**_cfg(
        hidden_dim=128, tokens_mlp_dim=20, channels_mlp_dim=128,
        num_classes=54, input_size=54, r_se=8, num_blocks=1)))
    # the SE squeeze (T, padded to 16 bytes), y and z (T, H), the (P, H)
    # upsample buffer, the split-K partials; then two weight buffers for
    # the largest matrix, channel fc1 (128, 128), after the two mbarriers
    act = 12 + 2 * 10 * 128 + 25 * 128 + mlp_mixer.PART_FLOATS
    assert amass.spec.sample_floats() == act
    assert amass.spec.wbuf_floats() == 128 * 128
    assert amass.spec.nbufs() == 2
    assert amass.spec.smem_bytes() == 4 * (4 + act + 2 * 128 * 128)
    assert not amass.spec.uses_scratch
    cfg = _cfg(seq_len=240, pred_len=40, num_blocks=1, hidden_dim=128,
               tokens_mlp_dim=16, channels_mlp_dim=16)
    model = MlpMixer(**cfg, generator=torch.Generator().manual_seed(1)).eval()
    fused = mlp_mixer.FusedMlpMixer(model)
    assert fused.spec.uses_scratch
    # only the mbarriers and the weight buffers: the largest matrix, the
    # (T, P) time upsample, twice
    assert fused.spec.smem_bytes() == 4 * (4 + 2 * 240 * 40)
    x = torch.randn(2, 240, 66) * 0.5
    with torch.no_grad():
        torch.testing.assert_close(fused(x), model(x), rtol=0, atol=2e-5)


def test_b4_domain_and_dtype_refusals(monkeypatch):
    model = MlpMixer(**_cfg(num_blocks=1, hidden_dim=8, tokens_mlp_dim=4,
                            channels_mlp_dim=8))
    monkeypatch.setattr(mlp_mixer, "_INT_MAX", 1000)
    with pytest.raises(NotImplementedError, match="32-bit"):
        mlp_mixer.make_fused_mlp_mixer(model)
    monkeypatch.undo()
    # a bf16 model's weights are float32: B4 serves them as the float32
    # model's (the JAX Predictor's route), the same answers
    m32 = MlpMixer(**_cfg(), generator=torch.Generator().manual_seed(0))
    m16 = MlpMixer(**_cfg(), dtype=torch.bfloat16)
    m16.load_state_dict(m32.state_dict())
    x = torch.randn(3, 10, 66) * 0.5
    torch.testing.assert_close(mlp_mixer.make_fused_mlp_mixer(m16)(x),
                               mlp_mixer.make_fused_mlp_mixer(m32)(x),
                               rtol=0, atol=0)


# ------------------------------------------------- training trajectories

def _mlp_golden_model(g):
    model = MlpMixer(num_classes=54, num_blocks=3, hidden_dim=64,
                     tokens_mlp_dim=20, channels_mlp_dim=64, seq_len=10,
                     pred_len=25, activation="gelu", regularization=0.0,
                     input_size=54, r_se=8, use_se=True)
    model.load_state_dict({k[len("mlp_init::"):]: torch.from_numpy(g[k])
                           for k in g.files if k.startswith("mlp_init::")},
                          strict=True)
    return model


def _golden_steps(g, model, opt):
    n_steps, b, t, d = g["mlp_batches"].shape
    frames = torch.from_numpy(g["mlp_batches"].reshape(-1, d))
    starts = torch.arange(n_steps * b).reshape(n_steps, b) * t
    trainer = Trainer(model, opt, loss_type="mpjpe", dim_used=np.arange(54),
                      input_n=10, output_n=25, input_scale=1.0,
                      loss_scale=1000.0)
    model.train()
    return [float(trainer.train_step(frames, starts[i], torch.ones(b)))
            for i in range(n_steps)]


@pytest.fixture(scope="module")
def parity():
    return np.load(os.path.join(GOLDEN, "train_parity.npz"))


def test_mlp_mixer_30step_trajectory(parity):
    """The AMASS-style MlpMixer (x1000 loss, unscaled input) through the
    port's Trainer from the reference's init: per-step losses to rtol 1e-4
    across both MultiStepLR boundaries, and the final parameters (p99 of
    |diff| < 1e-5, as tests/test_train_parity.py)."""
    g = parity
    model = _mlp_golden_model(g)
    opt = make_optimizer(model.parameters(), lr=float(g["lr"]),
                         weight_decay=1e-5,
                         milestones=[int(m) for m in g["milestones"]],
                         gamma=float(g["gamma"]),
                         steps_per_epoch=int(g["steps_per_epoch"]))
    losses = _golden_steps(g, model, opt)
    np.testing.assert_allclose(losses, g["mlp_losses"], rtol=1e-4)
    final = model.state_dict()
    diffs = np.concatenate([
        np.abs(final[k[len("mlp_final::"):]].numpy() - g[k]).ravel()
        for k in g.files if k.startswith("mlp_final::")])
    assert np.percentile(diffs, 99) < 1e-5
    assert diffs.max() < 5e-3


def test_mlp_mixer_coupled_weight_decay_trajectory(parity):
    """At wd 1e-2 the port's Adam(weight_decay) is torch's coupled L2:
    rtol 5e-5 against the reference's losses, which decoupled AdamW
    misses."""
    g = parity
    model = _mlp_golden_model(g)
    opt = make_optimizer(model.parameters(), lr=float(g["lr"]),
                         weight_decay=float(g["wd_large"]),
                         use_scheduler=False)
    np.testing.assert_allclose(_golden_steps(g, model, opt),
                               g["mlp_wd_losses"], rtol=5e-5)

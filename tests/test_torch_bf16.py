"""The models' compute dtype (``dtype=torch.bfloat16``) on the CPU against
the JAX package's ``dtype=jnp.bfloat16``: from weights carried across by
``state_dict_from_jax``, each bf16 forward within 2e-2 of the largest
reference value of JAX's bf16 forward, and within 0.05 of its own float32
forward (JAX's own bound, tests/test_models.py:153-186); float32
parameters and a bf16 output; the fused encoder's refusal; one bf16
training epoch against JAX's at rtol 2e-2, with float32 losses.

The two frameworks round bf16 at other places (a product's and its bias
add's outputs, the activations' internals), hence 2e-2 rather than a few
ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionmixerconv_tpu.models import ConvEncoder as JaxConvEncoder
from motionmixerconv_tpu.models import ConvMixer as JaxConvMixer
from motionmixerconv_tpu.models import MlpMixer as JaxMlpMixer
from motionmixerconv_tpu.train import Trainer as JaxTrainer
from motionmixerconv_tpu.train import make_optimizer as jax_make_optimizer
from motionmixerconv_tpu_torch.data import WindowedCorpus
from motionmixerconv_tpu_torch.models import (ConvEncoder, ConvMixer,
                                              MlpMixer, PoseEncoder,
                                              state_dict_from_jax)
from motionmixerconv_tpu_torch.train import Trainer, make_optimizer

TOL_JAX = 2e-2   # of max|JAX bf16 forward|
TOL_F32 = 0.05   # of max|float32 forward|, JAX's bound
BF16 = torch.bfloat16

# JAX tests/test_models.py test_bfloat16_compute_dtype's flagship layout
CONV = dict(
    num_blocks=2, dimPosIn=66, dimPosEmb=50, dimPosOut=66, in_nTP=10,
    out_nTP=25, conv_nChan=1, conv1_kernel_shape=(1, 3), conv1_stride=(1, 1),
    conv1_padding=(0, 1), mode_conv="twice", activation="mish",
    regularization=0.1, use_se=True, r_se=8, encoder_n_harmonic_functions=8,
    encoder_omega0=0.1)
MLP = dict(
    num_classes=54, num_blocks=2, hidden_dim=64, tokens_mlp_dim=20,
    channels_mlp_dim=64, seq_len=10, pred_len=25, activation="gelu",
    regularization=0.1, input_size=54, use_se=True)
CONV_BN = dict(CONV, conv_nChan=3, conv1_kernel_shape=(3, 3),
               conv1_padding=None, regularization=-1.0)
CASES = {"conv_mixer": (JaxConvMixer, ConvMixer, CONV, 66),
         "mlp_mixer": (JaxMlpMixer, MlpMixer, MLP, 54),
         "conv_mixer_batchnorm": (JaxConvMixer, ConvMixer, CONV_BN, 66)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_variables(jcls, cfg, x, key=0):
    variables = jcls(**cfg).init(jax.random.PRNGKey(key), jnp.asarray(x),
                                 training=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    if "batch_stats" in variables:  # running stats away from (0, 1)
        rs = np.random.RandomState(key + 1)
        variables["batch_stats"] = jax.tree_util.tree_map(
            lambda a: (rs.uniform(0.5, 1.5, a.shape) if a.mean() > 0.5
                       else rs.uniform(-0.5, 0.5, a.shape)).astype(a.dtype),
            variables["batch_stats"])
    return variables


def _port(tcls, cfg, variables, dtype=None):
    model = tcls(**cfg, dtype=dtype)
    model.load_state_dict(state_dict_from_jax(
        variables, cfg["num_blocks"],
        cfg.get("encoder_n_harmonic_functions", 0),
        cfg.get("encoder_omega0", 0.1)), strict=True)
    return model.eval()


@pytest.mark.parametrize("case", CASES)
def test_bf16_forward_matches_jax(case):
    jcls, tcls, cfg, d = CASES[case]
    x = (np.random.RandomState(0).randn(6, 10, d) * 0.5).astype(np.float32)
    variables = _jax_variables(jcls, cfg, x)
    want = np.asarray(jcls(**cfg, dtype=jnp.bfloat16).apply(
        variables, jnp.asarray(x), training=False), np.float32)
    m16 = _port(tcls, cfg, variables, BF16)
    m32 = _port(tcls, cfg, variables)
    with torch.no_grad():
        y16 = m16(torch.from_numpy(x))
        y32 = m32(torch.from_numpy(x)).numpy()
    assert y16.dtype == BF16
    assert {p.dtype for p in m16.parameters()} == {torch.float32}
    y16 = y16.float().numpy()
    assert np.abs(y16 - want).max() <= TOL_JAX * np.abs(want).max()
    assert np.abs(y16 - y32).max() <= TOL_F32 * np.abs(y32).max()


def test_bf16_conv_encoder_matches_jax():
    B, T, D, E, C = 4, 10, 66, 50, 3
    x = np.random.RandomState(7).randn(B, T, D).astype(np.float32)
    jenc = JaxConvEncoder(dimPosIn=D, dimPosEmb=E, conv_nChan=C,
                          dtype=jnp.bfloat16)
    params = jax.tree_util.tree_map(np.asarray, jenc.init(
        jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(jenc.apply(params, jnp.asarray(x)), np.float32)
    f32 = np.asarray(JaxConvEncoder(dimPosIn=D, dimPosEmb=E, conv_nChan=C)
                     .apply(params, jnp.asarray(x)))
    p = params["params"]
    enc = ConvEncoder(dimPosIn=D, dimPosEmb=E, conv_nChan=C, dtype=BF16)
    assert isinstance(enc, PoseEncoder)
    enc.load_state_dict({
        "embed_mlp.weight": torch.from_numpy(p["embed_mlp"]["kernel"].T.copy()),
        "embed_mlp.bias": torch.from_numpy(p["embed_mlp"]["bias"]),
        "channelUpscaling.weight": torch.from_numpy(
            p["channelUpscaling"]["kernel"].T.copy()),
        "channelUpscaling.bias": torch.from_numpy(
            p["channelUpscaling"]["bias"])}, strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    assert got.dtype == BF16 and got.shape == (B, T, E, C)
    got = got.float().numpy()
    assert np.abs(got - want).max() <= TOL_JAX * np.abs(want).max()
    assert np.abs(got - f32).max() <= TOL_F32 * np.abs(f32).max()


def test_bf16_train_mode_batchnorm_statistics_in_float32():
    """Train-mode BatchNorm under bf16 takes float32 statistics and keeps
    float32 running stats; its output is bf16."""
    model = ConvMixer(**CONV_BN, dtype=BF16).train()
    x = torch.randn(6, 10, 66) * 0.5
    y = model(x)
    assert y.dtype == BF16
    bn = model.Mixer_Block[0].conv1.reg
    assert bn.running_mean.dtype == torch.float32
    assert not torch.equal(bn.running_mean, torch.zeros_like(bn.running_mean))


def test_fused_encoder_refuses_a_compute_dtype():
    with pytest.raises(ValueError, match="f32-only"):
        PoseEncoder(dimPosIn=6, dimPosEmb=8, n_harmonic_functions=4,
                    fused=True, dtype=BF16)
    with pytest.raises(ValueError, match="f32-only"):
        ConvMixer(**CONV, encoder_fused=True, dtype=BF16)
    # no harmonics: nothing is fused, as in the JAX PoseEncoder
    PoseEncoder(dimPosIn=6, dimPosEmb=8, n_harmonic_functions=0, fused=True,
                dtype=BF16)


def test_bf16_training_epoch_matches_jax():
    """One epoch of the bf16 ConvMixer (dropout off) and its validation,
    the port's Trainer against JAX's from one init: rtol 2e-2; the
    losses are Python floats from float32 sums."""
    cfg = dict(CONV, regularization=0.0)
    rs = np.random.RandomState(3)
    frames_h = (rs.randn(200, 66) * 0.5).astype(np.float32)
    corpus = WindowedCorpus(frames_h, np.arange(0, 160, 3, dtype=np.int64),
                            35)
    kw = dict(loss_type="mpjpe", dim_used=np.arange(66), input_n=10,
              output_n=25)
    jtr = JaxTrainer(JaxConvMixer(**cfg, dtype=jnp.bfloat16),
                     jax_make_optimizer(lr=1e-3, steps_per_epoch=10), **kw)
    state = jtr.init_state(jax.random.PRNGKey(0))
    variables = jax.tree_util.tree_map(np.asarray, state.variables())
    model = _port(ConvMixer, cfg, variables, BF16).train()
    tr = Trainer(model, make_optimizer(model.parameters(), lr=1e-3,
                                       steps_per_epoch=10), **kw)
    jframes, frames = jnp.asarray(frames_h), torch.from_numpy(frames_h)
    state, want = jtr.train_epoch(state, corpus, jframes, 16, seed=0)
    got = tr.train_epoch(corpus, frames, 16, seed=0)
    assert isinstance(got, float) and np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=2e-2)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    np.testing.assert_allclose(tr.validate(corpus, frames, 16),
                               jtr.validate(state, corpus, jframes, 16),
                               rtol=2e-2)

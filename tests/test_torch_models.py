"""The PyTorch port's models against the reference goldens and the JAX package.

Inputs come from numpy seeds and go to both packages; weights cross from the
flax variables to the port through ``state_dict_from_jax`` and are loaded
with ``strict=True``. Everything runs on the CPU in float32.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionmixerconv_tpu.models import ConvMixer as JaxConvMixer
from motionmixerconv_tpu.models import PoseEncoder as JaxPoseEncoder
from motionmixerconv_tpu.models import export_conv_mixer
from motionmixerconv_tpu.ops import activations as jax_act
from motionmixerconv_tpu_torch.models import (
    ConvMixer,
    PoseEncoder,
    harmonic_features,
    state_dict_from_jax,
)
from motionmixerconv_tpu_torch.ops import activations as torch_act

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

GOLDEN_CASES = {
    "model_conv_mixer.npz": (dict(
        num_blocks=2, dimPosIn=66, dimPosEmb=50, dimPosOut=66, in_nTP=10,
        out_nTP=25, conv_nChan=1, conv1_kernel_shape=(1, 3),
        conv1_stride=(1, 1), conv1_padding=(0, 1), mode_conv="twice",
        activation="mish", regularization=0.1, use_se=True, r_se=8,
        use_max_pooling=False, encoder_n_harmonic_functions=64,
        encoder_omega0=0.1), 2e-5),
    "model_conv_mixer_once.npz": (dict(
        num_blocks=2, dimPosIn=66, dimPosEmb=40, dimPosOut=66, in_nTP=10,
        out_nTP=10, conv_nChan=2, conv1_kernel_shape=(1, 3),
        conv1_padding=None, mode_conv="once", activation="gelu",
        regularization=0.0, use_se=True, r_se=4,
        encoder_n_harmonic_functions=-1), 2e-5),
    "model_conv_mixer_multichan.npz": (dict(
        num_blocks=2, dimPosIn=54, dimPosEmb=32, dimPosOut=54, in_nTP=10,
        out_nTP=5, conv_nChan=3, conv1_kernel_shape=(5, 9),
        conv1_stride=None, conv1_padding=None, mode_conv="twice",
        activation="gelu", regularization=-1.0, use_se=True, r_se=4,
        use_max_pooling=True, encoder_n_harmonic_functions=8,
        encoder_omega0=0.1), 3e-5),
}


def _load_case(name):
    data = np.load(os.path.join(GOLDEN, name))
    sd = {k[4:]: torch.from_numpy(data[k]) for k in data.files
          if k.startswith("sd::")}
    return sd, data["x"], data["out"]


@pytest.mark.parametrize("name", sorted(GOLDEN_CASES))
def test_golden_strict_load_and_forward(name):
    """Reference state_dicts load strictly (incl. the se2 alias and the
    frequencies buffer) and reproduce the reference output."""
    cfg, atol = GOLDEN_CASES[name]
    sd, x, want = _load_case(name)
    model = ConvMixer(**cfg)
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=atol)


def _flax_case(cfg, batch=6, seed=0, warm_bn=False):
    model = JaxConvMixer(**cfg)
    rs = np.random.RandomState(seed)
    x = (rs.randn(batch, cfg["in_nTP"], cfg["dimPosIn"]) * 0.5).astype(
        np.float32)
    variables = model.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                           training=False)
    if warm_bn:  # non-trivial BatchNorm running stats
        for i in range(3):
            _, upd = model.apply(variables, jnp.asarray(x) + 0.1 * i,
                                 training=True, mutable=["batch_stats"])
            variables = {**variables, "batch_stats": upd["batch_stats"]}
    variables = jax.tree_util.tree_map(np.asarray, variables)
    want = np.asarray(model.apply(variables, jnp.asarray(x), training=False))
    return variables, x, want


def _port_from_flax(cfg, variables):
    model = ConvMixer(**cfg)
    sd = state_dict_from_jax(variables, cfg["num_blocks"],
                             cfg.get("encoder_n_harmonic_functions", 64),
                             cfg.get("encoder_omega0", 0.1))
    model.load_state_dict(sd, strict=True)
    return model.eval()


FLAGSHIP_2B = dict(
    num_blocks=2, dimPosIn=66, dimPosEmb=50, dimPosOut=66, in_nTP=10,
    out_nTP=25, conv_nChan=1, conv1_kernel_shape=(1, 3), conv1_stride=(1, 1),
    conv1_padding=(0, 1), mode_conv="twice", activation="mish",
    regularization=0.1, use_se=True, r_se=8, encoder_n_harmonic_functions=64,
    encoder_omega0=0.1)

FLAX_CASES = {
    "flagship_2blocks_dropout": (FLAGSHIP_2B, False),
    "bn_maxpool": (dict(
        num_blocks=2, dimPosIn=24, dimPosEmb=40, dimPosOut=24, in_nTP=10,
        out_nTP=7, conv_nChan=1, conv1_kernel_shape=(1, 3),
        conv1_padding=None, mode_conv="twice", activation="gelu",
        regularization=-1.0, use_se=True, r_se=2, use_max_pooling=True,
        encoder_n_harmonic_functions=8, encoder_omega0=0.1), True),
    "once_no_harmonics": (dict(
        num_blocks=2, dimPosIn=18, dimPosEmb=16, dimPosOut=18, in_nTP=10,
        out_nTP=10, conv_nChan=1, conv1_kernel_shape=(1, 3),
        mode_conv="once", activation="gelu", regularization=0.0,
        use_se=True, r_se=4, encoder_n_harmonic_functions=-1), False),
    "multichannel_even_kernel": (dict(
        num_blocks=2, dimPosIn=12, dimPosEmb=20, dimPosOut=12, in_nTP=10,
        out_nTP=5, conv_nChan=3, conv1_kernel_shape=(2, 4),
        mode_conv="twice", activation="mish", regularization=-1.0,
        use_se=True, r_se=5, encoder_n_harmonic_functions=6,
        encoder_omega0=0.1), True),
}


@pytest.mark.parametrize("name", sorted(FLAX_CASES))
def test_convmixer_matches_flax(name):
    cfg, warm = FLAX_CASES[name]
    variables, x, want = _flax_case(cfg, warm_bn=warm)
    model = _port_from_flax(cfg, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("name", ["flagship_2blocks_dropout", "bn_maxpool",
                                  "once_no_harmonics"])
def test_state_dict_from_jax_equals_export(name):
    cfg, warm = FLAX_CASES[name]
    variables, _, _ = _flax_case(cfg, warm_bn=warm)
    nh = cfg["encoder_n_harmonic_functions"]
    want = export_conv_mixer(variables, cfg["num_blocks"], nh, 0.1)
    got = state_dict_from_jax(variables, cfg["num_blocks"], nh, 0.1)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # the reference quirks strict loading depends on
    assert ("encoder.frequencies" in got) == (nh > 0)
    assert any(".se2." in k for k in got) == (cfg["mode_conv"] == "twice")


def _enc_case(n, seed=0, rows=(5, 10), d=12, e=16, c=2):
    rs = np.random.RandomState(seed)
    x = (rs.randn(*rows, d) * 0.3).astype(np.float32)
    dim_h = 2 * n * d if n > 0 else d
    p = {"embed_mlp": {"kernel": (rs.randn(dim_h, e) * 0.05).astype(np.float32),
                       "bias": (rs.randn(e) * 0.1).astype(np.float32)},
         "channelUpscaling": {"kernel": rs.randn(1, c).astype(np.float32),
                              "bias": rs.randn(c).astype(np.float32)}}
    sd = {"embed_mlp.weight": torch.from_numpy(p["embed_mlp"]["kernel"].T.copy()),
          "embed_mlp.bias": torch.from_numpy(p["embed_mlp"]["bias"]),
          "channelUpscaling.weight": torch.from_numpy(
              p["channelUpscaling"]["kernel"].T.copy()),
          "channelUpscaling.bias": torch.from_numpy(p["channelUpscaling"]["bias"])}
    return x, {"params": p}, sd


@pytest.mark.parametrize("impl,n", [("direct", 64), ("direct", 0),
                                    ("doubling", 8), ("doubling", 1)])
def test_pose_encoder_matches_jax(impl, n):
    """Doubling is held in the signal band (n = 8): there each package's
    recurrence is within rounding of the other; above it the doubling
    amplifies their 1-ulp differences by 2x per harmonic."""
    x, variables, sd = _enc_case(n)
    kw = dict(dimPosIn=12, dimPosEmb=16, conv_nChan=2, n_harmonic_functions=n,
              omega0=0.1, harmonic_impl=impl)
    want = np.asarray(JaxPoseEncoder(**kw).apply(variables, jnp.asarray(x)))
    enc = PoseEncoder(**kw)
    if n > 0:
        sd["frequencies"] = enc.frequencies
    enc.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (5, 10, 16, 2)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_pose_encoder_precomputed_matches_jax():
    n = 6
    x, variables, sd = _enc_case(n)
    emb = np.asarray(JaxPoseEncoder.harmonic_features(jnp.asarray(x), n, 0.1))
    kw = dict(dimPosIn=12, dimPosEmb=16, conv_nChan=2, n_harmonic_functions=n,
              omega0=0.1, precomputed=True)
    want = np.asarray(JaxPoseEncoder(**kw).apply(variables, jnp.asarray(emb)))
    enc = PoseEncoder(**kw)
    sd["frequencies"] = enc.frequencies
    enc.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(emb)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    # the port's own features equal the JAX cache's input to it
    feats = harmonic_features(torch.from_numpy(x), n, 0.1).numpy()
    np.testing.assert_allclose(feats, emb, atol=1e-6)


def test_pose_encoder_embed_dtype_rounds_storage_only():
    n = 8
    x, variables, sd = _enc_case(n)
    kw = dict(dimPosIn=12, dimPosEmb=16, conv_nChan=2, n_harmonic_functions=n,
              omega0=0.1)
    want = np.asarray(JaxPoseEncoder(**kw, embed_dtype=jnp.bfloat16).apply(
        variables, jnp.asarray(x)))
    enc = PoseEncoder(**kw, embed_dtype=torch.bfloat16)
    sd["frequencies"] = enc.frequencies
    enc.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("kw,match", [
    (dict(fused=True, precomputed=True), "fused=True does not combine"),
    (dict(harmonic_impl="doubling", precomputed=True), "doubling"),
    (dict(fused=True, embed_dtype=torch.bfloat16), "embed_dtype only"),
])
def test_pose_encoder_rejects_incompatible_flags(kw, match):
    with pytest.raises(ValueError, match=match):
        PoseEncoder(dimPosIn=6, dimPosEmb=8, n_harmonic_functions=4, **kw)


def test_compute_dtype_not_ported_yet():
    """The compute dtype is ported (tests/test_torch_bf16.py): the
    parameters stay float32, and the fused encoder refuses it as the JAX
    PoseEncoder does."""
    model = ConvMixer(**FLAGSHIP_2B, dtype=torch.bfloat16)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    with pytest.raises(ValueError, match="f32-only"):
        ConvMixer(**FLAGSHIP_2B, dtype=torch.bfloat16, encoder_fused=True)


def test_unknown_harmonic_impl_rejected():
    with pytest.raises(ValueError, match="unknown harmonic impl"):
        harmonic_features(torch.zeros(2, 3), 4, 0.1, impl="nope")


@pytest.mark.parametrize("name", ["gelu", "mish"])
def test_activations_match_jax(name):
    x = np.linspace(-30, 30, 2001).astype(np.float32)
    want = np.asarray(jax_act.get_activation(name)(jnp.asarray(x)))
    got = torch_act.get_activation(name)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="Unknown activation"):
        torch_act.get_activation("relu6")


def test_seeded_init_bounds_and_param_count():
    """U(+-1/sqrt(fan_in)) from a torch.Generator: the same seed gives the
    same weights, and the parameter count equals the flax model's."""
    a = ConvMixer(**FLAGSHIP_2B, generator=torch.Generator().manual_seed(3))
    b = ConvMixer(**FLAGSHIP_2B, generator=torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.encoder.embed_mlp.weight
    assert float(w.abs().max()) <= 1.0 / np.sqrt(w.shape[1])
    w = a.Mixer_Block[0].conv1.conv.weight
    assert float(w.abs().max()) <= 1.0 / np.sqrt(3)
    variables, _, _ = _flax_case(FLAGSHIP_2B, batch=1)
    n_flax = sum(v.size for v in jax.tree_util.tree_leaves(variables["params"]))
    n_port = sum(p.numel() for p in a.parameters())  # se2 is the same module
    assert n_port == n_flax

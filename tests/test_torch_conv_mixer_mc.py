"""Kernel B3 (the multi-channel ConvMixer core) on the CPU: its plain
version, from the port's packed weights, against the JAX package's
FusedConvMixerMC in interpret mode and against the flax forward; the
factory's routing by conv_nChan; and the checks that keep a non-CPU tensor
away from the plain version.

The CUDA kernel itself runs only on a card; ``chip_smoke.py`` holds it
against this plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionmixerconv_tpu.models import ConvMixer as JaxConvMixer
from motionmixerconv_tpu.ops.pallas_conv_mixer import FusedConvMixerMC as JaxFusedMC
from motionmixerconv_tpu_torch.models import ConvMixer, state_dict_from_jax
from motionmixerconv_tpu_torch.ops import _build, conv_mixer, conv_mixer_mc


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests compute small tensors, which one intra-op thread does as
    fast as eight; the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    """tests/test_pallas_conv.py ``_case`` defaults."""
    cfg = dict(
        num_blocks=2, dimPosIn=66, dimPosEmb=50, dimPosOut=66, in_nTP=10,
        out_nTP=25, conv_nChan=4, conv1_kernel_shape=(1, 3),
        conv1_stride=(1, 1), conv1_padding=None, mode_conv="twice",
        activation="mish", regularization=0.1, use_se=True, r_se=2,
        use_max_pooling=False, encoder_n_harmonic_functions=8,
        encoder_omega0=0.1)
    cfg.update(kw)
    return cfg


# name -> (config overrides, batch, atol against the Pallas kernel); the
# cases and tolerances of tests/test_pallas_conv.py:73-127
MC_CASES = {
    "study_shape": (dict(conv_nChan=8, dimPosEmb=192, conv1_kernel_shape=(5, 9),
                         num_blocks=6, activation="gelu"), 9, 1e-3),
    "k13": (dict(dimPosEmb=40, conv1_kernel_shape=(1, 3)), 11, 5e-4),
    "k929": (dict(dimPosEmb=40, conv1_kernel_shape=(9, 29)), 11, 5e-4),
    "even_k24": (dict(dimPosEmb=40, conv1_kernel_shape=(2, 4)), 11, 5e-4),
    "once_no_se": (dict(conv_nChan=3, mode_conv="once", activation="gelu",
                        use_se=False, encoder_n_harmonic_functions=-1,
                        dimPosEmb=33), 5, 5e-4),
    "batchnorm_c8": (dict(conv_nChan=8, regularization=-1.0,
                          activation="gelu", dimPosEmb=40), 9, 5e-4),
    "max_pool_se_c8": (dict(conv_nChan=8, use_max_pooling=True,
                            dimPosEmb=40), 9, 5e-4),
    "bn_max_pool_once": (dict(conv_nChan=4, regularization=-1.0,
                              use_max_pooling=True, mode_conv="once",
                              activation="gelu", dimPosEmb=33), 5, 5e-4),
}


def _case(name):
    """The flax model, its variables (BatchNorm stats warmed as the JAX
    kernel test warms them), the port model loaded from them, and x."""
    over, batch, atol = MC_CASES[name]
    cfg = _cfg(**over)
    rs = np.random.RandomState(0)
    x = (rs.randn(batch, cfg["in_nTP"], cfg["dimPosIn"]) * 0.5).astype(np.float32)
    jmodel = JaxConvMixer(**cfg)
    variables = jmodel.init(jax.random.PRNGKey(4), jnp.asarray(x), training=False)
    if cfg["regularization"] == -1.0:
        for i in range(3):
            _, upd = jmodel.apply(variables, jnp.asarray(x) + 0.1 * i,
                                  training=True, mutable=["batch_stats"])
            variables = {**variables, "batch_stats": upd["batch_stats"]}
    variables = jax.tree_util.tree_map(np.asarray, variables)
    model = ConvMixer(**cfg)
    model.load_state_dict(state_dict_from_jax(
        variables, cfg["num_blocks"], cfg["encoder_n_harmonic_functions"],
        cfg["encoder_omega0"]), strict=True)
    return jmodel, variables, model.eval(), x, atol


@pytest.mark.parametrize("name", sorted(MC_CASES))
def test_conv_mixer_mc_plain_matches_pallas(name):
    """B3: the plain version against the JAX FusedConvMixerMC in interpret
    mode, at that kernel test's tolerance (5e-4; 1e-3 for the study
    shape)."""
    jmodel, variables, model, x, atol = _case(name)
    want = np.asarray(JaxFusedMC(jmodel, variables)(
        jnp.asarray(x), block_b=8, interpret=True))
    fused = conv_mixer.make_fused_conv_mixer(model)
    assert isinstance(fused, conv_mixer_mc.FusedConvMixerMC)
    before = conv_mixer_mc.PLAIN_CALLS.value
    got = fused(torch.from_numpy(x)).numpy()
    assert conv_mixer_mc.PLAIN_CALLS.value == before + 1
    assert got.shape == want.shape == (x.shape[0], model.out_nTP, 66)
    np.testing.assert_allclose(got, want, atol=atol)


@pytest.mark.parametrize("name", sorted(MC_CASES))
def test_conv_mixer_mc_plain_matches_flax_forward(name):
    """B3's plain version against the flax model's inference forward at the
    model parity tolerance, 2e-5 (tests/test_models.py)."""
    jmodel, variables, model, x, _ = _case(name)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), training=False))
    got = conv_mixer.make_fused_conv_mixer(model)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_packed_layout_matches_spec():
    model = ConvMixer(**_cfg(conv_nChan=3, num_blocks=3, regularization=-1.0,
                             conv1_kernel_shape=(5, 5), dimPosEmb=24)).eval()
    spec, flat = conv_mixer_mc.pack_conv_mixer_mc(model)
    assert flat.dtype == torch.float32 and flat.is_contiguous()
    assert flat.numel() == spec.numel()
    assert spec.C == 3 and spec.Cp == 8 and spec.H == 5
    assert spec.k1 == (5, 5) and spec.k2 == (5, 5)
    assert spec.cluster_sizes()
    assert all(spec.smem_bytes(K) <= _build.MAX_SMEM_BYTES
               for K in spec.cluster_sizes())
    blocks, _ = conv_mixer._unpack(flat, spec)
    # conv1 of block 0: [ci][dt][de][co], co zero padded to Cp
    w = blocks[0]["w1"].view(3, 5, 5, 8)
    torch.testing.assert_close(
        w[..., :3], model.Mixer_Block[0].conv1.conv.weight.permute(1, 2, 3, 0)
        .detach(), rtol=0, atol=0)
    assert not w[..., 3:].any()


def test_autoregressive_default_fits_the_kernel():
    """The autoregressive CLI's default model and the ConvMixer study's
    shape go to B3, with every cluster size (even one block holds a whole
    sample's three planes and one mixer block's weights)."""
    ar = dict(num_blocks=4, dimPosIn=66, dimPosEmb=192, dimPosOut=66,
              in_nTP=10, out_nTP=5, conv_nChan=8, conv1_kernel_shape=(5, 5),
              mode_conv="twice", activation="mish", regularization=-1.0,
              use_se=True, r_se=8, encoder_n_harmonic_functions=0)
    study = dict(ar, num_blocks=6, out_nTP=10, conv1_kernel_shape=(5, 9),
                 mode_conv="once", activation="gelu", regularization=0.1)
    for cfg in (ar, study):
        fused = conv_mixer.make_fused_conv_mixer(ConvMixer(**cfg).eval())
        assert isinstance(fused, conv_mixer_mc.FusedConvMixerMC)
        assert fused.spec.cluster_sizes() == [1, 2, 4, 8, 16]
        assert all(fused.spec.smem_bytes(K) <= _build.MAX_SMEM_BYTES
                   for K in fused.spec.cluster_sizes())


@pytest.mark.parametrize("over,fits", [
    (dict(dimPosEmb=223), True),
    (dict(dimPosEmb=224), True),
    (dict(conv_nChan=12), True),
    (dict(dimPosEmb=512), True),
    (dict(dimPosEmb=8192), False),
    (dict(conv_nChan=12, conv1_kernel_shape=(9, 29)), False),
])
def test_shared_memory_bounds_the_domain_inside_the_jax_one(over, fits):
    """Where the JAX kernel runs (conv_nChan * in_nTP <= 128) B3 takes
    every shape whose column slices fit one block's shared memory for some
    cluster of up to 16 blocks: at the autoregressive widths dimPosEmb 224
    and 512 and conv_nChan 12 (refused while one block held a whole
    sample). It refuses what still outgrows the largest cluster: planes of
    dimPosEmb 8192 (half a megabyte a block at 16 blocks) or conv_nChan 12
    with (9, 29) kernels (each block stages ~400 KB of one mixer block's
    conv weights); the ``Predictor`` then serves with the plain
    forward."""
    cfg = dict(num_blocks=1, dimPosIn=66, dimPosEmb=192, dimPosOut=66,
               in_nTP=10, out_nTP=5, conv_nChan=8, conv1_kernel_shape=(5, 5),
               mode_conv="twice", activation="mish", regularization=-1.0,
               use_se=True, r_se=8, encoder_n_harmonic_functions=0)
    model = ConvMixer(**{**cfg, **over}).eval()
    assert model.conv_nChan * model.in_nTP <= 128
    if fits:
        fused = conv_mixer.make_fused_conv_mixer(model)
        assert isinstance(fused, conv_mixer_mc.FusedConvMixerMC)
    else:
        with pytest.raises(NotImplementedError, match="shared memory"):
            conv_mixer.make_fused_conv_mixer(model)


@pytest.mark.parametrize("over,match", [
    (dict(conv_nChan=13), "conv_nChan\\*in_nTP <= 128"),
    (dict(conv_nChan=2, in_nTP=65), "conv_nChan\\*in_nTP <= 128"),
    (dict(conv_nChan=8, dimPosEmb=8192), "shared memory"),
    (dict(conv1_padding=(0, 0)), "same"),
])
def test_make_fused_conv_mixer_mc_rejects_shapes_outside_the_kernel(over, match):
    """Only where the JAX kernel refuses (R = conv_nChan * in_nTP > 128) and
    where shared memory (even at 16 blocks a sample) or the padding set a
    limit."""
    with pytest.raises(NotImplementedError, match=match):
        conv_mixer.make_fused_conv_mixer(ConvMixer(**_cfg(**over)))


def test_factory_routes_by_conv_nchan():
    one = conv_mixer.make_fused_conv_mixer(
        ConvMixer(**_cfg(conv_nChan=1)).eval())
    two = conv_mixer.make_fused_conv_mixer(
        ConvMixer(**_cfg(conv_nChan=2)).eval())
    assert isinstance(one, conv_mixer.FusedConvMixer)
    assert isinstance(two, conv_mixer_mc.FusedConvMixerMC)
    with pytest.raises(NotImplementedError, match="conv_nChan >= 2"):
        conv_mixer_mc.pack_conv_mixer_mc(ConvMixer(**_cfg(conv_nChan=1)))


def test_wrapper_never_serves_a_non_cpu_tensor_with_the_plain_version():
    spec, flat = conv_mixer_mc.pack_conv_mixer_mc(ConvMixer(**_cfg()).eval())
    y = torch.zeros(2, spec.C, spec.T, spec.E)
    before = (conv_mixer_mc.PLAIN_CALLS.value, conv_mixer_mc.LAUNCHES.value)
    with pytest.raises(RuntimeError, match="no kernel for meta"):
        conv_mixer_mc.conv_mixer_mc_fused(y.to("meta"), flat.to("meta"), spec)
    assert (conv_mixer_mc.PLAIN_CALLS.value,
            conv_mixer_mc.LAUNCHES.value) == before


def test_wrapper_validates_inputs():
    spec, flat = conv_mixer_mc.pack_conv_mixer_mc(ConvMixer(**_cfg()).eval())
    y = torch.zeros(2, spec.C, spec.T, spec.E)
    with pytest.raises(TypeError):
        conv_mixer_mc.conv_mixer_mc_fused(y.double(), flat, spec)
    with pytest.raises(ValueError, match="expected"):
        conv_mixer_mc.conv_mixer_mc_fused(y[:, :-1], flat, spec)
    with pytest.raises(ValueError, match="contiguous"):
        conv_mixer_mc.conv_mixer_mc_fused(y.transpose(2, 3).contiguous()
                                          .transpose(2, 3), flat, spec)
    with pytest.raises(ValueError, match="packed weights"):
        conv_mixer_mc.conv_mixer_mc_fused(y, flat[:-1], spec)
    assert conv_mixer_mc.conv_mixer_mc_fused(y[:0], flat, spec).shape == (
        0, spec.P, spec.D)

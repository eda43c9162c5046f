"""The port's kernel wrappers on the CPU: their plain versions against the
JAX package's Pallas kernels (interpret mode), and the checks that keep a
non-CPU tensor away from the plain versions.

The CUDA kernels themselves run only on a card; ``chip_smoke.py`` holds them
against these plain versions there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionmixerconv_tpu.models import ConvMixer as JaxConvMixer
from motionmixerconv_tpu.ops.pallas_conv_mixer import FusedConvMixer as JaxFused
from motionmixerconv_tpu.ops.pallas_harmonic import make_fused_harmonic_dense
from motionmixerconv_tpu_torch.models import ConvMixer, PoseEncoder, state_dict_from_jax
from motionmixerconv_tpu_torch.ops import _build, conv_mixer, harmonic


def _conv_cfg(**kw):
    cfg = dict(
        num_blocks=2, dimPosIn=66, dimPosEmb=50, dimPosOut=66, in_nTP=10,
        out_nTP=25, conv_nChan=1, conv1_kernel_shape=(1, 3),
        conv1_stride=(1, 1), conv1_padding=None, mode_conv="twice",
        activation="mish", regularization=0.1, use_se=True, r_se=2,
        use_max_pooling=False, encoder_n_harmonic_functions=8,
        encoder_omega0=0.1)
    cfg.update(kw)
    return cfg


def _flax_variables(cfg, x):
    model = JaxConvMixer(**cfg)
    variables = model.init(jax.random.PRNGKey(4), jnp.asarray(x), training=False)
    if cfg["regularization"] == -1.0:
        # warm the BatchNorm running stats so they are non-trivial
        for i in range(3):
            _, upd = model.apply(variables, jnp.asarray(x) + 0.1 * i,
                                 training=True, mutable=["batch_stats"])
            variables = {**variables, "batch_stats": upd["batch_stats"]}
    return model, jax.tree_util.tree_map(np.asarray, variables)


def _port(cfg, variables):
    model = ConvMixer(**cfg)
    model.load_state_dict(state_dict_from_jax(
        variables, cfg["num_blocks"], cfg["encoder_n_harmonic_functions"],
        cfg["encoder_omega0"]), strict=True)
    return model.eval()


# name -> (config overrides, batch, the JAX kernel's batch tile)
B2_CASES = {
    "k13_twice_mish": (dict(), 8, 8),
    "once_gelu": (dict(mode_conv="once", activation="gelu"), 8, 8),
    "batchnorm": (dict(regularization=-1.0, activation="gelu", dimPosEmb=40), 6, 8),
    "max_pool_se": (dict(use_max_pooling=True, dimPosEmb=40), 6, 8),
    "even_kernel_24": (dict(conv1_kernel_shape=(2, 4)), 5, 8),
    "ragged_batch": (dict(), 7, 4),
}


@pytest.mark.parametrize("name", sorted(B2_CASES))
def test_conv_mixer_plain_matches_pallas(name):
    """B2: the plain version, from the port's packed weights, against the
    JAX FusedConvMixer in interpret mode, at that kernel test's tolerance."""
    over, batch, block_b = B2_CASES[name]
    cfg = _conv_cfg(**over)
    rs = np.random.RandomState(0)
    x = (rs.randn(batch, cfg["in_nTP"], cfg["dimPosIn"]) * 0.5).astype(np.float32)
    jmodel, variables = _flax_variables(cfg, x)
    want = np.asarray(JaxFused(jmodel, variables)(
        jnp.asarray(x), block_b=block_b, interpret=True))

    fused = conv_mixer.make_fused_conv_mixer(_port(cfg, variables))
    before = conv_mixer.PLAIN_CALLS.value
    got = fused(torch.from_numpy(x)).numpy()
    assert conv_mixer.PLAIN_CALLS.value == before + 1
    assert got.shape == want.shape == (batch, cfg["out_nTP"], cfg["dimPosOut"])
    np.testing.assert_allclose(got, want, atol=3e-4)


def test_packed_layout_matches_spec():
    cfg = _conv_cfg(num_blocks=3, regularization=-1.0)
    spec, flat = conv_mixer.pack_conv_mixer(ConvMixer(**cfg).eval())
    assert flat.dtype == torch.float32 and flat.is_contiguous()
    assert flat.numel() == spec.numel()
    assert spec.k1 == (1, 3) and spec.k2 == (3, 1) and spec.H == 5
    assert spec.smem_bytes() <= conv_mixer.MAX_SMEM_BYTES


@pytest.mark.parametrize("over,match", [
    (dict(conv_nChan=13), "conv_nChan"),  # R = 130 > 128: no kernel
    (dict(conv1_padding=(0, 0)), "same"),
    (dict(conv1_stride=(1, 2), conv1_padding=(0, 1)), "same"),
    (dict(dimPosEmb=1024), "limits"),
])
def test_make_fused_conv_mixer_rejects_shapes_outside_the_kernel(over, match):
    with pytest.raises(NotImplementedError, match=match):
        conv_mixer.make_fused_conv_mixer(ConvMixer(**_conv_cfg(**over)))


def _harmonic_case(rows, d, e, n, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(rows, d) * 0.5).astype(np.float32)
    k = (rs.randn(2 * n * d, e) * 0.05).astype(np.float32)
    b = (rs.randn(e) * 0.1).astype(np.float32)
    return x, k, b


@pytest.mark.parametrize("impl", ["direct", "doubling"])
@pytest.mark.parametrize("rows,d,e,n,tile", [
    (40, 66, 50, 8, 16),   # rows not a tile multiple
    (32, 7, 13, 4, 8),     # odd dims
    (16, 5, 7, 1, 8),      # single harmonic
])
def test_harmonic_plain_matches_pallas(impl, rows, d, e, n, tile):
    """B1-fwd: the plain version against make_fused_harmonic_dense in
    interpret mode, at that kernel test's tolerance."""
    x, k, b = _harmonic_case(rows, d, e, n)
    fn = make_fused_harmonic_dense(d, e, n, 0.1, tile_rows=tile,
                                   interpret=True, impl=impl)
    want = np.asarray(fn(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b)))
    freqs = PoseEncoder(d, e, n_harmonic_functions=n, omega0=0.1).frequencies
    before = harmonic.PLAIN_CALLS.value
    got = harmonic.harmonic_dense(
        torch.from_numpy(x), torch.from_numpy(k.T.copy()), torch.from_numpy(b),
        freqs, impl).numpy()
    assert harmonic.PLAIN_CALLS.value == before + 1
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_reorder_weight_is_the_pallas_layout():
    n, d, e = 3, 4, 5
    k = np.arange(2 * n * d * e, dtype=np.float32).reshape(2 * n * d, e)
    want = k.reshape(2, d, n, e).transpose(0, 2, 1, 3)  # pallas_harmonic _reorder
    got = harmonic.reorder_weight(torch.from_numpy(k.T.copy()), n, d)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fused_encoder_matches_plain_encoder():
    """PoseEncoder(fused=True) goes through the B1 wrapper and agrees with
    the unfused module on the same weights."""
    gen = torch.Generator().manual_seed(0)
    plain = PoseEncoder(12, 16, conv_nChan=1, n_harmonic_functions=6)
    fused = PoseEncoder(12, 16, conv_nChan=1, n_harmonic_functions=6, fused=True)
    for p in plain.parameters():
        p.data.uniform_(-0.3, 0.3, generator=gen)
    fused.load_state_dict(plain.state_dict(), strict=True)
    x = torch.randn(3, 10, 12, generator=gen)
    before = harmonic.PLAIN_CALLS.value
    with torch.no_grad():
        got, want = fused(x), plain(x)
    assert harmonic.PLAIN_CALLS.value == before + 1
    torch.testing.assert_close(got, want, atol=2e-5, rtol=1e-5)


def test_encoder_keeps_the_kernel_weight_until_it_changes():
    """The i-major weight the kernel reads is reordered once, not per call,
    and rebuilt after the parameter changes in place or is reloaded."""
    enc = PoseEncoder(5, 7, n_harmonic_functions=3, fused=True)
    first = enc.kernel_weight()
    assert enc.kernel_weight() is first
    torch.testing.assert_close(
        first, harmonic.reorder_weight(enc.embed_mlp.weight.detach(), 3, 5),
        rtol=0, atol=0)
    with torch.no_grad():
        enc.embed_mlp.weight.mul_(2.0)
    second = enc.kernel_weight()
    assert second is not first
    torch.testing.assert_close(second, 2.0 * first, rtol=0, atol=0)
    enc.load_state_dict(PoseEncoder(5, 7, n_harmonic_functions=3).state_dict())
    torch.testing.assert_close(
        enc.kernel_weight(),
        harmonic.reorder_weight(enc.embed_mlp.weight.detach(), 3, 5),
        rtol=0, atol=0)


@pytest.mark.parametrize("impl", ["direct", "doubling"])
@pytest.mark.parametrize("rows,d,e,n", [
    (24, 11, 9, 6),
    (24, 11, 9, 1),     # single harmonic
    (40, 66, 50, 8),
])
def test_harmonic_backward_plain_matches_pallas_vjp(impl, rows, d, e, n):
    """B1-bwd: the autograd Function's CPU backward (the plain version)
    against the VJP of make_fused_harmonic_dense in interpret mode, for dx,
    dW and db, at that kernel test's tolerance."""
    x, k, b = _harmonic_case(rows, d, e, n, seed=1)
    g = np.random.RandomState(2).randn(rows, e).astype(np.float32)
    fn = make_fused_harmonic_dense(d, e, n, 0.1, tile_rows=8,
                                   interpret=True, impl=impl)
    _, vjp = jax.vjp(fn, jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    want_dx, want_dk, want_db = (np.asarray(a) for a in vjp(jnp.asarray(g)))

    freqs = PoseEncoder(d, e, n_harmonic_functions=n, omega0=0.1).frequencies
    xt = torch.from_numpy(x).requires_grad_(True)
    wt = torch.from_numpy(k.T.copy()).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    out = harmonic.harmonic_dense(xt, wt, bt, freqs, impl)
    before = harmonic.PLAIN_CALLS.value
    out.backward(torch.from_numpy(g))
    assert harmonic.PLAIN_CALLS.value == before + 1
    for name, got, want in (("dx", xt.grad.numpy(), want_dx),
                            ("dW", wt.grad.numpy().T, want_dk),
                            ("db", bt.grad.numpy(), want_db)):
        np.testing.assert_allclose(got, want, atol=5e-4, rtol=1e-4,
                                   err_msg=name)


def test_harmonic_backward_skips_dx_for_data_inputs():
    """With an input that needs no gradient (training: x is data) the
    backward returns no dx, and the weight gradients are unchanged."""
    x, k, b = _harmonic_case(12, 5, 7, 3)
    freqs = PoseEncoder(5, 7, n_harmonic_functions=3).frequencies
    grads = []
    for need_x in (True, False):
        xt = torch.from_numpy(x).requires_grad_(need_x)
        wt = torch.from_numpy(k.T.copy()).requires_grad_(True)
        bt = torch.from_numpy(b).requires_grad_(True)
        harmonic.harmonic_dense(xt, wt, bt, freqs).square().sum().backward()
        assert (xt.grad is not None) == need_x
        grads.append((wt.grad, bt.grad))
    for a, b_ in zip(*grads):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)


def test_doubling_backward_uses_the_recurrence_features():
    """Past harmonic ~26 the doubling recurrence's features are f32 noise
    unlike direct trig's, so the two impls' gradients part. The doubling
    backward is the analytic formula at the recurrence's own features; at
    these inputs it agrees with autograd through the plain doubling forward
    to rounding (measured ~4e-7 of max|dx| up to n = 64), and not with the
    direct impl's gradient."""
    rows, d, e, n = 16, 4, 5, 40
    x, k, b = _harmonic_case(rows, d, e, n)
    g = torch.from_numpy(np.random.RandomState(3).randn(rows, e).astype(np.float32))
    xt, wt = torch.from_numpy(x), torch.from_numpy(k.T.copy())
    freqs = PoseEncoder(d, e, n_harmonic_functions=n).frequencies
    dx = {impl: harmonic.harmonic_dense_bwd_plain(xt, g, wt, freqs, impl)[0]
          for impl in ("direct", "doubling")}
    xa = xt.clone().requires_grad_(True)
    harmonic.harmonic_dense_plain(xa, wt, torch.from_numpy(b), freqs,
                                  "doubling").backward(g)
    scale = dx["doubling"].abs().max()
    assert (xa.grad - dx["doubling"]).abs().max() < 1e-5 * scale
    assert (dx["direct"] - dx["doubling"]).abs().max() > 0.1 * scale


def test_harmonic_backward_raises():
    """Differentiating on a device without a kernel raises: the backward
    never serves a non-CPU tensor with its plain version."""
    x, k, b = _harmonic_case(8, 5, 7, 3)
    freqs = PoseEncoder(5, 7, n_harmonic_functions=3).frequencies
    g = torch.ones(8, 7)
    args = [torch.from_numpy(x), g, torch.from_numpy(k.T.copy()), freqs]
    before = (harmonic.PLAIN_CALLS.value, harmonic.LAUNCHES_BWD.value)
    with pytest.raises(RuntimeError, match="no kernel for meta"):
        harmonic.harmonic_dense_bwd(*[_meta(a) for a in args])
    assert (harmonic.PLAIN_CALLS.value, harmonic.LAUNCHES_BWD.value) == before
    with pytest.raises(ValueError, match="expected g"):
        harmonic.harmonic_dense_bwd(args[0], g[:, :-1].contiguous(),
                                    *args[2:])


def _meta(t):
    return t.to("meta")


def test_wrappers_never_serve_a_non_cpu_tensor_with_the_plain_version():
    cfg = _conv_cfg()
    spec, flat = conv_mixer.pack_conv_mixer(ConvMixer(**cfg).eval())
    y = torch.zeros(2, spec.T, spec.E)
    before = (conv_mixer.PLAIN_CALLS.value, conv_mixer.LAUNCHES.value)
    with pytest.raises(RuntimeError, match="no kernel for meta"):
        conv_mixer.conv_mixer_fused(_meta(y), _meta(flat), spec)
    assert (conv_mixer.PLAIN_CALLS.value, conv_mixer.LAUNCHES.value) == before

    x, k, b = _harmonic_case(8, 5, 7, 3)
    freqs = PoseEncoder(5, 7, n_harmonic_functions=3).frequencies
    args = [torch.from_numpy(x), torch.from_numpy(k.T.copy()),
            torch.from_numpy(b), freqs]
    before = (harmonic.PLAIN_CALLS.value, harmonic.LAUNCHES.value)
    with pytest.raises(RuntimeError, match="no kernel for meta"):
        harmonic.harmonic_dense_fwd(*[_meta(a) for a in args])
    assert (harmonic.PLAIN_CALLS.value, harmonic.LAUNCHES.value) == before


def test_wrappers_validate_inputs():
    spec, flat = conv_mixer.pack_conv_mixer(ConvMixer(**_conv_cfg()).eval())
    y = torch.zeros(2, spec.T, spec.E)
    with pytest.raises(TypeError):
        conv_mixer.conv_mixer_fused(y.double(), flat, spec)
    with pytest.raises(ValueError, match="expected"):
        conv_mixer.conv_mixer_fused(y[:, :-1], flat, spec)
    with pytest.raises(ValueError, match="contiguous"):
        conv_mixer.conv_mixer_fused(
            torch.zeros(2, spec.E, spec.T).transpose(1, 2), flat, spec)
    with pytest.raises(ValueError, match="packed weights"):
        conv_mixer.conv_mixer_fused(y, flat[:-1], spec)

    x, k, b = _harmonic_case(8, 5, 7, 3)
    freqs = PoseEncoder(5, 7, n_harmonic_functions=3).frequencies
    xt, wt, bt = torch.from_numpy(x), torch.from_numpy(k.T.copy()), torch.from_numpy(b)
    with pytest.raises(ValueError, match="unknown harmonic impl"):
        harmonic.harmonic_dense_fwd(xt, wt, bt, freqs, "fast")
    with pytest.raises(TypeError):
        harmonic.harmonic_dense_fwd(xt.double(), wt, bt, freqs)
    with pytest.raises(ValueError, match="expected weight"):
        harmonic.harmonic_dense_fwd(xt, wt[:, :-1], bt, freqs)
    with pytest.raises(ValueError, match="contiguous"):
        harmonic.harmonic_dense_fwd(xt, torch.from_numpy(k).t(), bt, freqs)
    wi = harmonic.reorder_weight(wt, 3, 5)
    torch.testing.assert_close(
        harmonic.harmonic_dense_fwd(xt, wt, bt, freqs, "direct", wi),
        harmonic.harmonic_dense_plain(xt, wt, bt, freqs), rtol=0, atol=0)
    with pytest.raises(ValueError, match="weight_imajor"):
        harmonic.harmonic_dense_fwd(xt, wt, bt, freqs, "direct", wi[:, :-1])
    with pytest.raises(ValueError, match="weight_imajor"):
        harmonic.harmonic_dense_fwd(xt, wt, bt, freqs, "direct",
                                    wi.transpose(2, 3).contiguous())


def test_build_needs_a_card(monkeypatch):
    """No card: building the kernels raises instead of returning nothing."""
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _build.load_library()

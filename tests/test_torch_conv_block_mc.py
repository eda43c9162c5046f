"""The multi-channel ConvBlock's Function (``ops/conv_block_mc.py``) on the
CPU, where it runs its plain versions: against ``ConvBlock``'s own modules
and autograd, against float64 and finite differences, its launch plan,
which blocks take it, its counters, and a ConvMixer through it against the
JAX package. The kernels themselves are held to these plain versions on
the card (``tests/test_torch_card.py``, ``chip_smoke.py``).
"""

import copy
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionmixerconv_tpu.models import ConvMixer as JaxConvMixer
from motionmixerconv_tpu_torch.models import ConvBlock, ConvMixer
from motionmixerconv_tpu_torch.models.torch_io import state_dict_from_jax
from motionmixerconv_tpu_torch.ops import _build, conv_block, conv_block_mc

# (N, C, T, E, taps): the autoregressive cell's shape at a small batch, the
# conv study's widest kernel (a width the kernels take in chunks), the
# autoregressive study's (C 4) and a plane narrower than a slice
SHAPES = {
    "autoregressive": (2, 8, 10, 192, (5, 5)),
    "conv_study_9x29": (1, 8, 10, 40, (9, 29)),
    "autoreg_study_4ch": (2, 4, 10, 24, (9, 9)),
    "three_channels_3x7": (3, 3, 6, 7, (3, 7)),
}
# float32 against float64, relative to each output's largest magnitude:
# a 200- to 2,300-term sum a convolution output, dw a sum over the batch's
# positions; the float32 rounding of such sums stays well under it
TOL_F64 = 1e-5


def _inputs(shape, activation, seed=0, dtype=torch.float32):
    n, c, t, e, k = shape
    gen = torch.Generator().manual_seed(seed)
    block = ConvBlock(c, k, activation=activation)
    with torch.no_grad():  # a bias of a scale the taps give, so z crosses 0
        block.conv.bias.copy_(torch.linspace(-0.2, 0.2, c))
    block = block.to(dtype)
    x = torch.randn(n, c, t, e, generator=gen, dtype=dtype)
    g = torch.randn(n, c, t, e, generator=gen, dtype=dtype)
    return block, x, g


def _module_route(block, x, g):
    """The modules' route: the conv module, then the activation, by
    autograd."""
    x = x.clone().requires_grad_()
    a = block.act(block.conv(x))
    dx, dw, db = torch.autograd.grad(a, (x, block.conv.weight,
                                         block.conv.bias), g)
    return a.detach(), dx, dw, db


@pytest.mark.parametrize("activation", ["mish", "gelu"])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_versions_match_the_modules(shape, activation):
    """The plain forward is the modules' composition and the plain backward
    autograd's gradient through the modules, both bit for bit, in float32
    and float64."""
    for dtype in (torch.float32, torch.float64):
        block, x, g = _inputs(SHAPES[shape], activation, dtype=dtype)
        w, b = block.conv.weight.detach(), block.conv.bias.detach()
        a, dx, dw, db = _module_route(block, x, g)
        before = conv_block_mc.PLAIN_CALLS.value
        got, da = conv_block_mc.conv_block_mc_fwd(x, w, b, activation,
                                                  with_grad=True)
        got_dx, got_dw, got_db = conv_block_mc.conv_block_mc_bwd(
            x, da, g, w, b, activation)
        assert conv_block_mc.PLAIN_CALLS.value == before + 2
        assert da is None  # the plain backward differentiates the modules
        assert torch.equal(got, a)
        for got_t, want in ((got_dx, dx), (got_dw, dw), (got_db, db)):
            assert got_t.shape == want.shape
            assert torch.equal(got_t, want)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_versions_agree_with_float64(shape):
    """The float32 plain forward and backward against float64, within
    TOL_F64 of each output's largest magnitude: the precision the kernels
    are held to on the card."""
    block, x, g = _inputs(SHAPES[shape], "mish")
    w, b = block.conv.weight.detach(), block.conv.bias.detach()
    got = [conv_block_mc.conv_block_mc_plain(x, w, b, "mish"),
           *conv_block_mc.conv_block_mc_bwd_plain(x, g, w, b, "mish")]
    d = [v.double() for v in (x, g, w, b)]
    want = [conv_block_mc.conv_block_mc_plain(d[0], d[2], d[3], "mish"),
            *conv_block_mc.conv_block_mc_bwd_plain(*d, "mish")]
    for u, v in zip(got, want):
        assert u.dtype == torch.float32
        assert float((u.double() - v).abs().max()) <= TOL_F64 * float(
            v.abs().max())


@pytest.mark.parametrize("activation", ["mish", "gelu"])
def test_function_gradcheck(activation):
    """The Function's backward against finite differences, float64."""
    block, x, _ = _inputs((2, 3, 4, 5, (3, 3)), activation,
                          dtype=torch.float64)
    w = block.conv.weight.detach().clone().requires_grad_()
    b = block.conv.bias.detach().clone().requires_grad_()
    x = x.requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x, w, b: conv_block_mc.conv_block_mc(x, w, b, activation),
        (x, w, b))


# (C, T, E, taps) -> (slice width, subsets of a weight-gradient task,
# backward shared memory), or None where no plan fits
PLANS = {
    (8, 10, 192, (5, 5)): (48, 3, 92992),     # the autoregressive cell
    (8, 10, 192, (9, 29)): (36, 1, 222368),   # the conv study's widest
    (8, 10, 192, (1, 1)): (48, 10, 62656),
    (4, 10, 192, (9, 9)): (48, 8, 62112),     # the autoregressive study's
    (16, 10, 60, (5, 5)): (48, 1, 198784),
    (24, 10, 192, (5, 5)): (24, 1, 216288),
    (32, 10, 192, (5, 5)): None,
    (60, 10, 60, (5, 5)): None,               # the angle autoregressive model
}


@pytest.mark.parametrize("key", list(PLANS), ids=str)
def test_plan(key):
    """The launch plan: the widest slice whose backward tiles fit a block's
    shared memory, the weight-gradient tasks' row subsets, the shared
    memory as the kernels lay it out, a stencil task a forward thread;
    None where nothing fits."""
    c, t, e, k = key
    p = conv_block_mc.plan(c, t, e, *k)
    if PLANS[key] is None:
        assert p is None
        return
    assert (p.be, p.s, p.smem_bwd) == PLANS[key]
    assert p.bt == t and p.be % conv_block_mc.CB == 0
    assert p.smem_fwd < p.smem_bwd <= _build.MAX_SMEM_BYTES
    cp = -(-c // conv_block_mc.CO) * conv_block_mc.CO
    tasks = cp // conv_block_mc.CO * t * (p.be // conv_block_mc.CB)
    assert p.fwd_threads == min(conv_block_mc.FWD_THREADS,
                                -(-tasks // 32) * 32)
    qc = k[1] if k[1] in conv_block_mc.FIXED_KW else conv_block_mc.CHUNK
    sums = (k[0] * c * -(-k[1] // qc) + 1) * (cp // conv_block_mc.CO)
    assert p.s == 1 or p.s * sums <= conv_block_mc.BWD_THREADS


def test_the_cells_plan_fills_the_card():
    """At the cell's batch the plan's blocks outnumber the H100's 132 SMs."""
    assert conv_block_mc.plan(8, 10, 192, 5, 5).blocks(50, 10, 192) == 200


@pytest.mark.parametrize("shape,taps,on_card,dtype,want", [
    ((8, 10, 192), (5, 5), True, torch.float32, True),
    ((8, 10, 192), (9, 29), True, torch.float32, True),
    ((60, 10, 60), (5, 5), True, torch.float32, False),  # tiles too large
    ((8, 10, 192), (5, 5), False, torch.float32, False),
    ((8, 10, 192), (5, 5), True, torch.float64, False),
])
def test_takes(shape, taps, on_card, dtype, want):
    """The kernels take float32 CUDA tensors whose plan fits; the rest go
    to the modules."""
    x = SimpleNamespace(is_cuda=on_card, dtype=dtype, shape=(2, *shape),
                        dim=lambda: 4)
    w = SimpleNamespace(dtype=dtype, shape=(shape[0], shape[0], *taps))
    assert conv_block_mc.takes(x, w) == want


def _spies(monkeypatch, on_card: bool, dtypes=(torch.float32,)):
    """Calls of the two Functions' entries from the model, by name; with
    ``on_card`` the CPU's tensors of ``dtypes`` count as the card's float32
    ones, so the Functions run (on their plain versions) wherever such a
    CUDA tensor would take them."""
    calls = []
    for mod, name in ((conv_block, "conv_block"),
                      (conv_block_mc, "conv_block_mc")):
        real = getattr(mod, name)

        def spy(*args, real=real, name=name):
            calls.append(name)
            return real(*args)

        monkeypatch.setattr(mod, name, spy)
        if on_card:
            real_takes = mod.takes

            def takes(x, weight, real_takes=real_takes):
                if x.dtype not in dtypes or weight.dtype not in dtypes:
                    return False
                return real_takes(SimpleNamespace(
                    is_cuda=True, dtype=torch.float32, shape=x.shape,
                    dim=x.dim), SimpleNamespace(dtype=torch.float32,
                                                shape=weight.shape))

            monkeypatch.setattr(mod, "takes", takes)
    return calls


BLOCKS = {  # ConvBlock arguments, the entry its forward takes on the card
    "one_channel": (dict(conv_nChan=1, kernel_shape=(1, 3),
                         activation="mish"), "conv_block"),
    "eight_channels_5x5_batchnorm": (dict(conv_nChan=8, kernel_shape=(5, 5),
                                          activation="mish",
                                          regularization=-1.0),
                                     "conv_block_mc"),
    "four_channels_9x9_gelu": (dict(conv_nChan=4, kernel_shape=(9, 9),
                                    activation="gelu"), "conv_block_mc"),
    "two_channels_explicit_padding": (dict(conv_nChan=2, kernel_shape=(3, 5),
                                           padding=(1, 2),
                                           activation="mish"),
                                      "conv_block_mc"),
    "eight_channels_even": (dict(conv_nChan=8, kernel_shape=(2, 2),
                                 activation="mish"), None),
    "eight_channels_even_rows": (dict(conv_nChan=8, kernel_shape=(10, 1),
                                      activation="mish"), None),
    "eight_channels_strided": (dict(conv_nChan=8, kernel_shape=(1, 3),
                                    stride=(1, 2), padding=(0, 1),
                                    activation="mish"), None),
    "eight_channels_not_same": (dict(conv_nChan=8, kernel_shape=(3, 3),
                                     padding=(0, 0), activation="mish"),
                                None),
    "eight_channels_bf16": (dict(conv_nChan=8, kernel_shape=(5, 5),
                                 activation="mish", dtype=torch.bfloat16),
                            None),
    "sixty_channels": (dict(conv_nChan=60, kernel_shape=(5, 5),
                            activation="mish"), None),  # tiles too large
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_which_blocks_take_which_function(name, monkeypatch):
    """On the card a float32 block at stride 1 with 'same' padding takes
    the single-channel Function at one channel and the multi-channel one
    at two or more with odd kernels whose plan fits; even kernels, strided
    or other explicit padding, a compute dtype and tiles too large keep the
    modules; on the CPU every block keeps them. Through either Function the
    output is the modules' own."""
    kw, route = BLOCKS[name]
    block = ConvBlock(**kw).eval()
    assert block.mc_kernel == (route == "conv_block_mc"
                               or name == "sixty_channels")
    e = 12 if kw["conv_nChan"] < 60 else 60
    x = torch.randn(3, kw["conv_nChan"], 10, e,
                    generator=torch.Generator().manual_seed(1))
    calls = _spies(monkeypatch, on_card=False)
    want = block(x)
    assert calls == []
    calls = _spies(monkeypatch, on_card=True)
    got = block(x)
    assert calls == ([route] if route else [])
    assert torch.equal(got, want)


def test_cpu_tensors_never_take_the_function():
    """The real route: CPU tensors of a block that would take the Function
    run the modules, and the plain versions are never called."""
    block = ConvBlock(8, (5, 5), activation="mish")
    x = torch.randn(2, 8, 10, 16)
    before = conv_block_mc.PLAIN_CALLS.value
    assert block.mc_kernel and not conv_block_mc.takes(x, block.conv.weight)
    block(x).sum().backward()
    assert conv_block_mc.PLAIN_CALLS.value == before


def test_counters_and_what_a_call_saves():
    """A call that autograd will differentiate goes through the Function
    (a forward and, on backward, a backward: two plain calls here); one
    under no_grad, or on tensors that need no gradient, is one forward and
    saves nothing; no kernel launch is counted on the CPU."""
    block, x, g = _inputs((2, 8, 10, 12, (5, 5)), "mish")
    w, b = block.conv.weight, block.conv.bias
    launches = (conv_block_mc.LAUNCHES.value,
                conv_block_mc.LAUNCHES_BWD.value)
    before = conv_block_mc.PLAIN_CALLS.value
    a = conv_block_mc.conv_block_mc(x, w, b, "mish")
    assert a.grad_fn is not None
    assert conv_block_mc.PLAIN_CALLS.value == before + 1
    torch.autograd.grad(a, (w, b), g)
    assert conv_block_mc.PLAIN_CALLS.value == before + 2
    with torch.no_grad():
        a = conv_block_mc.conv_block_mc(x, w, b, "mish")
    assert a.grad_fn is None
    a = conv_block_mc.conv_block_mc(x, w.detach(), b.detach(), "mish")
    assert a.grad_fn is None
    assert conv_block_mc.PLAIN_CALLS.value == before + 4
    assert (conv_block_mc.LAUNCHES.value,
            conv_block_mc.LAUNCHES_BWD.value) == launches


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.randn(2, 3, 4, 5)
    w, b = torch.randn(3, 3, 1, 3), torch.zeros(3)
    with pytest.raises(ValueError, match="Unknown activation"):
        conv_block_mc.conv_block_mc_fwd(x, w, b, "relu")
    with pytest.raises(ValueError, match="odd kh and kw"):
        conv_block_mc.conv_block_mc_fwd(x, torch.randn(3, 3, 2, 3), b,
                                        "mish")
    with pytest.raises(ValueError, match="takes x"):
        conv_block_mc.conv_block_mc_fwd(torch.randn(2, 4, 4, 5), w, b,
                                        "mish")
    with pytest.raises(ValueError, match="contiguous"):
        conv_block_mc.conv_block_mc_fwd(x.transpose(2, 3), w, b, "mish")
    with pytest.raises(ValueError, match="expected g"):
        conv_block_mc.conv_block_mc_bwd(x, None, torch.randn(2, 3, 4, 6), w,
                                        b, "mish")
    meta = [v.to("meta") for v in (x, w, b)]
    with pytest.raises(RuntimeError, match="no kernel"):
        conv_block_mc.conv_block_mc_fwd(*meta, "mish")
    with pytest.raises(ValueError, match="forward's act'"):
        conv_block_mc.conv_block_mc_bwd(meta[0], None, meta[0], *meta[1:],
                                        "mish")


def test_a_launch_too_large_for_shared_memory_raises():
    """An entry's return for tiles beyond shared memory raises
    NotImplementedError; any other error RuntimeError; 0 nothing."""
    lib = SimpleNamespace(mmc_error_string=lambda err: b"invalid argument")
    conv_block_mc._check_launch(lib, 0, "conv_block_mc_fwd")
    with pytest.raises(NotImplementedError, match="shared memory"):
        conv_block_mc._check_launch(lib, conv_block_mc.TILES_TOO_LARGE,
                                    "conv_block_mc_bwd")
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        conv_block_mc._check_launch(lib, 1, "conv_block_mc_fwd")


AUTOREG_SMALL = dict(
    num_blocks=2, dimPosIn=66, dimPosEmb=24, dimPosOut=66, in_nTP=10,
    out_nTP=5, conv_nChan=8, conv1_kernel_shape=(5, 5), activation="mish",
    regularization=-1.0, use_se=True, r_se=8,
    encoder_n_harmonic_functions=0, encoder_omega0=0.0)


def test_convmixer_through_the_function_matches_jax(monkeypatch):
    """The autoregressive ConvMixer (8 channels, (5,5), BatchNorm) at a
    small width with its blocks through the Function (the CPU's tensors
    counted as the card's): its float32 forward is the JAX package's (the
    flax tests' 2e-5) and the modules' bit for bit; its float64 gradients
    are the modules' (1e-9 of the largest: the gradient written out
    against autograd's chain)."""
    cfg = AUTOREG_SMALL
    model = JaxConvMixer(**cfg)
    rs = np.random.RandomState(5)
    x = (rs.randn(4, cfg["in_nTP"], cfg["dimPosIn"]) * 0.5).astype(np.float32)
    variables = model.init(jax.random.PRNGKey(5), jnp.asarray(x),
                           training=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    want = np.asarray(model.apply(variables, jnp.asarray(x), training=False))
    port = ConvMixer(**cfg)
    port.load_state_dict(state_dict_from_jax(
        variables, cfg["num_blocks"], cfg["encoder_n_harmonic_functions"],
        cfg["encoder_omega0"]), strict=True)
    port.eval()
    port64 = copy.deepcopy(port).double()

    def run():
        with torch.no_grad():
            out = port(torch.from_numpy(x))
        port64.zero_grad()
        out64 = port64(torch.from_numpy(x).double())
        (out64 * torch.linspace(-1, 1, out64.numel(), dtype=torch.float64)
         .reshape(out64.shape)).sum().backward()
        return out, {k: p.grad.clone() for k, p in port64.named_parameters()}

    out_modules, grads_modules = run()
    calls = _spies(monkeypatch, on_card=True, dtypes=(torch.float32,
                                                      torch.float64))
    out, grads = run()
    assert calls == ["conv_block_mc"] * (2 * 2 * cfg["num_blocks"])
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5)
    assert torch.equal(out, out_modules)
    scale = max(g.abs().max().item() for g in grads_modules.values())
    for k, want_g in grads_modules.items():
        torch.testing.assert_close(grads[k], want_g, rtol=1e-9,
                                   atol=1e-9 * scale)

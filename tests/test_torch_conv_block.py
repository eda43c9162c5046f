"""The single-channel ConvBlock's Function (``ops/conv_block.py``) on the
CPU, where it runs its plain versions: against ``ConvBlock``'s own modules
and autograd, against finite differences, the blocks that take it, a
ConvMixer through it against the JAX package, and the benchmark's reader
of its device launches. The kernels themselves are held to these plain
versions on the card (``tests/test_torch_card.py``, ``chip_smoke.py``).
"""

import copy
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionmixerconv_tpu.models import ConvMixer as JaxConvMixer
from motionmixerconv_tpu_torch import profiling
from motionmixerconv_tpu_torch.models import ConvBlock, ConvMixer
from motionmixerconv_tpu_torch.models.torch_io import state_dict_from_jax
from motionmixerconv_tpu_torch.ops import conv_block

KERNELS = [(1, 3), (3, 1), (5, 5), (2, 2)]


def _inputs(kernel, activation, n=6, t=10, e=12, seed=0,
            dtype=torch.float32):
    gen = torch.Generator().manual_seed(seed)
    block = ConvBlock(1, kernel, activation=activation)
    with torch.no_grad():  # a bias of a scale the taps give, so z crosses 0
        block.conv.bias.fill_(0.1)
    block = block.to(dtype)
    x = torch.randn(n, 1, t, e, generator=gen, dtype=dtype)
    g = torch.randn(n, 1, t, e, generator=gen, dtype=dtype)
    return block, x, g


def _module_route(block, x, g):
    """Today's route: the conv module, then the activation, by autograd."""
    x = x.clone().requires_grad_()
    a = block.act(block.conv(x))
    dx, dw, db = torch.autograd.grad(a, (x, block.conv.weight,
                                         block.conv.bias), g)
    return a.detach(), dx, dw, db


@pytest.mark.parametrize("activation", ["mish", "gelu"])
@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: f"{k[0]}x{k[1]}")
def test_plain_versions_match_the_modules(kernel, activation):
    """The plain forward is the modules' composition and the plain backward
    autograd's gradient through the modules, both bit for bit, in float32
    and float64."""
    for dtype in (torch.float32, torch.float64):
        block, x, g = _inputs(kernel, activation, dtype=dtype)
        w, b = block.conv.weight, block.conv.bias
        a, dx, dw, db = _module_route(block, x, g)
        before = conv_block.PLAIN_CALLS.value
        got = conv_block.conv_block_fwd(x, w.detach(), b.detach(), activation)
        got_dx, got_dw, got_db = conv_block.conv_block_bwd(
            x, g, w.detach(), b.detach(), activation)
        assert conv_block.PLAIN_CALLS.value == before + 2
        assert torch.equal(got, a)
        for got_t, want in ((got_dx, dx), (got_dw, dw), (got_db, db)):
            assert got_t.shape == want.shape
            assert torch.equal(got_t, want)


@pytest.mark.parametrize("activation", ["mish", "gelu"])
@pytest.mark.parametrize("kernel", KERNELS, ids=lambda k: f"{k[0]}x{k[1]}")
def test_function_gradcheck(kernel, activation):
    """The Function's backward against finite differences, float64."""
    block, x, _ = _inputs(kernel, activation, n=2, t=4, e=5,
                          dtype=torch.float64)
    w = block.conv.weight.detach().clone().requires_grad_()
    b = block.conv.bias.detach().clone().requires_grad_()
    x = x.requires_grad_()
    assert torch.autograd.gradcheck(
        lambda x, w, b: conv_block.conv_block(x, w, b, activation), (x, w, b))


def _spy(monkeypatch, on_card: bool, dtypes=(torch.float32,)):
    """Calls of ``conv_block.conv_block`` from the model; with ``on_card``
    the CPU's tensors of ``dtypes`` count as the card's float32 ones, so
    the Function runs (on its plain versions) wherever such a CUDA tensor
    would take it."""
    calls = []
    real = conv_block.conv_block

    def spy(*args):
        calls.append(args[3])
        return real(*args)

    monkeypatch.setattr(conv_block, "conv_block", spy)
    if on_card:
        monkeypatch.setattr(conv_block, "takes", lambda x, weight: (
            x.dtype in dtypes and weight.dtype in dtypes))
    return calls


BLOCKS = {
    "one_channel_mish": (dict(conv_nChan=1, kernel_shape=(1, 3),
                              activation="mish", regularization=0.1), True),
    "one_channel_5x5_batchnorm": (dict(conv_nChan=1, kernel_shape=(5, 5),
                                       activation="mish",
                                       regularization=-1.0), True),
    "one_channel_even_gelu": (dict(conv_nChan=1, kernel_shape=(2, 2),
                                   activation="gelu"), True),
    "eight_channels": (dict(conv_nChan=8, kernel_shape=(5, 5),
                            activation="mish", regularization=-1.0), False),
    "bf16": (dict(conv_nChan=1, kernel_shape=(1, 3), activation="mish",
                  dtype=torch.bfloat16), False),
    "strided": (dict(conv_nChan=1, kernel_shape=(1, 3), stride=(1, 2),
                     padding=(0, 1), activation="mish"), False),
    "explicit_padding": (dict(conv_nChan=1, kernel_shape=(1, 3),
                              padding=(0, 1), activation="mish"), True),
    "explicit_padding_5x5": (dict(conv_nChan=1, kernel_shape=(5, 5),
                                  padding=(2, 2), activation="mish"), True),
    "explicit_padding_not_same": (dict(conv_nChan=1, kernel_shape=(1, 3),
                                       padding=(0, 0), activation="mish"),
                                  False),
    "even_explicit_padding": (dict(conv_nChan=1, kernel_shape=(2, 2),
                                   padding=(1, 1), activation="gelu"), False),
}


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_which_blocks_take_the_function(name, monkeypatch):
    """A float32 block of one channel at stride 1 with 'same' padding, or
    the explicit padding an odd kernel's 'same' gives, takes the Function
    where its tensor is on the card; wider, bf16 and strided blocks, and
    other explicit padding, keep the modules; on the CPU every block keeps
    them. Through the Function the output is the modules' own."""
    kw, takes = BLOCKS[name]
    c = kw["conv_nChan"]
    block = ConvBlock(**kw).eval()
    assert block.one_kernel == takes
    x = torch.randn(3, c, 10, 12, generator=torch.Generator().manual_seed(1))
    calls = _spy(monkeypatch, on_card=False)
    want = block(x)
    assert calls == []
    calls = _spy(monkeypatch, on_card=True)
    got = block(x)
    assert calls == ([kw["activation"]] if takes else [])
    assert torch.equal(got, want)


def test_cpu_tensors_never_take_the_function():
    """The real test: CPU tensors of a block that would take the Function
    run the modules, and the plain versions are never called."""
    block = ConvBlock(1, (1, 3), activation="mish")
    x = torch.randn(2, 1, 10, 8)
    before = conv_block.PLAIN_CALLS.value
    assert block.one_kernel and not conv_block.takes(x, block.conv.weight)
    block(x).sum().backward()
    assert conv_block.PLAIN_CALLS.value == before


@pytest.mark.parametrize("plane,taps,on_card,dtype,want", [
    ((10, 50), (1, 3), True, torch.float32, True),
    ((9, 54), (5, 5), True, torch.float32, True),
    ((300, 300), (1, 3), True, torch.float32, True),  # beyond shared memory
    ((10, 50), (1, 3), False, torch.float32, False),
    ((10, 50), (1, 3), True, torch.float64, False),
])
def test_takes_looks_at_device_and_dtype_alone(plane, taps, on_card, dtype,
                                               want):
    """The kernels take every float32 CUDA tensor, whatever its plane: one
    too large for a block's shared memory reaches the kernel, which raises,
    and never the plain version."""
    x = SimpleNamespace(is_cuda=on_card, dtype=dtype, shape=(2, 1, *plane))
    w = SimpleNamespace(is_cuda=on_card, dtype=dtype, shape=(1, 1, *taps))
    assert conv_block.takes(x, w) == want


def test_a_launch_too_large_for_shared_memory_raises():
    """A kernel's return for planes beyond its shared memory raises
    NotImplementedError; any other error RuntimeError; 0 nothing."""
    lib = SimpleNamespace(mmc_error_string=lambda err: b"invalid argument")
    x, w = torch.empty(2, 1, 300, 300), torch.empty(1, 1, 1, 3)
    conv_block._check_launch(lib, 0, "conv_block_fwd", x, w)
    with pytest.raises(NotImplementedError, match=r"\(300, 300\).*shared"):
        conv_block._check_launch(lib, conv_block.PLANE_TOO_LARGE,
                                 "conv_block_bwd", x, w)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        conv_block._check_launch(lib, 1, "conv_block_fwd", x, w)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.randn(2, 1, 4, 5)
    w, b = torch.randn(1, 1, 1, 3), torch.zeros(1)
    with pytest.raises(ValueError, match="Unknown activation"):
        conv_block.conv_block_fwd(x, w, b, "relu")
    with pytest.raises(ValueError, match="takes x"):
        conv_block.conv_block_fwd(torch.randn(2, 2, 4, 5), w, b, "mish")
    with pytest.raises(ValueError, match="contiguous"):
        conv_block.conv_block_fwd(x.transpose(2, 3), w, b, "mish")
    with pytest.raises(ValueError, match="expected g"):
        conv_block.conv_block_bwd(x, torch.randn(2, 1, 4, 6), w, b, "mish")
    with pytest.raises(RuntimeError, match="no kernel"):
        conv_block.conv_block_fwd(x.to("meta"), w.to("meta"), b.to("meta"),
                                  "mish")


FLAGSHIP_SAME = dict(
    num_blocks=2, dimPosIn=66, dimPosEmb=50, dimPosOut=66, in_nTP=10,
    out_nTP=25, conv_nChan=1, conv1_kernel_shape=(1, 3),
    conv1_stride=(1, 1), conv1_padding=None, mode_conv="twice",
    activation="mish", regularization=0.0, use_se=True, r_se=8,
    encoder_n_harmonic_functions=64, encoder_omega0=0.1)

MIXERS = {
    "flagship": FLAGSHIP_SAME,
    "ais_autoregressive_5x5_gelu": dict(
        FLAGSHIP_SAME, dimPosIn=33, dimPosOut=33, out_nTP=5,
        conv1_kernel_shape=(5, 5), activation="gelu",
        encoder_n_harmonic_functions=-1),
}


@pytest.mark.parametrize("name", sorted(MIXERS))
def test_convmixer_through_the_function_matches_jax(name, monkeypatch):
    """A ConvMixer whose blocks take the Function (the CPU's tensors
    counted as the card's): its float32 forward is the JAX package's (the
    flax tests' 2e-5) and the modules' bit for bit; its float64 gradients
    are the modules' (1e-9 of the largest: the gradient written out
    against autograd's chain, with no float32 sum order in the way; some
    leaves, as the encoder's bias under LayerNorm, are 0 but for rounding)."""
    cfg = MIXERS[name]
    model = JaxConvMixer(**cfg)
    rs = np.random.RandomState(3)
    x = (rs.randn(4, cfg["in_nTP"], cfg["dimPosIn"]) * 0.5).astype(np.float32)
    variables = model.init(jax.random.PRNGKey(3), jnp.asarray(x),
                           training=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    want = np.asarray(model.apply(variables, jnp.asarray(x), training=False))
    port = ConvMixer(**cfg)
    port.load_state_dict(state_dict_from_jax(
        variables, cfg["num_blocks"], cfg["encoder_n_harmonic_functions"],
        cfg["encoder_omega0"]), strict=True)
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
    calls = _spy(monkeypatch, on_card=True, dtypes=(torch.float32,
                                                    torch.float64))
    out, grads = run()
    assert len(calls) == 2 * 2 * cfg["num_blocks"]
    np.testing.assert_allclose(out.numpy(), want, atol=2e-5)
    assert torch.equal(out, out_modules)
    scale = max(g.abs().max().item() for g in grads_modules.values())
    for k, want_g in grads_modules.items():
        torch.testing.assert_close(grads[k], want_g, rtol=1e-9,
                                   atol=1e-9 * scale)


def _reader():
    from bench_h100 import harness

    return harness.metric_module("conv_block_bwd_per_step.train")


def test_bench_reader_reads_launches_a_step(monkeypatch):
    """The benchmark's reader: the backward's device launches over the
    process's train steps, untraced and traced; None without a card, before
    the wrapper ever launched a backward, with no launch or no step, and
    where the program has no such module (the parent's)."""
    read = _reader().read
    assert read(None) is None  # no card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(conv_block, "device_launches", lambda: (1000, 48))
    snap = {"untraced": {"train.step": {"count": 5}},
            "traced": {"train.step": {"count": 1}}}
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    monkeypatch.setattr(conv_block.LAUNCHES_BWD, "value", 0)
    assert read(None) is None
    monkeypatch.setattr(conv_block.LAUNCHES_BWD, "value", 24)
    assert read(None) == 8.0
    monkeypatch.setattr(conv_block, "device_launches", lambda: (1000, 0))
    assert read(None) is None
    snap["untraced"], snap["traced"] = {}, {}
    monkeypatch.setattr(conv_block, "device_launches", lambda: (1000, 48))
    assert read(None) is None
    monkeypatch.setitem(sys.modules, "motionmixerconv_tpu_torch.ops.conv_block",
                        None)
    monkeypatch.delattr(sys.modules["motionmixerconv_tpu_torch.ops"],
                        "conv_block")
    assert read(None) is None

"""The launch plan of kernel B2 (the single-channel ConvMixer core,
``ops/conv_mixer.py`` ``b2_plan``), B4's packed layout and placement, and
the domains of both kernels, on the CPU.

The plans are plain Python: one B2 block a sample, how many warps it
gets, how many blocks and how much shared memory. Here every shape
``pack_conv_mixer`` accepted before the plan existed still packs and gets a
plan within one H100 block's shared memory, every sample of B = 1..128 has
a block, and the one-pass shifted LayerNorm the kernel uses agrees with the
two-pass one. ``chip_smoke.py`` checks on the
card that the kernels' libraries agree with these plans.
"""

import numpy as np
import pytest
import torch

from motionmixerconv_tpu_torch.models import ConvMixer, MlpMixer
from motionmixerconv_tpu_torch.ops import conv_mixer, mlp_mixer
from motionmixerconv_tpu_torch.ops._build import MAX_SMEM_BYTES

BATCHES = range(1, 129)

FLAGSHIP = dict(
    num_blocks=4, dimPosIn=66, dimPosEmb=50, dimPosOut=66, in_nTP=10,
    out_nTP=25, conv_nChan=1, conv1_kernel_shape=(1, 3), conv1_stride=(1, 1),
    conv1_padding=(0, 1), mode_conv="twice", activation="mish",
    regularization=0.1, use_se=True, r_se=8, encoder_n_harmonic_functions=64,
    encoder_omega0=0.1)


def _old_smem(spec):
    """Shared memory of the one-block-a-sample B2 that ``pack_conv_mixer``
    bounded before ``b2_plan``: the weights and 3 (T, E) planes, the SE
    vectors and the (P, E) decoder plane."""
    return 4 * (spec.numel() + 3 * spec.T * spec.E + 2 * spec.T
                + max(spec.H, 1) + spec.P * spec.E)


def _widest(cfg, key, grow):
    """The largest value of cfg[key] (stepped by ``grow``) whose model the
    old bound accepted."""
    value = cfg[key]
    while True:
        nxt = grow(value)
        spec = conv_mixer.ConvMixerSpec(**_spec_args(dict(cfg, **{key: nxt})))
        if _old_smem(spec) > MAX_SMEM_BYTES:
            return value
        value = nxt


def _spec_args(cfg):
    k1 = tuple(cfg["conv1_kernel_shape"])
    twice = cfg["mode_conv"] == "twice"
    T = cfg["in_nTP"]
    return dict(T=T, E=cfg["dimPosEmb"], P=cfg["out_nTP"], D=cfg["dimPosOut"],
                H=T // cfg["r_se"] if cfg["use_se"] else 0,
                num_blocks=cfg["num_blocks"], k1=k1,
                k2=k1[::-1] if twice else (1, 1), twice=twice,
                use_se=cfg["use_se"], use_max=cfg.get("use_max_pooling", False),
                activation=cfg["activation"])


_same = dict(conv1_padding=None)
B2_SHAPES = {
    "flagship": FLAGSHIP,
    "bn+maxpool+once": dict(FLAGSHIP, regularization=-1.0,
                            use_max_pooling=True, mode_conv="once"),
    # the widest embedding the old bound took at the flagship's depth
    "widest_E": dict(FLAGSHIP, **_same, dimPosEmb=_widest(
        dict(FLAGSHIP, **_same), "dimPosEmb", lambda e: e + 1)),
    # a long window and a wide (kh, kw) stencil, the widest E the old
    # bound took with them
    "widest_kernel": dict(FLAGSHIP, **_same, in_nTP=16, r_se=4,
                          conv1_kernel_shape=(15, 63), dimPosEmb=_widest(
                              dict(FLAGSHIP, **_same, in_nTP=16, r_se=4,
                                   conv1_kernel_shape=(15, 63)),
                              "dimPosEmb", lambda e: e + 1)),
    "one_row": dict(FLAGSHIP, in_nTP=1, r_se=1, use_se=False),
    "many_rows": dict(FLAGSHIP, in_nTP=64, dimPosEmb=64),
}


def _pack(cfg):
    return conv_mixer.pack_conv_mixer(ConvMixer(**cfg).eval())


@pytest.mark.parametrize("name", sorted(B2_SHAPES))
def test_b2_plan_covers_every_shape_pack_accepted(name):
    """Each shape within the old bound still packs, and at every batch the
    plan is a launch the kernel takes: one block a sample, as many warps as
    time rows up to 16."""
    spec, flat = _pack(B2_SHAPES[name])
    assert _old_smem(spec) <= MAX_SMEM_BYTES
    assert flat.numel() == spec.numel()
    for b in BATCHES:
        plan = conv_mixer.b2_plan(spec, b)
        assert plan.warps == min(spec.T, conv_mixer.MAX_WARPS) >= 1
        assert plan.threads == 32 * plan.warps <= 512
        assert plan.blocks == b


@pytest.mark.parametrize("name", sorted(B2_SHAPES))
def test_b2_plan_fits_shared_memory(name):
    """A sample's floats plus the weights fit one block's shared memory, and
    take less than the old kernel's planes."""
    spec, _ = _pack(B2_SHAPES[name])
    assert spec.smem_bytes() < _old_smem(spec)
    for b in (1, 7, 32, 128):
        plan = conv_mixer.b2_plan(spec, b)
        assert plan.smem == 4 * (spec.numel() + spec.sample_floats()) \
            <= MAX_SMEM_BYTES


@pytest.mark.parametrize("name", ["flagship", "bn+maxpool+once", "many_rows"])
def test_b2_plan_assigns_every_sample(name):
    """Sample b goes to block b, and each warp of the block owns the time
    rows i, i + warps, ...: at every batch each sample has exactly one block
    and each of its rows exactly one warp."""
    spec, _ = _pack(B2_SHAPES[name])
    for b in BATCHES:
        plan = conv_mixer.b2_plan(spec, b)
        assert plan.blocks == b
        rows = [t for w in range(plan.warps)
                for t in range(w, spec.T, plan.warps)]
        assert sorted(rows) == list(range(spec.T))


def test_b2_plan_is_made_once_per_batch():
    """The serving path asks for the plan on every call; it is made once
    per (spec, batch) and the same plan comes back."""
    spec, _ = _pack(FLAGSHIP)
    conv_mixer.b2_plan.cache_clear()
    first = conv_mixer.b2_plan(spec, 7)
    assert conv_mixer.b2_plan(spec, 7) is first
    assert conv_mixer.b2_plan(spec, 8).blocks == 8
    info = conv_mixer.b2_plan.cache_info()
    assert (info.hits, info.misses) == (1, 2)


def test_b2_domain_edges_still_pack():
    """At each edge of B2's domain a shape still packs: the widest E at the
    flagship's depth, the widest stencil, a single time row; one step past
    the shared memory bound it is refused, as before."""
    for name in ("widest_E", "widest_kernel", "one_row"):
        spec, _ = _pack(B2_SHAPES[name])
        assert spec.smem_bytes() <= MAX_SMEM_BYTES
    too_wide = dict(B2_SHAPES["widest_E"],
                    dimPosEmb=2 * B2_SHAPES["widest_E"]["dimPosEmb"])
    with pytest.raises(NotImplementedError, match="limits"):
        _pack(too_wide)


def _layer_norm_one_pass(x):
    """The kernel's LayerNorm statistics in float32: sums shifted by the
    row's first element, one pass (csrc/conv_mixer_fused.cu)."""
    u = x - x[..., :1]
    m = u.sum(-1, keepdim=True) / x.shape[-1]
    q = (u * u).sum(-1, keepdim=True) / x.shape[-1]
    var = torch.clamp(q - m * m, min=0.0)
    return (u - m) / torch.sqrt(var + 1e-5)


@pytest.mark.parametrize("offset,spread", [(0.0, 1.0), (1e3, 1.0),
                                           (-5e2, 1e-2), (0.0, 1e3)])
def test_b2_one_pass_layernorm_matches_two_pass(offset, spread):
    """Rows with a large common offset, a small spread and an outlier
    first element: the one-pass shifted statistics stay within 1e-4 of a
    float64 two-pass LayerNorm (var >= (x0 - mean)^2 / E bounds the
    cancellation)."""
    rs = np.random.RandomState(3)
    x = (offset + spread * rs.randn(64, 50)).astype(np.float32)
    x[::4, 0] += 20 * spread  # an outlier as the shift
    got = _layer_norm_one_pass(torch.from_numpy(x))
    want = torch.nn.functional.layer_norm(
        torch.from_numpy(x).double(), (50,), eps=1e-5)
    assert float((got.double() - want).abs().max()) <= 1e-4


def _mlp_cfg(**kw):
    cfg = dict(num_classes=54, num_blocks=2, hidden_dim=128,
               tokens_mlp_dim=20, channels_mlp_dim=128, seq_len=10,
               pred_len=25, activation="gelu", regularization=0.1,
               input_size=54, r_se=8, use_se=True)
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("over", [dict(), dict(use_se=False),
                                  dict(mlp_block_type="channel_only"),
                                  dict(mlp_block_type="token_only",
                                       seq_len=9, pred_len=13, r_se=4)])
def test_b4_pieces_start_at_16_byte_boundaries(over):
    """Every piece of B4's packed buffer starts at a multiple of 4 floats
    (the kernel copies each weight matrix with a 1-D bulk copy, which
    needs 16-byte ends), and the padding between pieces is zero."""
    model = MlpMixer(**_mlp_cfg(**over)).eval()
    spec, flat = mlp_mixer.pack_mlp_mixer(model)
    embed, block, head = spec.layout()
    off, used = 0, torch.zeros(flat.numel(), dtype=torch.bool)
    for name, n in embed + block * spec.num_blocks + head:
        assert off % 4 == 0, name
        used[off: off + n] = True
        off += mlp_mixer.pad4(n)
    assert off == flat.numel() == spec.numel()
    assert bool((flat[~used] == 0).all())


@pytest.mark.parametrize("over,scratch,nbuf", [
    (dict(), False, 2),                                   # the AMASS shape
    (dict(seq_len=240, pred_len=60), True, 2),            # a long window
    (dict(hidden_dim=300, channels_mlp_dim=260), False, 0),   # a wide shape
    (dict(hidden_dim=160, channels_mlp_dim=160), False, 1),   # one buffer
])
def test_b4_domain_edges_still_pack(over, scratch, nbuf):
    """B4 takes every width and window: activations move to device scratch
    past shared memory, and the weight matrices go through two shared
    buffers, one, or none (read in place) as they fit beside them."""
    spec, flat = mlp_mixer.pack_mlp_mixer(MlpMixer(**_mlp_cfg(**over)).eval())
    assert (spec.uses_scratch, spec.nbufs()) == (scratch, nbuf)
    assert spec.smem_bytes() <= MAX_SMEM_BYTES
    assert flat.numel() == spec.numel()

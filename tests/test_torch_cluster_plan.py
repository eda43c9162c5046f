"""The launch plan of kernel B3 (the multi-channel ConvMixer core as a
thread-block-cluster kernel, ``ops/conv_mixer_mc.py`` ``mc_plan``) and the
decomposition it implies, on the CPU.

The plan is plain Python: how many blocks a cluster has, how they split
the columns, how many threads and how much shared memory each block takes.
Here every split gives each column one owner, every slice is at least its
convs' widest halo, every block fits one H100 block's shared memory, and
the decomposition replayed in plain torch -- column slices with halos read
from the neighbours, the LayerNorm, SE and fc_out partials combined in the
plan's rank order -- gives the kernel's plain twin. ``chip_smoke.py``
checks on the card that the kernel's library agrees with the plan.
"""

import pytest
import torch
import torch.nn.functional as F

from motionmixerconv_tpu_torch.models import ConvMixer
from motionmixerconv_tpu_torch.ops import conv_mixer, conv_mixer_mc
from motionmixerconv_tpu_torch.ops._build import MAX_SMEM_BYTES, slices
from motionmixerconv_tpu_torch.ops.activations import gelu_exact, get_activation

BATCHES = (1, 7, 32, 128)
# the clusters of 1, 2, 4, 8 and 16 blocks an H100 SXM holds at once with one
# block an SM (``conv_mixer_mc.cluster_slots`` asks the card; chip_smoke.py
# phase 11 prints its answer)
H100_SLOTS = ((1, 132), (2, 66), (4, 30), (8, 15), (16, 7))

# the autoregressive CLI's model, the ConvMixer study's shape, and the
# widths the kernel took only once a sample spread over a cluster
AUTOREG = dict(num_blocks=4, dimPosIn=66, dimPosEmb=192, dimPosOut=66,
               in_nTP=10, out_nTP=5, conv_nChan=8, conv1_kernel_shape=(5, 5),
               mode_conv="twice", activation="mish", regularization=-1.0,
               use_se=True, r_se=8, encoder_n_harmonic_functions=0)
B3_SHAPES = {
    "autoregressive": AUTOREG,
    "study": dict(AUTOREG, num_blocks=6, out_nTP=10,
                  conv1_kernel_shape=(5, 9), mode_conv="once",
                  activation="gelu", regularization=0.1),
    "dimPosEmb224": dict(AUTOREG, dimPosEmb=224),
    "dimPosEmb512": dict(AUTOREG, dimPosEmb=512),
    "conv_nChan12": dict(AUTOREG, conv_nChan=12),
}
def _b3_spec(cfg):
    return conv_mixer_mc.pack_conv_mixer_mc(ConvMixer(**cfg).eval())[0]


def _owners(parts, n):
    """Each of n columns appears in exactly one (first, width) slice, in
    rank order and contiguous."""
    cols = [c for first, width in parts for c in range(first, first + width)]
    return cols == list(range(n))


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name", sorted(B3_SHAPES))
def test_b3_plan_splits_the_columns_within_shared_memory(name, batch):
    spec = _b3_spec(B3_SHAPES[name])
    plan = conv_mixer_mc.mc_plan(spec, batch, H100_SLOTS)
    assert plan.K in (1, 2, 4, 8, 16)
    parts = slices(spec.E, plan.K)
    assert _owners(parts, spec.E)
    if plan.K > 1:
        assert min(w for _, w in parts) >= max(spec.halos())
    assert plan.smem == spec.smem_bytes(plan.K) <= MAX_SMEM_BYTES
    assert 32 <= plan.threads <= 640 and plan.threads % 32 == 0
    assert 0 <= plan.tile < len(conv_mixer_mc.TILES)
    # the widest cluster whose clusters the card holds at once
    room = dict(H100_SLOTS)
    assert batch <= room[plan.K] or plan.K == min(spec.cluster_sizes())
    assert all(batch > room[k] for k in spec.cluster_sizes() if k > plan.K)


def test_b3_plan_overrides_and_refusals():
    spec = _b3_spec(B3_SHAPES["dimPosEmb512"])
    assert spec.cluster_sizes() == [4, 8, 16]
    assert conv_mixer_mc.mc_plan(spec, 128, H100_SLOTS, K=8, tile=0).K == 8
    with pytest.raises(NotImplementedError, match="clusters of"):
        conv_mixer_mc.mc_plan(spec, 1, H100_SLOTS, K=2)


# ----------------------------------------------- B3's decomposition replayed

def _in_rank_order(parts):
    total = torch.zeros_like(parts[0])
    for p in parts:
        total = total + p
    return total


def _replay_b3(y, flat, spec, K):
    """conv_mixer_mc's function computed the way a K-block cluster does:
    each block's column slice; LayerNorm statistics, SE squeezes and the
    fc_out contraction as per-block partials combined in rank order; conv
    halos read from the neighbours' LN output, zero at the plane's edges."""
    act = get_activation(spec.activation)
    blocks, g = conv_mixer._unpack(flat, spec)
    C, T, E, Cp = spec.C, spec.T, spec.E, spec.Cp
    parts = slices(E, K)
    ys = [y[..., a:a + w] for a, w in parts]

    def layer_norm(ys, gam, bet):
        mean = _in_rank_order([v.sum(-1) for v in ys]) / E
        var = _in_rank_order([((v - mean[..., None]) ** 2).sum(-1)
                              for v in ys]) / E
        rstd = 1.0 / torch.sqrt(var + 1e-5)
        return [(v - mean[..., None]) * rstd[..., None] * gam[a:a + w]
                + bet[a:a + w] for v, (a, w) in zip(ys, parts)]

    def conv(zs, wflat, bias, k):
        kh, kw = k
        pl, ph = (kw - 1) // 2, (kh - 1) // 2
        pr = kw - 1 - pl
        weight = wflat.view(C, kh, kw, Cp)[..., :C].permute(3, 0, 1, 2)
        out = []
        for r, z in enumerate(zs):
            zero = z[..., :0]
            left = zs[r - 1][..., zs[r - 1].shape[-1] - pl:] if r > 0 else \
                F.pad(zero, (0, pl))
            right = zs[r + 1][..., :pr] if r + 1 < K else F.pad(zero, (0, pr))
            zp = F.pad(torch.cat([left, z, right], -1), (0, 0, ph, kh - 1 - ph))
            out.append(F.conv2d(zp, weight.contiguous(), bias))
        return out

    def gated(ys, cs, w):
        if not spec.use_se:
            return [v + c for v, c in zip(ys, cs)]
        if spec.use_max:
            sq = torch.stack([c.amax(dim=(1, 3)) for c in cs]).amax(0)
        else:
            sq = _in_rank_order([c.sum(dim=(1, 3)) for c in cs]) / (C * E)
        h = torch.relu(sq @ w["se_w1"].view(T, spec.H))
        gate = torch.sigmoid(h @ w["se_w2"].view(spec.H, T))
        return [v + c * gate[:, None, :, None] for v, c in zip(ys, cs)]

    def affine(sc, row):
        return sc.view(6, Cp)[row, :C][None, :, None, None]

    for w in blocks:
        sc = w["scal"]
        zs = conv(layer_norm(ys, w["ln1_g"], w["ln1_b"]), w["w1"],
                  sc.view(6, Cp)[0, :C], spec.k1)
        ys = gated(ys, [act(z) * affine(sc, 1) + affine(sc, 2) for z in zs], w)
        if spec.twice:
            zs = conv(layer_norm(ys, w["ln2_g"], w["ln2_b"]), w["w2"],
                      sc.view(6, Cp)[3, :C], spec.k2)
            ys = gated(ys, [act(z) * affine(sc, 4) + affine(sc, 5)
                            for z in zs], w)
        else:
            ys = gated(ys, ys, w)
    ds = []
    for z in layer_norm(ys, g["g_ln"], g["b_ln"]):  # per column, local
        d = torch.einsum("bcte,tp->bcpe", z, g["w_time"].view(T, spec.P))
        d = d + g["b_time"][None, None, :, None]
        ds.append(gelu_exact(torch.einsum("bcpe,c->bpe", d, g["w_chan"])
                             + g["b_proj"]))
    w_out = g["w_out"].view(E, spec.D)
    return _in_rank_order([d @ w_out[a:a + w] for d, (a, w)
                           in zip(ds, parts)]) + g["b_out"]


SMALL_B3 = {
    "twice_mish_bn": dict(num_blocks=2, dimPosIn=66, dimPosEmb=40,
                          dimPosOut=66, in_nTP=6, out_nTP=4, conv_nChan=3,
                          conv1_kernel_shape=(3, 5), mode_conv="twice",
                          activation="mish", regularization=-1.0, use_se=True,
                          r_se=2, encoder_n_harmonic_functions=0),
    "once_gelu_k59": dict(num_blocks=2, dimPosIn=66, dimPosEmb=48,
                          dimPosOut=66, in_nTP=6, out_nTP=3, conv_nChan=4,
                          conv1_kernel_shape=(5, 9), mode_conv="once",
                          activation="gelu", regularization=0.1, use_se=True,
                          r_se=3, encoder_n_harmonic_functions=0),
    "even_k24_maxpool": dict(num_blocks=1, dimPosIn=66, dimPosEmb=36,
                             dimPosOut=66, in_nTP=5, out_nTP=2, conv_nChan=2,
                             conv1_kernel_shape=(2, 4), mode_conv="twice",
                             activation="gelu", regularization=0.0,
                             use_se=True, r_se=2, use_max_pooling=True,
                             encoder_n_harmonic_functions=0),
    "no_se": dict(num_blocks=1, dimPosIn=66, dimPosEmb=33, dimPosOut=66,
                  in_nTP=4, out_nTP=2, conv_nChan=3, conv1_kernel_shape=(3, 3),
                  mode_conv="twice", activation="mish", regularization=0.0,
                  use_se=False, encoder_n_harmonic_functions=0),
}


@pytest.mark.parametrize("name", sorted(SMALL_B3))
def test_b3_cluster_decomposition_replays_the_plain_version(name):
    torch.manual_seed(0)
    model = ConvMixer(**SMALL_B3[name],
                      generator=torch.Generator().manual_seed(1)).eval()
    spec, flat = conv_mixer_mc.pack_conv_mixer_mc(model)
    y = torch.randn(3, spec.C, spec.T, spec.E)
    want = conv_mixer_mc.conv_mixer_mc_plain(y, flat, spec)
    assert len(spec.cluster_sizes()) >= 3
    for K in spec.cluster_sizes():
        got = _replay_b3(y, flat, spec, K)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)

"""The frozen operation and byte counts give ``chip_smoke.py``'s own values
(at R = 500 and 2,560 rows, B = 1 and 128 samples), and the peaks are the
port's ``profiling`` tables."""

import pytest
import torch

from bench_h100.work import yardsticks as y

chip_smoke = pytest.importorskip("chip_smoke")


@pytest.mark.parametrize("rows", [500, 2560])
@pytest.mark.parametrize("impl", ["direct", "doubling"])
def test_b1(rows, impl):
    shape = (rows, 66, 64, 50)
    assert y.b1_work(*shape, impl) == chip_smoke.b1_work(*shape, impl)
    for dx in (False, True):
        assert (y.b1_bwd_work(*shape, impl, dx)
                == chip_smoke.b1_bwd_work(*shape, impl, dx))


def _conv_model(**kw):
    from motionmixerconv_tpu_torch.models import ConvMixer

    args = dict(num_blocks=4, dimPosIn=66, dimPosEmb=50, dimPosOut=66,
                in_nTP=10, out_nTP=25, conv_nChan=1, conv1_kernel_shape=(1, 3),
                activation="mish", regularization=0.1, use_se=True, r_se=8)
    args.update(kw)
    return ConvMixer(**args).eval()


@pytest.mark.parametrize("batch", [1, 128])
def test_b2_and_the_benchmarks_own_spec(batch):
    from motionmixerconv_tpu_torch.ops.conv_mixer import pack_conv_mixer

    spec, w = pack_conv_mixer(_conv_model())
    n = w.numel()
    assert y.b2_work(spec, batch, n) == chip_smoke.b2_work(spec, batch, n)
    mine = y.ConvSpec(T=10, E=50, P=25, D=66, H=1, num_blocks=4, k1=(1, 3),
                      k2=(3, 1))
    assert y.b2_work(mine, batch, n) == chip_smoke.b2_work(spec, batch, n)


@pytest.mark.parametrize("batch", [1, 128])
def test_b3(batch):
    from motionmixerconv_tpu_torch.ops.conv_mixer_mc import pack_conv_mixer_mc

    model = _conv_model(dimPosEmb=192, out_nTP=5, conv_nChan=8,
                        conv1_kernel_shape=(5, 5), regularization=-1.0,
                        encoder_n_harmonic_functions=0, encoder_omega0=0.0)
    spec, w = pack_conv_mixer_mc(model)[:2]
    n = w.numel()
    assert y.b3_work(spec, batch, n) == chip_smoke.b3_work(spec, batch, n)


@pytest.mark.parametrize("batch", [1, 128])
def test_b4(batch):
    from motionmixerconv_tpu_torch.models import MlpMixer
    from motionmixerconv_tpu_torch.ops.mlp_mixer import pack_mlp_mixer

    model = MlpMixer(num_classes=54, num_blocks=5, hidden_dim=128,
                     tokens_mlp_dim=20, channels_mlp_dim=128, seq_len=10,
                     pred_len=25, activation="gelu", regularization=0.1,
                     input_size=54, r_se=8, use_se=True).eval()
    spec = pack_mlp_mixer(model)[0]
    n = chip_smoke.model_floats(model)
    assert y.b4_work(spec, batch, n) == chip_smoke.b4_work(spec, batch, n)


def test_bound_and_peaks():
    from motionmixerconv_tpu_torch import profiling

    assert y.PEAK_FLOPS_F32 == profiling.PEAK_FLOPS_F32
    assert y.PEAK_BYTES == profiling.PEAK_BYTES
    for nbytes, ops in [(10 ** 6, 10 ** 6), (10 ** 3, 10 ** 9), (0, 1)]:
        assert y.bound(nbytes, ops) == chip_smoke.bound(nbytes, ops)

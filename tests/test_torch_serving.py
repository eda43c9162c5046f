"""The port's serving path on the CPU: Predictor routing against the JAX
package's Predictor, the micro-batching server, checkpoints, the refusal to
run without a card by default, and the port's independence from JAX."""

import ast
import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionmixerconv_tpu.models import ConvMixer as JaxConvMixer
from motionmixerconv_tpu.serving import Predictor as JaxPredictor
from motionmixerconv_tpu_torch import serving_server
from motionmixerconv_tpu_torch.models import ConvMixer, state_dict_from_jax
from motionmixerconv_tpu_torch.ops import conv_mixer, conv_mixer_mc, harmonic
from motionmixerconv_tpu_torch.serving import Predictor
from motionmixerconv_tpu_torch.serving_server import BatchingPredictor, PredictionServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the flagship serving structure (serving_server.main's defaults) at 2 blocks
FLAGSHIP_2B = dict(
    num_blocks=2, dimPosIn=66, dimPosEmb=50, dimPosOut=66, in_nTP=10,
    out_nTP=25, conv_nChan=1, conv1_kernel_shape=(1, 3), conv1_stride=(1, 1),
    conv1_padding=(0, 1), mode_conv="twice", activation="mish",
    regularization=0.1, use_se=True, r_se=8, encoder_n_harmonic_functions=64,
    encoder_omega0=0.1)
SMALL = dict(FLAGSHIP_2B, num_blocks=1, dimPosEmb=24, out_nTP=5,
             encoder_n_harmonic_functions=4)


def _both(cfg, seed=0):
    """The JAX model's variables and the port's model loaded from them."""
    jmodel = JaxConvMixer(**cfg)
    variables = jmodel.init(jax.random.PRNGKey(seed),
                            jnp.zeros((1, cfg["in_nTP"], cfg["dimPosIn"])),
                            training=False)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    sd = state_dict_from_jax(variables, cfg["num_blocks"],
                             cfg["encoder_n_harmonic_functions"],
                             cfg["encoder_omega0"])
    return jmodel, variables, sd


def _x(batch, cfg, seed=1):
    rs = np.random.RandomState(seed)
    return (rs.randn(batch, cfg["in_nTP"], cfg["dimPosIn"]) * 0.5).astype(
        np.float32)


def _small_predictor(**kw):
    _, _, sd = _both(SMALL)
    return Predictor(ConvMixer(**SMALL), sd, device="cpu", **kw)


def test_predict_routes_by_batch_and_matches_jax():
    """B <= fused_max_batch goes through the B2 wrapper (its plain version
    on the CPU), larger batches through the plain model forward; both match
    the JAX Predictor. Tolerances: 3e-4 for the fused path (the Pallas
    kernel's own test tolerance), 2e-5 for the plain forward (the model
    parity tolerance)."""
    jmodel, variables, sd = _both(FLAGSHIP_2B)
    jp = JaxPredictor(jmodel, variables)
    p = Predictor(ConvMixer(**FLAGSHIP_2B), sd, device="cpu", fused_max_batch=4)
    assert p.fused_fallback_reason is None

    small, big = _x(3, FLAGSHIP_2B), _x(6, FLAGSHIP_2B, seed=2)
    before = conv_mixer.PLAIN_CALLS.value
    got = p.predict(small)
    assert conv_mixer.PLAIN_CALLS.value == before + 1
    assert got.device.type == "cpu" and got.shape == (3, 25, 66)
    np.testing.assert_allclose(got.numpy(), np.asarray(jp.predict(small)),
                               atol=3e-4)

    got = p.predict(big)
    assert conv_mixer.PLAIN_CALLS.value == before + 1  # not the fused path
    np.testing.assert_allclose(got.numpy(), np.asarray(jp.predict(big)),
                               atol=2e-5)


def test_bulk_path_with_fused_encoder_matches_jax():
    """Above fused_max_batch an encoder_fused model runs the B1 wrapper."""
    cfg = dict(FLAGSHIP_2B, encoder_fused=True)
    jmodel, variables, sd = _both(cfg)
    x = _x(5, cfg)
    want = np.asarray(JaxPredictor(jmodel, variables).predict(x))
    p = Predictor(ConvMixer(**cfg), sd, device="cpu", fused_max_batch=2)
    before = (harmonic.PLAIN_CALLS.value, conv_mixer.PLAIN_CALLS.value)
    got = p.predict(x).numpy()
    assert harmonic.PLAIN_CALLS.value == before[0] + 1
    assert conv_mixer.PLAIN_CALLS.value == before[1]
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_predict_autoregressive_matches_jax():
    jmodel, variables, sd = _both(SMALL)
    x = _x(4, SMALL)
    want = np.asarray(JaxPredictor(jmodel, variables).predict_autoregressive(
        x, horizon=12))
    got = Predictor(ConvMixer(**SMALL), sd, device="cpu").predict_autoregressive(
        x, horizon=12).numpy()
    assert got.shape == want.shape == (4, 12, 66)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_pt_checkpoint_roundtrip(tmp_path):
    """A .pt round trip serves bit for bit; a JAX-written .ckpt (no meta)
    of the same model serves in the given model as the JAX Predictor does
    (2e-5, the plain-forward parity tolerance)."""
    from motionmixerconv_tpu.train import make_optimizer as jax_make_optimizer
    from motionmixerconv_tpu.train.state import TrainState
    from motionmixerconv_tpu.train.state import save_checkpoint as jax_save

    p = _small_predictor()
    path = str(tmp_path / "model.pt")
    torch.save(p.model.state_dict(), path)
    q = Predictor.from_checkpoint(ConvMixer(**SMALL), path, device="cpu")
    x = _x(3, SMALL)
    torch.testing.assert_close(q.predict(x), p.predict(x), atol=0, rtol=0)
    with pytest.raises(ValueError, match="no architecture"):
        Predictor.from_checkpoint(None, path, device="cpu")
    jmodel, variables, _ = _both(SMALL)
    ckpt = str(tmp_path / "m.ckpt")
    jax_save(ckpt, TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats={}, opt_state=jax_make_optimizer(1e-3).init(
            variables["params"]), rng=jax.random.PRNGKey(0)), 0)
    r = Predictor.from_checkpoint(ConvMixer(**SMALL), ckpt, device="cpu",
                                  use_fused=False)
    np.testing.assert_allclose(
        r.predict(x).numpy(), np.asarray(JaxPredictor(jmodel, variables)
                                         .predict(jnp.asarray(x))), atol=2e-5)
    with pytest.raises(ValueError, match="no architecture"):
        Predictor.from_checkpoint(None, ckpt, device="cpu")
    with pytest.raises(TypeError, match="DataMesh"):
        Predictor(ConvMixer(**SMALL), device="cpu", mesh=object())


def test_replicate_to_copies_the_weights():
    p = _small_predictor()
    q = p.replicate_to("cpu")
    assert q.model is not p.model and q._fused is not p._fused
    x = _x(2, SMALL)
    torch.testing.assert_close(q.predict(x), p.predict(x), atol=0, rtol=0)


def test_shapes_outside_the_kernel_fall_back_with_a_warning():
    # conv_nChan * in_nTP = 130 > 128: outside B3, as outside the JAX kernel
    cfg = dict(SMALL, conv_nChan=13)
    with pytest.warns(UserWarning, match="fused kernel unavailable"):
        p = Predictor(ConvMixer(**cfg), device="cpu")
    assert "conv_nChan" in p.fused_fallback_reason
    before = (conv_mixer.PLAIN_CALLS.value, conv_mixer_mc.PLAIN_CALLS.value)
    assert p.predict(_x(2, cfg)).shape == (2, 5, 66)
    assert (conv_mixer.PLAIN_CALLS.value,
            conv_mixer_mc.PLAIN_CALLS.value) == before


def test_wide_multichannel_model_gets_b3():
    """conv_nChan 8 at dimPosEmb 224: planes beyond one block's shared
    memory, taken by B3's clusters, so the Predictor routes to the fused
    kernel with no fallback."""
    cfg = dict(num_blocks=1, dimPosIn=66, dimPosEmb=224, dimPosOut=66,
               in_nTP=10, out_nTP=5, conv_nChan=8, conv1_kernel_shape=(5, 5),
               mode_conv="twice", activation="mish", regularization=-1.0,
               use_se=True, r_se=8, encoder_n_harmonic_functions=0)
    model = ConvMixer(**cfg, generator=torch.Generator().manual_seed(0))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        p = Predictor(model, device="cpu")
    assert type(p._fused).__name__ == "FusedConvMixerMC"
    assert p.fused_fallback_reason is None
    assert 1 not in p._fused.spec.cluster_sizes()
    x = _x(2, cfg)
    before = conv_mixer_mc.PLAIN_CALLS.value
    got = p.predict(x)
    assert conv_mixer_mc.PLAIN_CALLS.value == before + 1
    with torch.no_grad():
        want = p.model(torch.from_numpy(x))
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


def test_predict_routes_multichannel_to_b3_and_matches_jax():
    """A conv_nChan >= 2 BatchNorm model (the autoregressive family) goes
    through the B3 wrapper at B <= fused_max_batch and the plain forward
    above, both against the JAX Predictor. Tolerances as for B2: 3e-4 on
    the fused path (the Pallas kernel's test tolerance), 2e-5 on the plain
    forward."""
    cfg = dict(SMALL, conv_nChan=4, conv1_kernel_shape=(3, 3),
               conv1_padding=None, regularization=-1.0,
               encoder_n_harmonic_functions=0)
    jmodel, variables, sd = _both(cfg)
    jp = JaxPredictor(jmodel, variables)
    p = Predictor(ConvMixer(**cfg), sd, device="cpu", fused_max_batch=4)
    assert type(p._fused).__name__ == "FusedConvMixerMC"
    small, big = _x(3, cfg), _x(6, cfg, seed=2)
    before = conv_mixer_mc.PLAIN_CALLS.value
    np.testing.assert_allclose(p.predict(small).numpy(),
                               np.asarray(jp.predict(small)), atol=3e-4)
    assert conv_mixer_mc.PLAIN_CALLS.value == before + 1
    np.testing.assert_allclose(p.predict(big).numpy(),
                               np.asarray(jp.predict(big)), atol=2e-5)
    assert conv_mixer_mc.PLAIN_CALLS.value == before + 1
    q = p.replicate_to("cpu")
    assert type(q._fused).__name__ == "FusedConvMixerMC" and q._fused is not p._fused
    torch.testing.assert_close(q.predict(small), p.predict(small), rtol=0, atol=0)


def _train_state(tmp_path, cli_module, argv, in_ntp, out_ntp):
    """A trainer's train_state.pt for a model built from ``argv`` by the
    port's CLI parser, as the CLI's run would write it."""
    from motionmixerconv_tpu_torch.cli._runner import build_conv_mixer
    from motionmixerconv_tpu_torch.train import make_optimizer, save_checkpoint

    args = cli_module.parse_args(argv)
    if hasattr(args, "kernel1_x"):
        args.conv1_kernel_shape = (args.kernel1_x, args.kernel1_y)
    model = build_conv_mixer(args, 66, 66, in_ntp, out_ntp,
                             generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "train_state.pt")
    save_checkpoint(path, model, make_optimizer(model.parameters(), lr=1e-3),
                    0, meta=vars(args))
    return path, model.eval()


AR_SMALL_ARGV = ["--loss_type", "mpjpe", "--num_blocks", "1",
                 "--hidden_dim", "16", "--conv_nChan", "3", "--kernel1_x", "3"]


def test_from_checkpoint_rebuilds_the_model_from_train_state(tmp_path):
    """``model=None`` rebuilds the trained architecture from the
    train_state.pt meta, for both trainers' checkpoints, and serves it:
    the autoregressive model through B3, the direct one through B2."""
    from motionmixerconv_tpu_torch.cli import train_autoreg_mixer_h36m, train_mixer_h36m

    path, model = _train_state(tmp_path, train_autoreg_mixer_h36m,
                               AR_SMALL_ARGV, 10, 5)
    p = Predictor.from_checkpoint(None, path, device="cpu")
    assert type(p._fused).__name__ == "FusedConvMixerMC"
    assert (p.model.conv_nChan, p.model.dimPosEmb, p.model.out_nTP) == (3, 16, 5)
    assert p.model.conv1_kernel_shape == (3, 5) and p.model.regularization == -1.0
    x = _x(4, dict(in_nTP=10, dimPosIn=66))
    with torch.no_grad():
        want = model(torch.from_numpy(x))
    torch.testing.assert_close(p.predict(x), want, rtol=0, atol=2e-5)

    d = tmp_path / "direct"
    d.mkdir()
    path, model = _train_state(
        d, train_mixer_h36m, ["--loss_type", "mpjpe", "--num_blocks", "1",
                              "--hidden_dim", "12"], 10, 25)
    p = Predictor.from_checkpoint(None, path, device="cpu")
    assert type(p._fused).__name__ == "FusedConvMixer"
    with torch.no_grad():
        want = model(torch.from_numpy(x))
    torch.testing.assert_close(p.predict(x), want, rtol=0, atol=2e-5)


def test_model_from_checkpoint_meta_rebuilds_the_mlp_family():
    """The MlpMixer family's metas rebuild: H36M
    ``model_type mlp`` on 66 dims and AMASS (no model_type, no kernel
    flags) on ``pose_dim``, with the stored widths."""
    from motionmixerconv_tpu_torch.cli import train_mixer_amass, train_mixer_h36m
    from motionmixerconv_tpu_torch.cli._runner import model_from_checkpoint_meta
    from motionmixerconv_tpu_torch.models import MlpMixer

    h36m = vars(train_mixer_h36m.parse_args(
        ["--loss_type", "mpjpe", "--model_type", "mlp", "--num_blocks", "1",
         "--hidden_dim", "12"]))
    model = model_from_checkpoint_meta(h36m)
    assert isinstance(model, MlpMixer)
    assert (model.input_size, model.num_classes, model.hidden_dim,
            model.num_blocks, model.channels_mlp_dim, model.activation) == (
        66, 66, 12, 1, 50, "mish")
    amass = vars(train_mixer_amass.parse_args(["--hidden_dim", "16"]))
    model = model_from_checkpoint_meta(amass)
    assert isinstance(model, MlpMixer)
    assert (model.input_size, model.seq_len, model.pred_len, model.hidden_dim,
            model.num_blocks, model.r_se, model.use_se) == (
        54, 10, 25, 16, 5, 8, True)


# an MlpMixer at a small width, as build_mlp_mixer makes it (SE on, r 8)
MLP_SMALL = dict(num_classes=54, num_blocks=2, hidden_dim=16,
                 tokens_mlp_dim=8, channels_mlp_dim=24, seq_len=10,
                 pred_len=25, activation="gelu", regularization=0.1,
                 input_size=54, r_se=8, use_se=True)


def _mlp_both(cfg, seed=0):
    from motionmixerconv_tpu.models import MlpMixer as JaxMlpMixer

    jmodel = JaxMlpMixer(**cfg)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, cfg["seq_len"],
                                             cfg["input_size"])),
        training=False))
    return jmodel, variables, state_dict_from_jax(variables,
                                                  cfg["num_blocks"])


def test_predict_routes_mlp_mixer_to_b4_and_matches_jax():
    """An MlpMixer goes through the B4 wrapper (its plain version on the
    CPU) at B <= fused_max_batch and the plain forward above, both against
    the JAX Predictor (which runs the flax forward off the TPU): 2e-4 on
    the fused path (the Pallas kernel's test tolerance), 2e-5 on the plain
    forward; predict_autoregressive too."""
    from motionmixerconv_tpu_torch.models import MlpMixer
    from motionmixerconv_tpu_torch.ops import mlp_mixer

    jmodel, variables, sd = _mlp_both(MLP_SMALL)
    jp = JaxPredictor(jmodel, variables)
    p = Predictor(MlpMixer(**MLP_SMALL), sd, device="cpu", fused_max_batch=4)
    assert type(p._fused).__name__ == "FusedMlpMixer"
    assert p.fused_fallback_reason is None
    rs = np.random.RandomState(3)
    small = (rs.randn(3, 10, 54) * 0.5).astype(np.float32)
    big = (rs.randn(6, 10, 54) * 0.5).astype(np.float32)
    before = mlp_mixer.PLAIN_CALLS.value
    np.testing.assert_allclose(p.predict(small).numpy(),
                               np.asarray(jp.predict(small)), atol=2e-4)
    assert mlp_mixer.PLAIN_CALLS.value == before + 1
    np.testing.assert_allclose(p.predict(big).numpy(),
                               np.asarray(jp.predict(big)), atol=2e-5)
    assert mlp_mixer.PLAIN_CALLS.value == before + 1
    want = np.asarray(jp.predict_autoregressive(small, horizon=20))
    got = p.predict_autoregressive(small, horizon=20).numpy()
    assert got.shape == want.shape == (3, 20, 54)
    np.testing.assert_allclose(got, want, atol=2e-5)
    q = p.replicate_to("cpu")
    assert type(q._fused).__name__ == "FusedMlpMixer" and q._fused is not p._fused
    torch.testing.assert_close(q.predict(small), p.predict(small), rtol=0,
                               atol=0)


def test_mlp_mixer_outside_b4_falls_back_with_a_warning(monkeypatch):
    from motionmixerconv_tpu_torch.models import MlpMixer
    from motionmixerconv_tpu_torch.ops import mlp_mixer

    monkeypatch.setattr(mlp_mixer, "_INT_MAX", 1000)
    with pytest.warns(UserWarning, match="fused kernel unavailable"):
        p = Predictor(MlpMixer(**MLP_SMALL), device="cpu")
    assert p._fused is None and "32-bit" in p.fused_fallback_reason
    before = mlp_mixer.PLAIN_CALLS.value
    assert p.predict(np.zeros((2, 10, 54), np.float32)).shape == (2, 25, 54)
    assert mlp_mixer.PLAIN_CALLS.value == before


def test_serving_cli_serves_the_mlp_mixer(tmp_path):
    """``--arch mlp`` builds the MlpMixer from the shape flags for a bare
    state_dict; ``--arch auto`` rebuilds an AMASS train_state.pt; the
    server warms up with the MlpMixer's input shape and answers /predict
    with what the model computes."""
    from motionmixerconv_tpu_torch.cli import train_mixer_amass
    from motionmixerconv_tpu_torch.cli._runner import build_mlp_mixer
    from motionmixerconv_tpu_torch.models import MlpMixer
    from motionmixerconv_tpu_torch.ops import mlp_mixer
    from motionmixerconv_tpu_torch.train import make_optimizer, save_checkpoint

    parse = serving_server.build_parser().parse_args
    bare = str(tmp_path / "m.pt")
    model = MlpMixer(**dict(MLP_SMALL, activation="mish"),
                     generator=torch.Generator().manual_seed(0)).eval()
    torch.save(model.state_dict(), bare)
    p = serving_server.load_predictor(parse(
        ["--model_path", bare, "--arch", "mlp", "--pose_dim", "54",
         "--num_blocks", "2", "--hidden_dim", "16", "--tokens_mlp_dim", "8",
         "--channels_mlp_dim", "24"]), "cpu")
    assert type(p._fused).__name__ == "FusedMlpMixer"
    x = (np.random.RandomState(4).randn(3, 10, 54) * 0.5).astype(np.float32)
    with torch.no_grad():
        torch.testing.assert_close(p.predict(x), model(torch.from_numpy(x)),
                                   rtol=0, atol=2e-5)

    args = train_mixer_amass.parse_args(["--num_blocks", "1", "--hidden_dim",
                                         "12", "--channels_mlp_dim", "12"])
    trained = build_mlp_mixer(args, 54, 10, 25,
                              generator=torch.Generator().manual_seed(1))
    path = str(tmp_path / "train_state.pt")
    save_checkpoint(path, trained,
                    make_optimizer(trained.parameters(), lr=1e-3), 0,
                    meta=vars(args))
    p = serving_server.load_predictor(parse(["--model_path", path]), "cpu")
    assert isinstance(p.model, MlpMixer) and p.model.hidden_dim == 12
    before = mlp_mixer.PLAIN_CALLS.value
    server = PredictionServer(p, port=0, max_wait_ms=1.0, warmup=True)
    server.start_background()
    try:  # warmed up: every bucket once through B4 (plain on the CPU)
        assert mlp_mixer.PLAIN_CALLS.value == before + len(
            server.batcher.buckets)
        out = _post(f"http://127.0.0.1:{server.port}", "/predict",
                    {"inputs": x.tolist()})["outputs"]
    finally:
        server.close()
    with torch.no_grad():
        want = trained.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(out, np.float32), want, atol=2e-5)


def test_serving_cli_arch_auto_rebuilds_from_train_state(tmp_path, monkeypatch):
    """``--arch auto`` serves a train_state.pt as its meta describes, over
    shape flags that say otherwise, reading the file once; a bare
    state_dict takes the flags."""
    from motionmixerconv_tpu_torch.cli import train_autoreg_mixer_h36m

    path, model = _train_state(tmp_path, train_autoreg_mixer_h36m,
                               AR_SMALL_ARGV, 10, 5)
    parse = serving_server.build_parser().parse_args
    loads = []
    real_load = torch.load
    monkeypatch.setattr(torch, "load",
                        lambda *a, **k: loads.append(a[0]) or real_load(*a, **k))
    p = serving_server.load_predictor(parse(["--model_path", path]), "cpu")
    assert loads == [path]
    monkeypatch.setattr(torch, "load", real_load)
    assert type(p._fused).__name__ == "FusedConvMixerMC"
    x = _x(2, dict(in_nTP=10, dimPosIn=66))
    with torch.no_grad():
        torch.testing.assert_close(p.predict(x), model(torch.from_numpy(x)),
                                   rtol=0, atol=2e-5)
    with pytest.raises(RuntimeError, match="state_dict"):  # flags disagree
        serving_server.load_predictor(
            parse(["--model_path", path, "--arch", "conv"]), "cpu")

    bare = str(tmp_path / "m.pt")
    torch.save(ConvMixer(**SMALL).state_dict(), bare)
    flags = ["--model_path", bare, "--num_blocks", "1", "--hidden_dim", "24",
             "--output_n", "5", "--n_harmonic_functions", "4"]
    p = serving_server.load_predictor(parse(flags), "cpu")
    assert type(p._fused).__name__ == "FusedConvMixer"
    assert p.predict(_x(2, SMALL)).shape == (2, 5, 66)


def test_default_device_raises_without_a_card(monkeypatch, tmp_path):
    """Entry points run on the card unless the caller asks for the CPU; with
    no card they raise instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(ConvMixer(**SMALL))
    path = str(tmp_path / "m.pt")
    torch.save(ConvMixer(**SMALL).state_dict(), path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving_server.main(["--model_path", path, "--port", "0"])


def test_card_device_pins_float32(monkeypatch):
    """Serving on the card turns TF32 off for cuDNN and cuBLAS, so the plain
    forward's convolutions compute in float32 as the JAX reference does."""
    from motionmixerconv_tpu_torch.serving import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    resolve_device("cpu")
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    assert resolve_device("cuda").type == "cuda"
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32


# ---------------------------------------------------------------- batching


def _concurrent(b, xs, join_timeout=30):
    results = [None] * len(xs)

    def worker(i):
        results[i] = b.predict(xs[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(xs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=join_timeout)
    assert not any(t.is_alive() for t in threads)
    return results


def test_batching_predictor_coalesces_and_matches():
    p = _small_predictor()
    b = BatchingPredictor(p, max_batch=64, max_wait_ms=30.0)
    rs = np.random.RandomState(0)
    xs = [rs.randn(3, 10, 66).astype(np.float32) for _ in range(12)]
    want = [p.predict(x).numpy() for x in xs]
    try:
        results = _concurrent(b, xs)
    finally:
        b.close()
    for got, exp in zip(results, want):
        np.testing.assert_allclose(got, exp, atol=1e-5)
    s = b.stats()
    assert s["requests"] == 12 and s["rows"] == 36
    assert s["batches"] < s["requests"]
    assert s["mean_batch_rows"] > 3.0
    assert all(k in (8, 16, 32, 64) for k in s["bucket_counts"])


def test_bucket_warmup_and_error_propagation():
    p = _small_predictor()
    b = BatchingPredictor(p, max_batch=32, max_wait_ms=1.0)
    try:
        assert b.buckets == [8, 16, 32]
        b.warmup((10, 66))
        out = b.predict(np.zeros((5, 10, 66), np.float32))
        assert out.shape == (5, 5, 66) and isinstance(out, np.ndarray)
        assert 8 in b.stats()["bucket_counts"]
        with pytest.raises(ValueError):  # wrong T: the wrapper rejects it
            b.predict(np.zeros((1, 9, 66), np.float32))
        # the worker survived and still serves
        assert b.predict(np.zeros((2, 10, 66), np.float32)).shape == (2, 5, 66)
    finally:
        b.close()


def test_drain_never_overshoots_max_batch():
    p = _small_predictor()
    b = BatchingPredictor(p, max_batch=16, max_wait_ms=40.0)
    rs = np.random.RandomState(1)
    xs = [rs.randn(10, 10, 66).astype(np.float32) for _ in range(6)]
    want = [p.predict(x).numpy() for x in xs]
    try:
        results = _concurrent(b, xs)
    finally:
        b.close()
    for got, w in zip(results, want):
        np.testing.assert_allclose(got, w, atol=1e-5)
    assert b.bucket_counts and max(b.bucket_counts) <= 16, b.bucket_counts


def test_close_unblocks_pending_clients():
    b = BatchingPredictor(_small_predictor(), max_batch=8, max_wait_ms=1.0)
    b._stop.set()  # freeze the batcher loop so the request stays queued
    for t in b._threads:
        t.join(timeout=5)
    errors = []

    def worker():
        try:
            b.predict(np.zeros((2, 10, 66), np.float32))
        except RuntimeError as e:
            errors.append(e)

    t = threading.Thread(target=worker)
    t.start()
    time.sleep(0.2)
    b.close()
    t.join(timeout=5)
    assert not t.is_alive(), "client still blocked after close()"
    assert errors and "closed" in str(errors[0])


def _post(base, path, payload):
    req = urllib.request.Request(
        f"{base}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_http_server_roundtrip():
    p = _small_predictor()
    server = PredictionServer(p, port=0, max_wait_ms=5.0, warmup=True)
    server.start_background()
    base = f"http://127.0.0.1:{server.port}"
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=10) as r:
            health = json.loads(r.read())
        assert health["status"] == "ok" and health["device"] == "cpu"
        assert health["n_devices"] == torch.cuda.device_count()

        x = _x(4, SMALL)
        out = np.asarray(_post(base, "/predict", {"inputs": x.tolist()})["outputs"],
                         np.float32)
        np.testing.assert_allclose(out, p.predict(x).numpy(), atol=1e-5)

        out = np.asarray(_post(base, "/predict_autoregressive",
                               {"inputs": x.tolist(), "horizon": 12})["outputs"],
                         np.float32)
        np.testing.assert_allclose(
            out, p.predict_autoregressive(x, horizon=12).numpy(), atol=1e-5)

        with pytest.raises(urllib.error.HTTPError) as err:
            _post(base, "/predict", {"inputs": [1.0, 2.0]})
        assert err.value.code == 400

        with urllib.request.urlopen(f"{base}/stats", timeout=10) as r:
            assert json.loads(r.read())["requests"] >= 1
    finally:
        server.close()


# ------------------------------------------------------------ independence


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port imports cleanly in a fresh interpreter that
    then holds no jax and no module of the JAX package (whose name is a
    prefix of the port's, so a plain startswith check would be wrong), and
    none of msgpack, pandas and optuna, which the card's machine lacks."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import motionmixerconv_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'motionmixerconv_tpu')\n"
        "       or m.startswith(('jax.', 'flax.', 'motionmixerconv_tpu.'))]\n"
        "absent = [m for m in ('msgpack', 'pandas', 'optuna') if m in sys.modules]\n"
        "assert len(names) >= 10, names\n"
        "assert not bad, bad\n"
        "assert not absent, absent\n"
        "print('ok', len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    roots = {m.split(".")[0] for m in mods}
    assert not roots & {"jax", "flax", "motionmixerconv_tpu"}, roots


@pytest.mark.parametrize("argv", [
    [os.path.join(REPO, "chip_smoke.py")],
    ["-c", "import chip_smoke; chip_smoke.alone('adam')"],
], ids=["script", "alone"])
def test_chip_smoke_fails_without_a_card(argv):
    """No CUDA device: the script, and one row run alone, exit non-zero and
    print no result line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; chip_smoke.py would run for real")
    res = subprocess.run([sys.executable, *argv], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout

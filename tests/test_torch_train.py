"""The port's training path on the CPU: gradients, optimizer, schedule,
trainer, runner and resume, against the reference goldens and the JAX
package.

tests/golden/train_parity.npz holds the reference's 30-step Adam
trajectory of the flagship ConvMixer (MultiStepLR at steps 10 and 20,
dropout off) and its step-0 gradient tree; the port is held to them at
tests/test_train_parity.py's tolerances. The fused encoder runs through
its plain forward and backward here (CPU tensors); ``chip_smoke.py`` holds
the CUDA kernels to those on the card.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionmixerconv_tpu.cli import train_mixer_h36m as jax_cli
from motionmixerconv_tpu.cli._runner import build_conv_mixer as jax_build
from motionmixerconv_tpu.cli._runner import run_h36m as jax_run_h36m
from motionmixerconv_tpu.data import fixtures as jfix
from motionmixerconv_tpu.models import ConvMixer as JaxConvMixer
from motionmixerconv_tpu.train import Trainer as JaxTrainer
from motionmixerconv_tpu.train import make_optimizer as jax_make_optimizer
from motionmixerconv_tpu.train.state import TrainState
from motionmixerconv_tpu_torch.cli import train_mixer_h36m as cli
from motionmixerconv_tpu_torch.cli._runner import (WEIGHTS_FILE,
                                                   build_conv_mixer, run_h36m)
from motionmixerconv_tpu_torch.data import WindowedCorpus
from motionmixerconv_tpu_torch.models import ConvMixer, state_dict_from_jax
from motionmixerconv_tpu_torch.ops import harmonic
from motionmixerconv_tpu_torch.parallel import make_mesh
from motionmixerconv_tpu_torch.serving import Predictor
from motionmixerconv_tpu_torch.train import Trainer, make_optimizer

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

FLAGSHIP_NO_DROPOUT = dict(
    num_blocks=4, dimPosIn=66, dimPosEmb=50, dimPosOut=66, in_nTP=10,
    out_nTP=25, conv_nChan=1, conv1_kernel_shape=(1, 3), conv1_stride=(1, 1),
    conv1_padding=(0, 1), mode_conv="twice", activation="mish",
    regularization=0.0, use_se=True, r_se=8, use_max_pooling=False,
    encoder_n_harmonic_functions=64, encoder_omega0=0.1)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests compute small tensors, which one intra-op thread does as
    fast as eight; the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def g():
    return np.load(os.path.join(GOLDEN, "train_parity.npz"))


def _sd(g, prefix):
    return {k[len(prefix):]: torch.from_numpy(g[k]) for k in g.files
            if k.startswith(prefix)}


def _golden_model(g, fused):
    model = ConvMixer(**FLAGSHIP_NO_DROPOUT, encoder_fused=fused)
    model.load_state_dict(_sd(g, "conv_init::"), strict=True)
    return model


def _corpus(batches):
    """Lay fixed (steps, B, T, D) batches out as a windowed corpus."""
    n_steps, b, t, d = batches.shape
    frames = batches.reshape(n_steps * b * t, d).astype(np.float32)
    starts = np.arange(n_steps * b, dtype=np.int64) * t
    return torch.from_numpy(frames), torch.from_numpy(starts).reshape(n_steps, b)


@pytest.mark.parametrize("fused", [False, True])
def test_conv_mixer_gradient_tree_matches_golden(g, fused):
    """The flagship's step-0 gradient tree at the reference's init equals
    the reference's autograd to 1e-6, with the plain encoder and through
    the fused encoder's backward (its plain version on the CPU)."""
    model = _golden_model(g, fused).train()
    batch = torch.from_numpy(g["conv_batches"][0])
    pred = model(batch[:, :10] / 1000.0)
    b = pred.shape[0]
    diff = (batch[:, 10:35] - pred).reshape(b, -1, 3)
    before = harmonic.PLAIN_CALLS.value
    torch.linalg.norm(diff, dim=-1).mean().backward()
    assert harmonic.PLAIN_CALLS.value == before + int(fused)
    ours = {k: p.grad.numpy() for k, p in model.named_parameters()}
    golden = {k: v.numpy() for k, v in _sd(g, "conv_grad0::").items()}
    assert set(ours) == set(golden)
    for k in golden:
        np.testing.assert_allclose(ours[k], golden[k], atol=1e-6, err_msg=k)


def test_multistep_schedule_matches_torch_lr_trajectory(g):
    """MultiStepLR stepped per batch at milestone * steps_per_epoch gives
    the reference's per-epoch lr at every one of the 30 steps."""
    p = torch.nn.Parameter(torch.zeros(3))
    opt = make_optimizer([p], lr=float(g["lr"]),
                         milestones=[int(m) for m in g["milestones"]],
                         gamma=float(g["gamma"]),
                         steps_per_epoch=int(g["steps_per_epoch"]))
    lrs = []
    for _ in range(int(g["n_steps"])):
        lrs.append(opt.lr)
        p.grad = torch.ones(3)
        opt.step()
    np.testing.assert_allclose(lrs, g["conv_lrs"], rtol=1e-6)


def test_trainer_30step_loss_trajectory(g):
    """The port's Trainer + optimizer + schedule, fused encoder, replay the
    reference's 30 per-step losses through both lr boundaries."""
    model = _golden_model(g, fused=True)
    opt = make_optimizer(model.parameters(), lr=float(g["lr"]),
                         weight_decay=1e-5,
                         milestones=[int(m) for m in g["milestones"]],
                         gamma=float(g["gamma"]),
                         steps_per_epoch=int(g["steps_per_epoch"]))
    trainer = Trainer(model, opt, loss_type="mpjpe", dim_used=np.arange(66),
                      input_n=10, output_n=25, input_scale=1e-3)
    frames, starts = _corpus(g["conv_batches"])
    w = torch.ones(starts.shape[1])
    model.train()
    losses = [float(trainer.train_step(frames, starts[i], w))
              for i in range(starts.shape[0])]
    np.testing.assert_allclose(losses, g["conv_losses"], rtol=2e-4)


def test_coupled_weight_decay_matches_jax():
    """At wd 1e-2 (where coupled L2 and decoupled AdamW part) the port's
    Adam(weight_decay) follows the JAX package's add_decayed_weights ->
    adam over 10 steps from the same init."""
    cfg = dict(FLAGSHIP_NO_DROPOUT, num_blocks=2, dimPosIn=12, dimPosEmb=16,
               dimPosOut=12, out_nTP=5, encoder_n_harmonic_functions=4)
    rs = np.random.RandomState(5)
    batches = (rs.randn(10, 6, 15, 12) * 0.5).astype(np.float32)
    jmodel = JaxConvMixer(**cfg)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 10, 12)), training=False))

    jopt = jax_make_optimizer(lr=1e-2, weight_decay=1e-2, use_scheduler=False)
    jtr = JaxTrainer(jmodel, jopt, loss_type="mpjpe", dim_used=np.arange(12),
                     input_n=10, output_n=5)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats={}, opt_state=jopt.init(params),
                       rng=jax.random.PRNGKey(0))
    frames, starts = _corpus(batches)
    jframes = jnp.asarray(frames.numpy())
    want = []
    for i in range(10):
        state, loss = jtr._train_step(state, jframes,
                                      jnp.asarray(starts[i].numpy(), jnp.int32),
                                      jnp.ones(6, jnp.float32))
        want.append(float(loss))

    model = ConvMixer(**cfg)
    model.load_state_dict(state_dict_from_jax(variables, 2, 4, 0.1), strict=True)
    opt = make_optimizer(model.parameters(), lr=1e-2, weight_decay=1e-2,
                         use_scheduler=False)
    trainer = Trainer(model, opt, loss_type="mpjpe", dim_used=np.arange(12),
                      input_n=10, output_n=5)
    model.train()
    got = [float(trainer.train_step(frames, starts[i], torch.ones(6)))
           for i in range(10)]
    np.testing.assert_allclose(got, want, rtol=5e-5)


def test_trainer_refuses_what_is_not_ported():
    model = ConvMixer(**dict(FLAGSHIP_NO_DROPOUT, num_blocks=1,
                             encoder_n_harmonic_functions=2))
    opt = make_optimizer(model.parameters(), lr=1e-3)
    kw = dict(dim_used=np.arange(66), input_n=10, output_n=25)
    # the mesh is ported (tests/test_torch_parallel.py); what is not a
    # mesh of ranks is refused
    with pytest.raises(TypeError, match="DataMesh"):
        Trainer(model, opt, loss_type="mpjpe", mesh=object(), **kw)
    with pytest.raises(ValueError, match="one of ranks"):
        Trainer(model, opt, loss_type="mpjpe",
                mesh=make_mesh(["cpu", "cpu"]), **kw)


def test_train_epoch_pads_and_weights_the_last_batch():
    """A ragged last batch is padded with weight-0 rows: the epoch loss is
    the sample-weighted mean of the step losses, and training one epoch
    changes the weights."""
    cfg = dict(FLAGSHIP_NO_DROPOUT, num_blocks=1, dimPosIn=6, dimPosEmb=8,
               dimPosOut=6, out_nTP=5, encoder_n_harmonic_functions=2)
    model = ConvMixer(**cfg, generator=torch.Generator().manual_seed(0))
    opt = make_optimizer(model.parameters(), lr=1e-3)
    trainer = Trainer(model, opt, loss_type="mpjpe", dim_used=np.arange(6),
                      input_n=10, output_n=5)
    rs = np.random.RandomState(0)
    corpus = WindowedCorpus(rs.randn(120, 6).astype(np.float32),
                            np.arange(0, 100, 5, dtype=np.int64), 15)
    w0 = model.fc_out.weight.detach().clone()
    loss = trainer.train_epoch(corpus, torch.from_numpy(corpus.frames), 8, 0)
    assert np.isfinite(loss) and loss > 0
    assert not torch.equal(w0, model.fc_out.weight)
    frames = torch.from_numpy(corpus.frames)
    val = trainer.validate(corpus, frames, 7)
    gids = np.arange(len(corpus)) % 3
    m1, m2, n = trainer.evaluate_grouped(frames, corpus.window_starts, gids,
                                         3, 7, "simple")
    np.testing.assert_array_equal(n, [7, 7, 6])
    np.testing.assert_allclose(m1.sum() / n.sum(), val, rtol=1e-6)
    assert np.all((0.0 <= m2 / n) & (m2 / n <= 1.0))


# ------------------------------------------------------------------ runner

@pytest.fixture(scope="module")
def h36m_dir(tmp_path_factory):
    td = tmp_path_factory.mktemp("h36m_torch_runner")
    # all 15 actions: split 0 reads every action whatever
    # --actions_to_consider says (dataset_h36m.py:75-82)
    jfix.make_h36m_corpus(str(td), n_frames=340, seed=3)
    return str(td)


def _argv(data_dir, save, *extra):
    return ["--data_dir", data_dir, "--save_path", save,
            "--loss_type", "mpjpe", "--skip_rate", "5", "--num_blocks", "2",
            "--hidden_dim", "16", "--actions_to_consider", "walking",
            "--batch_size", "128", *extra]


def test_runner_matches_jax_run_h36m(h36m_dir, tmp_path):
    """JAX run_h36m and the port's (fused encoder) from one init: per-epoch
    train loss, val loss, MPJPE and AUC-PCK agree at rtol 1e-3."""
    common = ["--n_epochs", "2", "--regularization", "0"]
    jargs = jax_cli.parse_args(_argv(h36m_dir, str(tmp_path / "jax"), *common))
    args = cli.parse_args(_argv(h36m_dir, str(tmp_path / "port"), *common,
                                "--dev", "cpu", "--fused_encoder"))
    for a in (jargs, args):
        a.encoder_n_harmonic_functions = 8
    jmodel = jax_build(jargs, 66, 66, 10, 25)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 10, 66)), training=False))
    want, _, _ = jax_run_h36m(jargs, model=jmodel, init_variables=jax.tree_util
                              .tree_map(jnp.asarray, variables))
    got, trainer = run_h36m(args, init_state_dict=state_dict_from_jax(
        variables, 2, 8, 0.1))
    assert trainer.model.encoder.fused
    for key in ("train", "val"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, err_msg=key)
    for key in ("mpjpe", "auc_pck"):
        np.testing.assert_allclose(got["metrics"][key], want["metrics"][key],
                                   rtol=1e-3, err_msg=key)
    assert set(got["per_action"]) == {"walking"}


def test_resume_equals_an_uninterrupted_run(h36m_dir, tmp_path):
    """One epoch, then --resume for one more, equals two epochs at once in
    metrics and in weights (dropout on: the RNG state resumes too); the
    saved weights serve through Predictor."""
    base = ["--dev", "cpu", "--fused_encoder"]
    one, two = str(tmp_path / "one"), str(tmp_path / "two")
    cli.main(_argv(h36m_dir, one, "--n_epochs", "1", *base))
    run_dir = os.path.join(one, "h36_3d_25frames_ckpt")
    resumed = cli.main(_argv(h36m_dir, one, "--n_epochs", "2", "--resume",
                             os.path.join(run_dir, "train_state.pt"), *base))
    straight = cli.main(_argv(h36m_dir, two, "--n_epochs", "2", *base))
    assert len(resumed["train"]) == 1
    for key in ("train", "val", "test"):
        assert resumed[key][0] == straight[key][1], key
    sd_a = torch.load(os.path.join(run_dir, WEIGHTS_FILE), weights_only=True)
    sd_b = torch.load(os.path.join(two, "h36_3d_25frames_ckpt", WEIGHTS_FILE),
                      weights_only=True)
    assert set(sd_a) == set(sd_b)
    for k in sd_a:
        torch.testing.assert_close(sd_a[k], sd_b[k], rtol=0, atol=0, msg=k)

    model = build_conv_mixer(cli.parse_args(_argv(h36m_dir, one)),
                             66, 66, 10, 25)
    pred = Predictor.from_checkpoint(model, os.path.join(run_dir, WEIGHTS_FILE),
                                     device="cpu")
    out = pred.predict(np.zeros((3, 10, 66), np.float32))
    assert out.shape == (3, 25, 66) and torch.isfinite(out).all()


def test_cli_defaults_to_the_card(h36m_dir, tmp_path):
    """--dev defaults to cuda; with no card the CLI raises instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device would train")
    for extra in ((), ("--dev", "cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(_argv(h36m_dir, str(tmp_path / "x"), *extra))


@pytest.mark.parametrize("flags,item", [
    pytest.param(("--visualize",), "matplotlib", id="flags0-item 16"),
])
def test_cli_refuses_unported_flags(tmp_path, monkeypatch, flags, item):
    """--visualize where matplotlib cannot be imported (the card's
    machine): the CLI exits naming it before it reads any data, not after
    the run (the corpus directory here is empty)."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    argv = ["--data_dir", str(tmp_path), "--save_path", str(tmp_path),
            "--loss_type", "mpjpe", "--dev", "cpu", *flags]
    with pytest.raises(SystemExit, match=item):
        cli.main(argv)


def test_cli_trains_the_mlp_mixer(h36m_dir, tmp_path):
    """``--model_type mlp`` trains an MlpMixer on the 66 H36M dims for one
    epoch (JAX train_mixer_h36m.py:126-127 builds it the same way), with
    finite metrics, and its train_state.pt rebuilds that MlpMixer."""
    from motionmixerconv_tpu_torch.models import MlpMixer

    save = str(tmp_path / "mlp")
    hist = cli.main(_argv(h36m_dir, save, "--n_epochs", "1", "--dev", "cpu",
                          "--model_type", "mlp", "--channels_mlp_dim", "16"))
    values = [hist["train"][0], hist["val"][0], hist["test"][0],
              hist["metrics"]["auc_pck"][0]]
    assert all(np.isfinite(v) for v in values), values
    path = os.path.join(save, "h36_3d_25frames_ckpt", "train_state.pt")
    p = Predictor.from_checkpoint(None, path, device="cpu")
    assert isinstance(p.model, MlpMixer)
    assert (p.model.input_size, p.model.hidden_dim, p.model.num_blocks,
            p.model.channels_mlp_dim) == (66, 16, 2, 16)
    assert type(p._fused).__name__ == "FusedMlpMixer"

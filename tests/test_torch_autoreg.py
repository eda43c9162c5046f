"""The port's autoregressive training path and its BatchNorm on the CPU,
against the JAX package: the running-variance update of one BatchNorm train
step (direct trainer), the AutoregressiveTrainer's teacher-forcing and
closed-loop epochs and its evaluation, ``run_h36m_autoregressive`` and the
autoregressive CLI.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionmixerconv_tpu.cli import train_autoreg_mixer_h36m as jax_cli
from motionmixerconv_tpu.cli._runner import build_conv_mixer as jax_build
from motionmixerconv_tpu.cli._runner import \
    run_h36m_autoregressive as jax_run_ar
from motionmixerconv_tpu.data import H36MDataset as JaxH36MDataset
from motionmixerconv_tpu.data import fixtures as jfix
from motionmixerconv_tpu.models import ConvMixer as JaxConvMixer
from motionmixerconv_tpu.train import Trainer as JaxTrainer
from motionmixerconv_tpu.train import make_optimizer as jax_make_optimizer
from motionmixerconv_tpu.train.autoreg_trainer import \
    AutoregressiveTrainer as JaxARTrainer
from motionmixerconv_tpu.train.state import TrainState
from motionmixerconv_tpu_torch.cli import train_autoreg_mixer_h36m as cli
from motionmixerconv_tpu_torch.cli._runner import run_h36m_autoregressive
from motionmixerconv_tpu_torch.data import H36MDataset
from motionmixerconv_tpu_torch.data.constants import H36M_DIM_USED_XYZ
from motionmixerconv_tpu_torch.models import ConvMixer, state_dict_from_jax
from motionmixerconv_tpu_torch.train import (AutoregressiveTrainer, Trainer,
                                             make_optimizer)

# the autoregressive family (conv_nChan >= 2, BatchNorm, no harmonics) at
# a small width
AR_SMALL = dict(
    num_blocks=1, dimPosIn=66, dimPosEmb=24, dimPosOut=66, in_nTP=10,
    out_nTP=5, conv_nChan=3, conv1_kernel_shape=(3, 3), conv1_stride=(1, 1),
    conv1_padding=None, mode_conv="twice", activation="mish",
    regularization=-1.0, use_se=True, r_se=2, use_max_pooling=False,
    encoder_n_harmonic_functions=0, encoder_omega0=0.1)
AR_GEOMETRY = dict(input_n=10, output_n=25, input_n_model=10,
                   output_n_model=5, step_window=5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests compute small tensors, which one intra-op thread does as
    fast as eight; the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _exported(params, batch_stats, cfg):
    """JAX variables as the reference state_dict (numpy arrays)."""
    sd = state_dict_from_jax(_np_tree({"params": params,
                                       "batch_stats": batch_stats}),
                             cfg["num_blocks"],
                             cfg["encoder_n_harmonic_functions"],
                             cfg["encoder_omega0"])
    return {k: v.numpy() for k, v in sd.items()}


def _running_stats(sd):
    return {k: v for k, v in sd.items()
            if k.endswith(("running_mean", "running_var"))}


def _port_state(model):
    return {k: v.detach().numpy() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("kind", ["direct", "autoregressive"])
def test_batchnorm_running_stats_match_flax(kind):
    """One train step with BatchNorm (regularization -1) of each trainer,
    port against JAX from the same exported init: running mean and variance
    agree to 1e-6 relative to each tensor's largest element. torch's own
    BatchNorm2d moves running_var towards the unbiased batch variance,
    n/(n-1) times flax's biased one, and fails this (n = 6 x 10 x 16 per
    channel in the direct case). The autoregressive step (closed loop: five
    train-mode forwards) moves the stats once, from its first window."""
    if kind == "direct":
        cfg = dict(AR_SMALL, num_blocks=2, dimPosIn=12, dimPosEmb=16,
                   dimPosOut=12, encoder_n_harmonic_functions=4)
        dims, seq_len, scale = np.arange(12), 15, 0.5
        geometry = dict(input_n=10, output_n=5)
    else:
        cfg = dict(AR_SMALL, num_blocks=2)
        dims, seq_len, scale = H36M_DIM_USED_XYZ, 35, 300.0
        geometry = AR_GEOMETRY
    width = 96 if kind == "autoregressive" else 12
    rs = np.random.RandomState(5)
    frames = (rs.randn(6 * seq_len, width) * scale).astype(np.float32)
    starts = np.arange(6, dtype=np.int64) * seq_len
    jmodel = JaxConvMixer(**cfg)
    variables = _np_tree(jmodel.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 10, cfg["dimPosIn"])),
        training=False))
    init = _running_stats(_exported(variables["params"],
                                    variables["batch_stats"], cfg))

    jopt = jax_make_optimizer(lr=1e-3, use_scheduler=False)
    model = ConvMixer(**cfg)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in _exported(
        variables["params"], variables["batch_stats"], cfg).items()},
        strict=True)
    opt = make_optimizer(model.parameters(), lr=1e-3, use_scheduler=False)
    if kind == "direct":
        jtr = JaxTrainer(jmodel, jopt, loss_type="mpjpe", dim_used=dims,
                         **geometry)
        jstep = jtr._train_step
        trainer = Trainer(model, opt, loss_type="mpjpe", dim_used=dims,
                          **geometry)
        step = trainer.train_step
    else:
        jtr = JaxARTrainer(jmodel, jopt, loss_type="mpjpe", dim_used=dims,
                           **geometry)
        jstep = jtr._train_step_cl
        trainer = AutoregressiveTrainer(model, opt, loss_type="mpjpe",
                                        dim_used=dims, **geometry)

        def step(f, s, w):
            return trainer.train_step_ar(f, s, w, teacher_forcing=False)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = TrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=variables["batch_stats"],
                       opt_state=jopt.init(params), rng=jax.random.PRNGKey(0))
    state, jloss = jstep(state, jnp.asarray(frames),
                         jnp.asarray(starts, jnp.int32),
                         jnp.ones(6, jnp.float32))
    want = _running_stats(_exported(state.params, state.batch_stats, cfg))

    model.train()
    loss = step(torch.from_numpy(frames), torch.from_numpy(starts),
                torch.ones(6))
    got = _running_stats(_port_state(model))
    assert set(got) == set(want) and len(want) == 8
    for k in want:
        assert not np.allclose(want[k], init[k]), k  # the stats moved
        err = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
        assert err <= 1e-6, (k, err)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)


def _frames_and_starts(batch, seed=0):
    rs = np.random.RandomState(seed)
    seqs = (rs.randn(batch, 35, 96) * 300.0).astype(np.float32)
    return (torch.from_numpy(seqs.reshape(-1, 96)),
            torch.arange(batch, dtype=torch.long) * 35)


def test_rollout_moves_running_stats_once_per_step():
    """A closed-loop step runs five train-mode forwards; the running stats
    move once, to what one train-mode forward on the first model window
    gives with the pre-update parameters (autoreg_trainer.py:157-169)."""
    model = ConvMixer(**AR_SMALL, generator=torch.Generator().manual_seed(0))
    ref = ConvMixer(**AR_SMALL)
    ref.load_state_dict(model.state_dict())
    trainer = AutoregressiveTrainer(
        model, make_optimizer(model.parameters(), lr=1e-3), loss_type="mpjpe",
        dim_used=H36M_DIM_USED_XYZ, **AR_GEOMETRY)
    frames, starts = _frames_and_starts(8)
    model.train()
    trainer.train_step_ar(frames, starts, torch.ones(8), teacher_forcing=False)
    ref.train()
    with torch.no_grad():
        seq = frames.view(8, 35, 96)[:, :, H36M_DIM_USED_XYZ]
        ref(seq[:, :10].contiguous())
    got, want = _port_state(model), _port_state(ref)
    for k in want:
        if k.endswith(("running_mean", "running_var", "num_batches_tracked")):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            if k.endswith("num_batches_tracked"):
                assert int(got[k]) == 1


def test_train_epoch_ar_guards_against_a_diverged_rollout():
    model = ConvMixer(**AR_SMALL, generator=torch.Generator().manual_seed(0))
    trainer = AutoregressiveTrainer(
        model, make_optimizer(model.parameters(), lr=1e-3), loss_type="mpjpe",
        dim_used=H36M_DIM_USED_XYZ, **AR_GEOMETRY)
    from motionmixerconv_tpu_torch.data import WindowedCorpus

    frames, _ = _frames_and_starts(4)
    corpus = WindowedCorpus(frames.numpy(), np.arange(4, dtype=np.int64) * 35, 35)
    with torch.no_grad():
        model.fc_out.bias.fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="diverged"):
        trainer.train_epoch_ar(corpus, frames, 2, seed=0, teacher_forcing=False)


def test_autoregressive_trainer_refuses_what_is_not_ported():
    model = ConvMixer(**AR_SMALL)
    opt = make_optimizer(model.parameters(), lr=1e-3)
    kw = dict(dim_used=H36M_DIM_USED_XYZ, **AR_GEOMETRY)
    with pytest.raises(NotImplementedError, match="item 9"):
        AutoregressiveTrainer(model, opt, loss_type="angle", **kw)
    with pytest.raises(NotImplementedError, match="item 17"):
        AutoregressiveTrainer(model, opt, loss_type="mpjpe", mesh=object(), **kw)
    trainer = AutoregressiveTrainer(model, opt, loss_type="mpjpe", **kw)
    with pytest.raises(NotImplementedError, match="item 9"):
        trainer.evaluate_grouped(torch.zeros(40, 96), np.zeros(2, np.int64),
                                 np.zeros(2, np.int64), 1, 2, "h36m_angle")


# ------------------------------------------------- trainer and runner vs JAX

@pytest.fixture(scope="module")
def h36m_dir(tmp_path_factory):
    td = tmp_path_factory.mktemp("h36m_torch_autoreg")
    # all 15 actions: split 0 reads every action whatever
    # --actions_to_consider says (dataset_h36m.py:75-82)
    jfix.make_h36m_corpus(str(td), n_frames=340, seed=3)
    return str(td)


def test_autoregressive_trainer_matches_jax(h36m_dir):
    """From the same init (BatchNorm, conv_nChan 3): one teacher-forcing and
    one closed-loop epoch give the JAX trainer's epoch losses, parameters and
    BatchNorm running stats, and the closed-loop val and test evaluations
    agree at rtol 1e-4 (f32 rollouts in another order). Parameters take an
    atol of 2e-5 besides, 2% of one Adam step at lr 1e-3: Adam turns the
    rounding noise of a gradient near zero into a step of up to lr (the
    encoder's channelUpscaling.bias has an exact gradient of 0, the LayerNorm
    after it removing any shift)."""
    jds = JaxH36MDataset(h36m_dir, 10, 25, 5, actions=["walking"], split=0)
    ds = H36MDataset(h36m_dir, 10, 25, 5, actions=["walking"], split=0)
    jtr = JaxARTrainer(JaxConvMixer(**AR_SMALL),
                       jax_make_optimizer(lr=1e-3, use_scheduler=False),
                       loss_type="mpjpe", dim_used=H36M_DIM_USED_XYZ,
                       **AR_GEOMETRY)
    state = jtr.init_state(jax.random.PRNGKey(0))
    model = ConvMixer(**AR_SMALL)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in _exported(
        state.params, state.batch_stats, AR_SMALL).items()}, strict=True)
    trainer = AutoregressiveTrainer(
        model, make_optimizer(model.parameters(), lr=1e-3,
                              use_scheduler=False),
        loss_type="mpjpe", dim_used=H36M_DIM_USED_XYZ, **AR_GEOMETRY)
    jframes, frames = jnp.asarray(jds.frames), torch.from_numpy(ds.frames)

    for epoch, tf in enumerate((True, False)):
        state, jloss = jtr.train_epoch_ar(state, jds, jframes, 64, seed=epoch,
                                          teacher_forcing=tf)
        loss = trainer.train_epoch_ar(ds, frames, 64, seed=epoch,
                                      teacher_forcing=tf)
        assert loss == pytest.approx(jloss, rel=1e-4), (epoch, tf)
    want = _exported(state.params, state.batch_stats, AR_SMALL)
    got = _port_state(model)
    for k in want:
        if k.endswith("num_batches_tracked"):  # torch's counter only
            continue
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=2e-5,
                                   err_msg=k)

    val = trainer.evaluate_ar(ds, frames, 64, kind="val")
    assert val == pytest.approx(jtr.evaluate_ar(state, jds, jframes, 64,
                                                kind="val"), rel=1e-4)
    test = trainer.evaluate_ar(ds, frames, 64, kind="test")
    jtest = jtr.evaluate_ar(state, jds, jframes, 64, kind="test")
    np.testing.assert_allclose(test, jtest, rtol=1e-4)


def _argv(data_dir, save, *extra):
    return ["--data_dir", data_dir, "--save_path", save,
            "--loss_type", "mpjpe", "--skip_rate", "5", "--num_blocks", "1",
            "--hidden_dim", "16", "--conv_nChan", "2", "--kernel1_x", "3",
            "--kernel1_y", "3", "--actions_to_consider", "walking",
            "--batch_size", "128", "--batch_size_test", "128",
            "--n_epochs", "2", "--n_epochs_teacher_forcing", "1", *extra]


def test_runner_matches_jax_run_h36m_autoregressive(h36m_dir, tmp_path):
    """JAX run_h36m_autoregressive and the port's from one init: per-epoch
    train loss, val loss, rollout MPJPE and AUC-PCK agree at rtol 1e-3 (the
    direct runner's tolerance), one teacher-forcing and one closed-loop
    epoch."""
    jargs = jax_cli.parse_args(_argv(h36m_dir, str(tmp_path / "jax")))
    args = cli.parse_args(_argv(h36m_dir, str(tmp_path / "port"),
                                "--dev", "cpu"))
    for a in (jargs, args):
        a.conv1_kernel_shape = (a.kernel1_x, a.kernel1_y)
    jmodel = jax_build(jargs, 66, 66, 10, 5)
    variables = _np_tree(jmodel.init(jax.random.PRNGKey(0),
                                     jnp.zeros((2, 10, 66)), training=False))
    want, _, _ = jax_run_ar(jargs, model=jmodel,
                            init_variables=jax.tree_util.tree_map(
                                jnp.asarray, variables))
    got, trainer = run_h36m_autoregressive(
        args, init_state_dict=state_dict_from_jax(variables, 1, 0, 0.0))
    assert isinstance(trainer, AutoregressiveTrainer)
    assert trainer.model.conv_nChan == 2 and trainer.model.regularization == -1.0
    for key in ("train", "val"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, err_msg=key)
    for key in ("mpjpe", "auc_pck"):
        np.testing.assert_allclose(got["metrics"][key], want["metrics"][key],
                                   rtol=1e-3, err_msg=key)
    assert set(got["per_action"]) == {"walking"}
    assert (tmp_path / "port" / "h36_ar_25frames_ckpt" / "train_state.pt").exists()


# --------------------------------------------------------------------- CLI

def test_cli_defaults_equal_the_jax_cli():
    """The mpjpe defaults (the autoregressive model at full width) equal the
    JAX CLI's, but for the device: the card here, the TPU there."""
    got, want = vars(cli.parse_args([])), vars(jax_cli.parse_args([]))
    assert got.pop("dev") == "cuda" and want.pop("dev") == "tpu"
    assert got == want
    assert (got["conv_nChan"], got["hidden_dim"], got["regularization"],
            got["kernel1_x"], got["kernel1_y"]) == (8, 192, -1.0, 5, 5)


@pytest.mark.parametrize("flags,item", [
    (("--loss_type", "angle"), "item 9"),
])
def test_cli_refuses_unported_flags(tmp_path, flags, item):
    argv = ["--data_dir", str(tmp_path), "--save_path", str(tmp_path),
            "--dev", "cpu", *flags]
    with pytest.raises(NotImplementedError, match=item):
        cli.main(argv)


def test_cli_defaults_to_the_card(h36m_dir, tmp_path):
    """--dev defaults to cuda; with no card the CLI raises instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device would train")
    for extra in ((), ("--dev", "cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(_argv(h36m_dir, str(tmp_path / "x"), *extra))

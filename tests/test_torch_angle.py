"""The port's H36M angle path on the CPU against the JAX package: the
per-sample angle functions, the angle evaluation kinds of both trainers,
``run_h36m`` and ``run_h36m_autoregressive`` with ``--loss_type angle``,
the training CLIs at their defaults and their flags, and the angle models
a checkpoint's meta rebuilds.

Small sizes throughout (2 blocks, hidden 16, 8 harmonics, ``--skip_rate
5``, one test action). The port's fused encoder runs through its plain
forward and backward here (CPU tensors).
"""

import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionmixerconv_tpu.cli import train_autoreg_mixer_ais as jax_ar_ais_cli
from motionmixerconv_tpu.cli import train_autoreg_mixer_h36m as jax_ar_cli
from motionmixerconv_tpu.cli import train_mixer_ais as jax_ais_cli
from motionmixerconv_tpu.cli import train_mixer_h36m as jax_cli
from motionmixerconv_tpu.cli._runner import build_conv_mixer as jax_build
from motionmixerconv_tpu.cli._runner import build_mlp_mixer as jax_build_mlp
from motionmixerconv_tpu.cli._runner import run_h36m as jax_run_h36m
from motionmixerconv_tpu.cli._runner import \
    run_h36m_autoregressive as jax_run_ar
from motionmixerconv_tpu.data import H36MDataset as JaxH36MDataset
from motionmixerconv_tpu.data import fixtures as jfix
from motionmixerconv_tpu.geometry.rotations import \
    rotmat2expmap as jax_rotmat2expmap
from motionmixerconv_tpu.models import ConvMixer as JaxConvMixer
from motionmixerconv_tpu.train import Trainer as JaxTrainer
from motionmixerconv_tpu.train import make_optimizer as jax_make_optimizer
from motionmixerconv_tpu.train import loop as jax_loop
from motionmixerconv_tpu.train.autoreg_trainer import \
    AutoregressiveTrainer as JaxARTrainer
from motionmixerconv_tpu_torch.cli import train_autoreg_mixer_ais as ar_ais_cli
from motionmixerconv_tpu_torch.cli import train_autoreg_mixer_h36m as ar_cli
from motionmixerconv_tpu_torch.cli import train_mixer_ais as ais_cli
from motionmixerconv_tpu_torch.cli import train_mixer_h36m as cli
from motionmixerconv_tpu_torch.cli._runner import (STATE_FILE,
                                                   _model_and_optimizer,
                                                   run_h36m,
                                                   run_h36m_autoregressive)
from motionmixerconv_tpu_torch.data import H36MDataset
from motionmixerconv_tpu_torch.data.constants import H36M_DIM_USED_ANGLE
from motionmixerconv_tpu_torch.models import (ConvMixer, MlpMixer,
                                              state_dict_from_jax)
from motionmixerconv_tpu_torch.serving import Predictor
from motionmixerconv_tpu_torch.train import (AutoregressiveTrainer, Trainer,
                                             loop)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")

# a small angle ConvMixer (48 expmap dims, harmonics on) and a small
# autoregressive one (conv_nChan 3, BatchNorm, no harmonics)
ANGLE_SMALL = dict(
    num_blocks=2, dimPosIn=48, dimPosEmb=16, dimPosOut=48, in_nTP=10,
    out_nTP=25, conv_nChan=1, conv1_kernel_shape=(1, 3), conv1_stride=(1, 1),
    conv1_padding=None, mode_conv="twice", activation="mish",
    regularization=0.0, use_se=True, r_se=8, use_max_pooling=False,
    encoder_n_harmonic_functions=8, encoder_omega0=0.1)
AR_ANGLE_SMALL = dict(ANGLE_SMALL, num_blocks=1, dimPosEmb=24, out_nTP=5,
                      conv_nChan=3, conv1_kernel_shape=(3, 3),
                      regularization=-1.0, r_se=2,
                      encoder_n_harmonic_functions=0)
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


@pytest.fixture(scope="module")
def h36m_dir(tmp_path_factory):
    td = tmp_path_factory.mktemp("h36m_torch_angle")
    # all 15 actions: split 0 reads every action whatever
    # --actions_to_consider says (dataset_h36m.py:75-82)
    jfix.make_h36m_corpus(str(td), n_frames=340, seed=3)
    return str(td)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port_model(cfg, variables):
    model = ConvMixer(**cfg)
    model.load_state_dict(state_dict_from_jax(
        _np_tree(variables), cfg["num_blocks"],
        cfg["encoder_n_harmonic_functions"], cfg["encoder_omega0"]),
        strict=True)
    return model


# ------------------------------------------------- per-sample functions

def _expmap_inputs(source):
    """(B, T, D) expmap batches: random rotations, or the golden
    rotations' exponential maps with the gimbal-lock matrices', the
    identity and +-pi/2 about y (the branches of rotmat2euler) among
    them."""
    if source == "random":
        rs = np.random.RandomState(0)
        a = (rs.randn(6, 5, 48) * 1.2).astype(np.float32)
        b = a + (rs.randn(6, 5, 48) * 0.3).astype(np.float32)
        return a, b
    g = np.load(os.path.join(GOLDEN, "rotations.npz"))
    lock = np.asarray(jax_rotmat2expmap(jnp.asarray(g["R_lock"])))
    special = np.array([[0.0, 0.0, 0.0], [0.0, math.pi / 2, 0.0],
                        [0.0, -math.pi / 2, 0.0]], np.float32)
    vecs = np.concatenate([g["r"], g["rotmat2expmap"], lock, special])
    vecs = vecs[: len(vecs) // 16 * 16].astype(np.float32)
    a = vecs.reshape(4, -1, 12)
    return a, np.roll(a, 1, axis=0)


@pytest.mark.parametrize("source", ["random", "golden"])
@pytest.mark.parametrize("name", ["_per_sample_l1_angle", "_per_sample_euler",
                                  "_per_sample_joint_angle"])
def test_per_sample_angle_functions_match_jax(name, source):
    """The three per-sample angle functions (JAX train/loop.py:46-60) give
    the JAX package's values, gimbal cases included."""
    pred, gt = _expmap_inputs(source)
    want = np.asarray(getattr(jax_loop, name)(jnp.asarray(pred),
                                              jnp.asarray(gt)))
    got = getattr(loop, name)(torch.from_numpy(pred),
                              torch.from_numpy(gt)).numpy()
    assert got.shape == (pred.shape[0],)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ evaluation kinds

@pytest.fixture(scope="module")
def angle_val(h36m_dir):
    """The angle validation corpus of both packages (walking)."""
    return (JaxH36MDataset(h36m_dir, 10, 25, 5, actions=["walking"],
                           split=1, mode="angle"),
            H36MDataset(h36m_dir, 10, 25, 5, actions=["walking"], split=1,
                        mode="angle"))


@pytest.mark.parametrize("kind", ["val", "h36m_angle"])
def test_angle_eval_kinds_match_jax(angle_val, kind):
    """``Trainer.evaluate_grouped`` of the angle validation (the euler error
    of the prediction put into the full frame) and of the ``h36m_angle``
    test (euler and joint angle) against the JAX trainer's on the same
    exported variables, over three groups: rtol 1e-5."""
    jds, ds = angle_val
    kw = dict(loss_type="angle", dim_used=H36M_DIM_USED_ANGLE, input_n=10,
              output_n=25)
    jtr = JaxTrainer(JaxConvMixer(**ANGLE_SMALL),
                     jax_make_optimizer(lr=1e-2), **kw)
    state = jtr.init_state(jax.random.PRNGKey(1))
    trainer = Trainer(_port_model(ANGLE_SMALL, state.variables()), None, **kw)
    gids = np.arange(len(ds)) % 3
    want = jtr.evaluate_grouped(state, jnp.asarray(jds.frames),
                                jds.window_starts, gids, 3, 64, kind)
    got = trainer.evaluate_grouped(torch.from_numpy(ds.frames),
                                   ds.window_starts, gids, 3, 64, kind)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5)
    assert np.all(np.isfinite(got[0])) and np.all(got[0] > 0)


def test_autoregressive_angle_test_kind_matches_jax(angle_val):
    """The closed-loop rollout test in angle mode (the euler and joint-angle
    errors of the stitched prediction on the full frame, JAX
    autoreg_trainer.py:195-219) and the L1 rollout validation against the
    JAX trainer's on the same exported variables: rtol 1e-5."""
    jds, ds = angle_val
    kw = dict(loss_type="angle", dim_used=H36M_DIM_USED_ANGLE, **AR_GEOMETRY)
    jtr = JaxARTrainer(JaxConvMixer(**AR_ANGLE_SMALL),
                       jax_make_optimizer(lr=1e-2), **kw)
    state = jtr.init_state(jax.random.PRNGKey(2))
    trainer = AutoregressiveTrainer(
        _port_model(AR_ANGLE_SMALL, state.variables()).eval(), None, **kw)
    jframes, frames = jnp.asarray(jds.frames), torch.from_numpy(ds.frames)
    np.testing.assert_allclose(
        trainer.evaluate_ar(ds, frames, 64, kind="test"),
        jtr.evaluate_ar(state, jds, jframes, 64, kind="test"), rtol=1e-5)
    assert trainer.evaluate_ar(ds, frames, 64) == pytest.approx(
        jtr.evaluate_ar(state, jds, jframes, 64), rel=1e-5)


# ----------------------------------------------------- runners against JAX

def _argv(data_dir, save, *extra):
    return ["--data_dir", data_dir, "--save_path", save, "--loss_type",
            "angle", "--skip_rate", "5", "--num_blocks", "2", "--hidden_dim",
            "16", "--actions_to_consider", "walking", "--batch_size", "128",
            "--n_epochs", "2", *extra]


def _assert_histories_agree(got, want, names):
    for key in ("train", "val"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, err_msg=key)
    for key in names:
        np.testing.assert_allclose(got["metrics"][key], want["metrics"][key],
                                   rtol=1e-3, err_msg=key)
    assert set(got["per_action"]) == {"walking"}


def test_runner_matches_jax_run_h36m_angle(h36m_dir, tmp_path):
    """JAX run_h36m --loss_type angle and the port's (fused encoder) from
    one init: per-epoch train loss, val loss, euler_angle and joint_angle
    agree at rtol 1e-3."""
    jargs = jax_cli.parse_args(_argv(h36m_dir, str(tmp_path / "jax")))
    args = cli.parse_args(_argv(h36m_dir, str(tmp_path / "port"),
                                "--dev", "cpu", "--fused_encoder"))
    for a in (jargs, args):
        a.encoder_n_harmonic_functions = 8
    jmodel = jax_build(jargs, 48, 48, 10, 25)
    variables = _np_tree(jmodel.init(jax.random.PRNGKey(0),
                                     jnp.zeros((2, 10, 48)), training=False))
    want, _, _ = jax_run_h36m(jargs, model=jmodel, init_variables=jax
                              .tree_util.tree_map(jnp.asarray, variables))
    got, trainer = run_h36m(args, init_state_dict=state_dict_from_jax(
        variables, 2, 8, 0.1))
    assert trainer.model.encoder.fused and trainer.model.dimPosIn == 48
    _assert_histories_agree(got, want, ("euler_angle", "joint_angle"))


def test_runner_matches_jax_run_h36m_autoregressive_angle(h36m_dir, tmp_path):
    """JAX run_h36m_autoregressive --loss_type angle and the port's from one
    init, one teacher-forcing and one closed-loop epoch: per-epoch train
    loss, val loss, euler_angle and joint_angle agree at rtol 1e-3."""
    extra = ["--num_blocks", "1", "--conv_nChan", "2", "--kernel1_x", "3",
             "--kernel1_y", "3", "--batch_size_test", "128",
             "--n_epochs_teacher_forcing", "1"]
    jargs = jax_ar_cli.parse_args(_argv(h36m_dir, str(tmp_path / "jax"),
                                        *extra))
    args = ar_cli.parse_args(_argv(h36m_dir, str(tmp_path / "port"), *extra,
                                   "--dev", "cpu"))
    for a in (jargs, args):
        a.conv1_kernel_shape = (a.kernel1_x, a.kernel1_y)
    jmodel = jax_build(jargs, 48, 48, 10, 5)
    variables = _np_tree(jmodel.init(jax.random.PRNGKey(0),
                                     jnp.zeros((2, 10, 48)), training=False))
    want, _, _ = jax_run_ar(jargs, model=jmodel, init_variables=jax.tree_util
                            .tree_map(jnp.asarray, variables))
    got, trainer = run_h36m_autoregressive(
        args, init_state_dict=state_dict_from_jax(variables, 1, 0, 0.0))
    assert isinstance(trainer, AutoregressiveTrainer)
    assert trainer.model.dimPosIn == 48 and trainer.loss_type == "angle"
    _assert_histories_agree(got, want, ("euler_angle", "joint_angle"))


# ------------------------------------------------------------------ CLIs

def test_cli_trains_at_its_defaults_and_serves_the_checkpoint(h36m_dir,
                                                              tmp_path):
    """The training CLI with no --loss_type trains the angle ConvMixer (48
    dims, 3 blocks, lr 1e-2 by default) and logs euler_angle and
    joint_angle every epoch; its train_state.pt rebuilds the 48-dim model,
    served through B2's plain version within 1e-5 of the plain forward."""
    save = str(tmp_path / "run")
    hist = cli.main(["--dev", "cpu", "--data_dir", h36m_dir, "--save_path",
                     save, "--skip_rate", "5", "--hidden_dim", "16",
                     "--actions_to_consider", "walking", "--batch_size",
                     "128"])
    assert set(hist["metrics"]) == {"euler_angle", "joint_angle"}
    for key in ("train", "val"):
        assert len(hist[key]) == 2 and np.all(np.isfinite(hist[key])), key
    for values in hist["metrics"].values():
        assert len(values) == 2 and np.all(np.isfinite(values))
    run_dir = os.path.join(save, "h36_3d_25frames_ckpt")
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        tags = {json.loads(line)["tag"] for line in f}
    assert {"metrics/euler_angle", "metrics/joint_angle"} <= tags

    p = Predictor.from_checkpoint(None, os.path.join(run_dir, STATE_FILE),
                                  device="cpu")
    assert (p.model.dimPosIn, p.model.num_blocks) == (48, 3)
    assert type(p._fused).__name__ == "FusedConvMixer"
    x = np.random.RandomState(0).randn(5, 10, 48).astype(np.float32)
    with torch.no_grad():
        want = p.model(torch.from_numpy(x))
    torch.testing.assert_close(p.predict(x), want, rtol=0, atol=1e-5)


CLI_CASES = {
    "h36m mpjpe": (jax_cli, cli, ["--loss_type", "mpjpe"]),
    "h36m angle": (jax_cli, cli, []),
    "h36m angle mlp": (jax_cli, cli, ["--model_type", "mlp"]),
    "autoregressive mpjpe": (jax_ar_cli, ar_cli, []),
    "autoregressive angle": (jax_ar_cli, ar_cli, ["--loss_type", "angle"]),
    "ais": (jax_ais_cli, ais_cli, []),
    "ais autoregressive": (jax_ar_ais_cli, ar_ais_cli, []),
}


@pytest.mark.parametrize("case", list(CLI_CASES))
def test_cli_flags_equal_the_jax_cli(case):
    """Each H36M and AIS training CLI parses to the JAX CLI's namespace for
    every loss type, but for the device (the card here)."""
    jax_mod, mod, argv = CLI_CASES[case]
    got, want = vars(mod.parse_args(argv)), vars(jax_mod.parse_args(argv))
    assert got.pop("dev") == "cuda"
    want.pop("dev", None)
    assert got == want


def test_mlp_model_type_at_the_angle_defaults_builds_the_jax_model():
    """``--model_type mlp`` at the angle defaults builds the 48-dim MlpMixer
    (hidden 60, 3 blocks, tokens 40, channels 60) that JAX
    train_mixer_h36m.py:126-130 builds from ``pose_dim``: the same
    parameters, and the same forward from the JAX init (rtol 1e-5)."""
    argv = ["--model_type", "mlp", "--dev", "cpu"]
    args, jargs = cli.parse_args(argv), jax_cli.parse_args(argv[:2])
    model, _ = _model_and_optimizer(args, None, None, torch.device("cpu"),
                                    10, 25, 100)
    assert isinstance(model, MlpMixer)
    assert (model.input_size, model.hidden_dim, model.num_blocks,
            model.tokens_mlp_dim, model.channels_mlp_dim) == (48, 60, 3, 40,
                                                              60)
    jmodel = jax_build_mlp(jargs, jargs.pose_dim, 10, 25)
    x = np.random.RandomState(0).randn(3, 10, 48).astype(np.float32)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                            training=False)
    sd = state_dict_from_jax(_np_tree(variables), 3)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()
        if not k.endswith("num_batches_tracked")}
    model.load_state_dict(sd, strict=False)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), training=False))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

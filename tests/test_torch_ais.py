"""The port's AIS path on the CPU against the JAX package: the synthetic
keypoint corpus, canonicalization and smoothing, ``AISDataset`` frame for
frame and window for window, ``run_ais`` and ``run_ais_autoregressive``
from one init, the AIS CLIs' device default, the models every checkpoint
meta family rebuilds, and a trained AIS checkpoint served.

Small sizes throughout (2 blocks, hidden 16, 300 keypoint frames an
action). B2 runs through its plain version here (CPU tensors).
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionmixerconv_tpu.cli import train_autoreg_mixer_ais as jax_ar_cli
from motionmixerconv_tpu.cli import train_autoreg_mixer_h36m as jax_ar_h36m_cli
from motionmixerconv_tpu.cli import train_mixer_ais as jax_cli
from motionmixerconv_tpu.cli import train_mixer_h36m as jax_h36m_cli
from motionmixerconv_tpu.cli._runner import build_conv_mixer as jax_build
from motionmixerconv_tpu.cli._runner import \
    model_from_checkpoint_meta as jax_model_from_meta
from motionmixerconv_tpu.cli._runner import run_ais as jax_run_ais
from motionmixerconv_tpu.cli._runner import \
    run_ais_autoregressive as jax_run_ais_ar
from motionmixerconv_tpu.data import AISDataset as JaxAISDataset
from motionmixerconv_tpu.data import ais as jax_ais
from motionmixerconv_tpu.data import fixtures as jfix
from motionmixerconv_tpu_torch.cli import train_autoreg_mixer_ais as ar_cli
from motionmixerconv_tpu_torch.cli import train_autoreg_mixer_h36m as h36m_ar_cli
from motionmixerconv_tpu_torch.cli import train_mixer_ais as cli
from motionmixerconv_tpu_torch.cli import train_mixer_h36m as h36m_cli
from motionmixerconv_tpu_torch.cli._runner import (STATE_FILE,
                                                   model_from_checkpoint_meta,
                                                   run_ais,
                                                   run_ais_autoregressive)
from motionmixerconv_tpu_torch.data import (AISDataset, canonicalize_frames,
                                            ewm_mean, fixtures)
from motionmixerconv_tpu_torch.data.constants import (AIS_ALL_ACTIONS,
                                                      AIS_DIM_USED,
                                                      AIS_TEST_ACTIONS,
                                                      AIS_TRAIN_ACTIONS,
                                                      AIS_VAL_ACTIONS)
from motionmixerconv_tpu_torch.models import ConvMixer, state_dict_from_jax
from motionmixerconv_tpu_torch.serving import Predictor
from motionmixerconv_tpu_torch.train import AutoregressiveTrainer

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
FAIL_FRAMES = (0, 40, 41, 150, 297)  # detection failures in every action


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests compute small tensors, which one intra-op thread does as
    fast as eight; the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ais_dir(tmp_path_factory):
    """All eight AIS actions, written by the port's generator, with
    detection failures away from the corpus's first frame (the padding
    rows of a batch read it)."""
    td = tmp_path_factory.mktemp("ais_torch")
    fixtures.make_ais_corpus(str(td), actions=AIS_ALL_ACTIONS, n_frames=300,
                             fail_frames=(40, 41, 150), seed=2)
    return str(td)


# ------------------------------------------------------------------ data

def test_make_ais_corpus_writes_the_jax_files(tmp_path):
    """One seed writes byte-identical JSON from either package, detection
    failures included."""
    kw = dict(actions=["actA", "actB"], n_frames=60, fail_frames=(3, 17),
              seed=5)
    jfix.make_ais_corpus(str(tmp_path / "jax"), **kw)
    fixtures.make_ais_corpus(str(tmp_path / "port"), **kw)
    for action in kw["actions"]:
        assert filecmp.cmp(tmp_path / "jax" / f"{action}.json",
                           tmp_path / "port" / f"{action}.json",
                           shallow=False), action


def test_canonicalize_and_ewm_match_jax():
    """``canonicalize_frames`` and ``ewm_mean`` (NaN rows and entries that
    age the weights) give the JAX package's arrays."""
    rs = np.random.RandomState(1)
    coords = rs.randn(40, 19, 3)
    np.testing.assert_allclose(canonicalize_frames(coords),
                               jax_ais.canonicalize_frames(coords),
                               rtol=1e-12, atol=1e-12)
    x = rs.randn(60, 7).astype(np.float32)
    x[0], x[5], x[9, 3] = np.nan, np.nan, np.nan
    np.testing.assert_array_equal(ewm_mean(x, 0.15), jax_ais.ewm_mean(x, 0.15))


def test_ais_dataset_matches_the_golden(tmp_path):
    """The reference pipeline's windows (tests/golden/dataset_ais.npz, the
    fixture of tests/test_data.py) and its smoothed first action."""
    fixtures.make_ais_corpus(str(tmp_path), actions=["actA", "actB"],
                             n_frames=120, fail_frames=(7, 30), seed=5)
    g = np.load(os.path.join(GOLDEN, "dataset_ais.npz"))
    ds = AISDataset(str(tmp_path), 10, 10, 2, ["actA", "actB"],
                    smoothing_alpha=0.15)
    assert len(ds) == g["length"]
    for j, i in enumerate(g["idxs"]):
        np.testing.assert_allclose(ds[int(i)], g["items"][j], atol=1e-5)
    ref = g["actA"]
    mask = ~np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(ds.frames[: ref.shape[0]]), ~mask)
    np.testing.assert_allclose(ds.frames[: ref.shape[0]][mask], ref[mask],
                               atol=1e-5)


@pytest.mark.parametrize("split,canonicalize", [
    ("train", True), ("val", True), ("test", True), ("train", False)])
def test_ais_dataset_matches_jax(tmp_path, split, canonicalize):
    """Frame for frame (NaNs in the same places) and window for window on
    each split, with a detection failure on the corpus's first frame and on
    its last, and without canonicalization."""
    fixtures.make_ais_corpus(str(tmp_path), actions=AIS_ALL_ACTIONS,
                             n_frames=300, fail_frames=FAIL_FRAMES, seed=7)
    actions = {"train": AIS_TRAIN_ACTIONS, "val": AIS_VAL_ACTIONS,
               "test": AIS_TEST_ACTIONS}[split]
    kw = dict(actions=actions, smoothing_alpha=0.15,
              canonicalize=canonicalize)
    want = JaxAISDataset(str(tmp_path), 10, 25, 2, **kw)
    got = AISDataset(str(tmp_path), 10, 25, 2, **kw)
    np.testing.assert_array_equal(got.window_starts, want.window_starts)
    assert got.seq_len == want.seq_len and got.actions == want.actions
    assert got.frames.dtype == np.float32 and np.isnan(got.frames).any()
    np.testing.assert_array_equal(np.isnan(got.frames), np.isnan(want.frames))
    np.testing.assert_array_equal(got.frames, want.frames)
    windows = np.stack([got[i] for i in range(len(got))])
    assert np.isfinite(windows).all()


# ------------------------------------------------------- runners vs JAX

def _ais_argv(data_dir, save, *extra):
    return ["--data_dir", data_dir, "--save_path", save, "--num_blocks", "2",
            "--hidden_dim", "16", "--regularization", "0", "--batch_size",
            "128", "--n_epochs", "2", *extra]


def _jax_init(jmodel, rows: int):
    """The variables the JAX trainers' ``init_state(PRNGKey(0))`` draw for
    ``jmodel`` (its first split of the key), as numpy."""
    init_rng, _ = jax.random.split(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, jmodel.init(
        init_rng, jnp.zeros((2, rows, len(AIS_DIM_USED))), training=False))


def _assert_histories_agree(got, want):
    for key in ("train", "val"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, err_msg=key)
    for key in ("mpjpe", "auc_pck"):
        np.testing.assert_allclose(got["metrics"][key], want["metrics"][key],
                                   rtol=1e-3, err_msg=key)
    assert set(got["per_action"]) == set(AIS_TEST_ACTIONS)


def test_run_ais_matches_jax(ais_dir, tmp_path):
    """JAX run_ais and the port's from one init, 2 epochs: per-epoch train
    and val loss, test MPJPE (mm, x1000 in both) and AUC-PCK agree at rtol
    1e-3; the checkpoint serves through B2's plain version within 1e-5 of
    the plain forward."""
    jargs = jax_cli.parse_args(_ais_argv(ais_dir, str(tmp_path / "jax")))
    args = cli.parse_args(_ais_argv(ais_dir, str(tmp_path / "port"), "--dev",
                                    "cpu"))
    for a in (jargs, args):
        a.conv1_kernel_shape = (a.kernel1_x, a.kernel1_y)
    jmodel = jax_build(jargs, 33, 33, 10, 10)
    variables = _jax_init(jmodel, 10)
    want, _, _ = jax_run_ais(jargs, model=jmodel)
    got, trainer = run_ais(args, init_state_dict=state_dict_from_jax(
        variables, 2, 64, 0.1))
    assert trainer.model.dimPosIn == 33 and trainer.input_scale == 1.0
    _assert_histories_agree(got, want)
    assert 100.0 < got["test"][0] < 5000.0  # millimetres

    path = str(tmp_path / "port" / "ais_3d_10frames_ckpt" / STATE_FILE)
    p = Predictor.from_checkpoint(None, path, device="cpu")
    assert type(p._fused).__name__ == "FusedConvMixer"
    x = np.random.RandomState(0).randn(7, 10, 33).astype(np.float32) * 0.3
    with torch.no_grad():
        plain = p.model(torch.from_numpy(x))
    torch.testing.assert_close(p.predict(x), plain, rtol=0, atol=1e-5)


def test_run_ais_autoregressive_matches_jax(ais_dir, tmp_path):
    """JAX run_ais_autoregressive and the port's from one init, one
    teacher-forcing and one closed-loop epoch: per-epoch losses, the
    rollout MPJPE (mm) and the AUC-PCK on raw meters agree at rtol 1e-3."""
    extra = ["--n_epochs_teacher_forcing", "1"]
    jargs = jax_ar_cli.parse_args(_ais_argv(ais_dir, str(tmp_path / "jax"),
                                            *extra))
    args = ar_cli.parse_args(_ais_argv(ais_dir, str(tmp_path / "port"),
                                       *extra, "--dev", "cpu"))
    for a in (jargs, args):
        a.conv1_kernel_shape = (a.kernel1_x, a.kernel1_y)
    jmodel = jax_build(jargs, 33, 33, 10, 5)
    variables = _jax_init(jmodel, 10)
    want, _, _ = jax_run_ais_ar(jargs, model=jmodel)
    got, trainer = run_ais_autoregressive(
        args, init_state_dict=state_dict_from_jax(variables, 2, 0, 0.0))
    assert isinstance(trainer, AutoregressiveTrainer)
    assert trainer.auc_scale == 1.0 and trainer.model.conv1_kernel_shape == (5, 5)
    _assert_histories_agree(got, want)


@pytest.mark.parametrize("runner", ["direct", "autoregressive"])
def test_run_ais_trains_with_a_failed_first_frame(tmp_path, runner):
    """A detection failure on frame 0 of every action leaves that frame NaN
    and moves the first valid window off frame 0; the last batch's padding
    rows repeat that window, so the losses, metrics and weights stay
    finite (padding with frame 0 would train NaN)."""
    data_dir = str(tmp_path / "ais")
    fixtures.make_ais_corpus(data_dir, actions=AIS_ALL_ACTIONS, n_frames=300,
                             fail_frames=(0, 150), seed=3)
    mod, run, extra = {
        "direct": (cli, run_ais, ("--n_epochs", "1")),
        "autoregressive": (ar_cli, run_ais_autoregressive,
                           ("--n_epochs", "1",
                            "--n_epochs_teacher_forcing", "1")),
    }[runner]
    args = mod.parse_args(_ais_argv(data_dir, str(tmp_path / "run"), *extra,
                                    "--dev", "cpu"))
    args.conv1_kernel_shape = (args.kernel1_x, args.kernel1_y)
    n_in, n_out = ((args.input_n, args.output_n) if runner == "direct" else
                   (args.input_n_dataset, args.output_n_dataset))
    train = AISDataset(data_dir, n_in, n_out, args.skip_rate,
                       AIS_TRAIN_ACTIONS, args.smoothing_alpha)
    assert np.isnan(train.frames[0]).all() and train.window_starts[0] > 0
    assert len(train) % args.batch_size  # the last batch is padded
    hist, trainer = run(args)
    for key in ("train", "val", "test"):
        assert np.isfinite(hist[key]).all(), key
    for name, v in trainer.model.state_dict().items():
        assert torch.isfinite(v.float()).all(), name


@pytest.mark.parametrize("mod", [cli, ar_cli], ids=["direct",
                                                    "autoregressive"])
def test_ais_cli_defaults_to_the_card(ais_dir, tmp_path, mod):
    """--dev defaults to cuda; with no card the CLI raises instead of
    falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device would train")
    for extra in ((), ("--dev", "cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.main(["--data_dir", ais_dir, "--save_path",
                      str(tmp_path / "x"), *extra])


# ------------------------------------------------ checkpoint metas

META_CASES = {
    "h36m angle": (h36m_cli, jax_h36m_cli, ["--num_blocks", "2",
                                             "--hidden_dim", "12"], False),
    "h36m angle autoregressive": (h36m_ar_cli, jax_ar_h36m_cli, [
        "--loss_type", "angle", "--num_blocks", "1", "--hidden_dim", "12",
        "--conv_nChan", "2"], True),
    "ais": (cli, jax_cli, ["--num_blocks", "2", "--hidden_dim", "12"], True),
    "ais autoregressive": (ar_cli, jax_ar_cli, ["--num_blocks", "2",
                                                "--hidden_dim", "12"], True),
}


@pytest.mark.parametrize("case", list(META_CASES))
def test_model_from_checkpoint_meta_builds_the_jax_model(case):
    """A checkpoint's stored args rebuild the ConvMixer JAX
    ``model_from_checkpoint_meta`` builds (an H36M angle run on 48 dims, an
    AIS run on 33, found by its kernel flags without a model_type): the
    same parameter names and shapes."""
    mod, jax_mod, argv, kernel = META_CASES[case]
    meta = vars(mod.parse_args(argv))
    jmeta = vars(jax_mod.parse_args(argv))
    if kernel:  # the CLIs' main adds it before training
        for m in (meta, jmeta):
            m["conv1_kernel_shape"] = (m["kernel1_x"], m["kernel1_y"])
    model = model_from_checkpoint_meta(meta)
    jmodel, shape = jax_model_from_meta(jmeta)
    assert isinstance(model, ConvMixer) and model.dimPosIn == shape[2]
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros(shape),
                            training=False)
    sd = state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables), jmeta["num_blocks"],
        jmeta.get("encoder_n_harmonic_functions", 64),
        jmeta.get("encoder_omega0", 0.1))
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()
        if not k.endswith("num_batches_tracked")}

"""The port's AMASS path on the CPU, against the goldens and the JAX
package: SMPL forward kinematics, the synthetic corpus writer, the dataset
for all three splits, ``run_amass`` (train, validation and the 22-joint
scatter test) from one exported init, the AMASS training and test CLIs,
and the H36M CLI's ``--model_type mlp``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionmixerconv_tpu.cli import test_mixer_amass as jax_test_cli
from motionmixerconv_tpu.cli import train_mixer_amass as jax_cli
from motionmixerconv_tpu.cli._runner import build_mlp_mixer as jax_build
from motionmixerconv_tpu.cli._runner import run_amass as jax_run_amass
from motionmixerconv_tpu.data import AMASSDataset as JaxAMASSDataset
from motionmixerconv_tpu.data import fixtures as jfix
from motionmixerconv_tpu.geometry import load_smpl_skeleton as jax_skeleton
from motionmixerconv_tpu_torch.cli import test_mixer_amass as test_cli
from motionmixerconv_tpu_torch.cli import train_mixer_amass as cli
from motionmixerconv_tpu_torch.cli._runner import (STATE_FILE, WEIGHTS_FILE,
                                                   run_amass)
from motionmixerconv_tpu_torch.data import AMASSDataset, fixtures
from motionmixerconv_tpu_torch.geometry import ang2joint, load_smpl_skeleton
from motionmixerconv_tpu_torch.models import MlpMixer, state_dict_from_jax
from motionmixerconv_tpu_torch.serving import Predictor

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests compute small tensors, which one intra-op thread does as
    fast as eight; the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_ang2joint_matches_golden():
    """SMPL FK against the reference's ang2joint output (atol 1e-5, as
    tests/test_geometry.py)."""
    g = np.load(os.path.join(GOLDEN, "ang2joint.npz"))
    fn = g["poses"].shape[0]
    p3d0 = torch.from_numpy(np.repeat(g["p3d0"], fn, axis=0))
    out = ang2joint(p3d0, torch.from_numpy(g["poses"]), g["parents"])
    np.testing.assert_allclose(out.numpy(), g["xyz"], atol=1e-5)


def test_skeleton_asset_is_the_jax_packages():
    p3d0, parents = load_smpl_skeleton()
    jp3d0, jparents = jax_skeleton()
    assert p3d0.shape == (1, 52, 3) and parents[0] == -1
    np.testing.assert_array_equal(p3d0, jp3d0)
    np.testing.assert_array_equal(parents, jparents)


def test_make_amass_corpus_writes_the_jax_packages_files(tmp_path):
    """One seed writes the same npz files from either package."""
    kw = dict(splits=[["CMU", "KIT"], ["SFU"]], n_subjects=2, n_acts=2,
              n_frames=60, seed=7)
    fixtures.make_amass_corpus(str(tmp_path / "port"), **kw)
    jfix.make_amass_corpus(str(tmp_path / "jax"), **kw)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "jax")
                   for d, _, fs in os.walk(tmp_path / "jax") for f in fs)
    assert len(files) == 12
    for rel in files:
        with np.load(tmp_path / "port" / rel) as a, \
                np.load(tmp_path / "jax" / rel) as b:
            assert sorted(a.files) == sorted(b.files) == [
                "mocap_framerate", "poses"]
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=rel)


@pytest.fixture(scope="module")
def amass_dir(tmp_path_factory):
    td = tmp_path_factory.mktemp("amass_torch")
    fixtures.make_amass_corpus(str(td), n_frames=300, frame_rate=50.0, seed=3)
    return str(td)


@pytest.mark.parametrize("split", [0, 1, 2])
def test_dataset_matches_golden_and_jax(amass_dir, split):
    """Items against the reference dataset (tests/golden/dataset_amass.npz,
    atol 1e-5) and every frame against the JAX package's dataset."""
    g = np.load(os.path.join(GOLDEN, "dataset_amass.npz"))
    ds = AMASSDataset(amass_dir, 10, 25, 5, split=split)
    assert len(ds) == g[f"s{split}_len"]
    for j, i in enumerate(g[f"s{split}_idxs"]):
        np.testing.assert_allclose(ds[int(i)], g[f"s{split}_items"][j],
                                   atol=1e-5)
    jds = JaxAMASSDataset(amass_dir, 10, 25, 5, split=split)
    np.testing.assert_array_equal(ds.window_starts, jds.window_starts)
    np.testing.assert_allclose(ds.frames, jds.frames, atol=1e-5)
    assert ds[0].shape == (35, 52, 3) and ds.frames.shape[1] == 156


SMALL = ["--skip_rate", "5", "--num_blocks", "2", "--hidden_dim", "16",
         "--channels_mlp_dim", "24", "--tokens_mlp_dim", "8",
         "--batch_size", "20", "--regularization", "0"]


@pytest.fixture(scope="module")
def runs(amass_dir, tmp_path_factory):
    """The JAX run_amass and the port's from one exported init, 2 epochs,
    dropout off."""
    td = tmp_path_factory.mktemp("amass_runs")
    argv = ["--data_dir", amass_dir, "--n_epochs", "2", *SMALL]
    jargs = jax_cli.parse_args([*argv, "--save_path", str(td / "jax")])
    jargs.model_path = None  # the JAX default writes into checkpoints/
    args = cli.parse_args([*argv, "--save_path", str(td / "port"),
                           "--dev", "cpu"])
    jmodel = jax_build(jargs, 54, 10, 25)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 10, 54)), training=False))
    want, _, _ = jax_run_amass(jargs, model=jmodel, init_variables=jax.tree_util
                               .tree_map(jnp.asarray, variables))
    got, trainer = run_amass(args, init_state_dict=state_dict_from_jax(
        variables, 2))
    return want, got, trainer, variables, str(td / "port" /
                                              "amass_3d_25frames_ckpt")


def test_runner_matches_jax_run_amass(runs):
    """Per-epoch train loss, validation loss and 22-joint test MPJPE agree
    with the JAX package's at rtol 1e-3, as test_runner_matches_jax_run_h36m
    holds the H36M runner; the train loss falls."""
    want, got, trainer, _, run_dir = runs
    assert isinstance(trainer.model, MlpMixer)
    for key in ("train", "val", "test"):
        assert len(got[key]) == 2
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, err_msg=key)
    assert got["train"][1] < got["train"][0]
    assert {STATE_FILE, WEIGHTS_FILE} <= set(os.listdir(run_dir))


def test_test_cli_matches_the_jax_cli(runs, amass_dir, tmp_path):
    """The AMASS test CLI on a reference-layout .pt of the JAX init equals
    the JAX CLI on the same file (rtol 1e-5); on the port run's
    train_state.pt (its stored args fill the architecture flags) it repeats
    the run's last test MPJPE. On the JAX run's model.ckpt (its meta fills
    the architecture flags) it gives the JAX CLI's number on that file
    (rtol 1e-5)."""
    _, got, _, variables, run_dir = runs
    pt = str(tmp_path / "init.pt")
    torch.save(state_dict_from_jax(variables, 2), pt)
    flags = ["--data_dir", amass_dir, "--skip_rate", "5", "--num_blocks",
             "2", "--hidden_dim", "16", "--channels_mlp_dim", "24",
             "--tokens_mlp_dim", "8", "--batch_size", "20"]
    want = jax_test_cli.main([*flags, "--model_path", pt])
    mine = test_cli.main([*flags, "--model_path", pt, "--dev", "cpu"])
    assert mine == pytest.approx(want, rel=1e-5)
    last = test_cli.main(["--data_dir", amass_dir, "--dev", "cpu",
                          "--batch_size", "20", "--model_path",
                          os.path.join(run_dir, STATE_FILE)])
    assert last == pytest.approx(got["test"][-1], rel=1e-5)
    ckpt = os.path.join(os.path.dirname(os.path.dirname(run_dir)), "jax",
                        "amass_3d_25frames_ckpt", "model.ckpt")
    argv = ["--data_dir", amass_dir, "--batch_size", "20", "--model_path",
            ckpt]
    want = jax_test_cli.main(argv)
    assert test_cli.main([*argv, "--dev", "cpu"]) == pytest.approx(
        want, rel=1e-5)


def test_train_state_serves_through_b4(runs):
    """``Predictor.from_checkpoint(None, train_state.pt)`` rebuilds the
    AMASS MlpMixer (54 dims) from the stored args and serves it through
    B4's plain version on the CPU, equal to the trained module."""
    _, _, trainer, _, run_dir = runs
    p = Predictor.from_checkpoint(None, os.path.join(run_dir, STATE_FILE),
                                  device="cpu")
    assert type(p._fused).__name__ == "FusedMlpMixer"
    assert (p.model.input_size, p.model.hidden_dim, p.model.num_blocks) == (
        54, 16, 2)
    x = torch.randn(4, 10, 54)
    with torch.no_grad():
        want = trainer.model.eval()(x)
    torch.testing.assert_close(p.predict(x), want, rtol=0, atol=2e-5)


def test_cli_defaults_to_the_card(amass_dir, tmp_path):
    """--dev defaults to cuda and raises without a card; the CLI's defaults
    are the reference's."""
    argv = ["--data_dir", amass_dir, "--n_epochs", "1", *SMALL]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([*argv, "--save_path", str(tmp_path / "a")])
    args = cli.parse_args([])
    assert (args.hidden_dim, args.num_blocks, args.tokens_mlp_dim,
            args.channels_mlp_dim, args.pose_dim, args.batch_size,
            args.activation, args.r_se, args.dev, args.model_path) == (
        128, 5, 20, 128, 54, 200, "gelu", 8, "cuda", None)

"""The port's ``viz`` package, ``Trainer.evaluate`` and ``--visualize`` on
the CPU, each against the JAX package on the same numpy inputs and the
same weights (a JAX ``.ckpt``, or ``state_dict_from_jax`` of its
variables).

Tolerances: rendered frames bit-identical (matplotlib draws both from the
same arrays; the images are captured before the GIF writer, or the GIFs
decoded); forwards and evaluations at 1e-5 relative (float32 through two
frameworks; ``tests/test_torch_checkpoint.py`` holds CLI numbers at 1e-5);
``tables.md``'s printed numbers within their last printed digit. Windows
are short (4 input, 3 output frames; SE reduction 4) so a GIF is a few
rendered frames.
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from motionmixerconv_tpu._native import build as jax_native
from motionmixerconv_tpu.cli import _runner as jax_runner
from motionmixerconv_tpu.cli import train_mixer_h36m as jax_cli
from motionmixerconv_tpu.cli._runner import \
    model_from_checkpoint_meta as jax_model_from_meta
from motionmixerconv_tpu.data import H36MDataset as JaxH36MDataset
from motionmixerconv_tpu.data import fixtures as jfix
from motionmixerconv_tpu.data.constants import AIS_ALL_ACTIONS
from motionmixerconv_tpu.train import Trainer as JaxTrainer
from motionmixerconv_tpu.train import make_optimizer as jax_make_optimizer
from motionmixerconv_tpu.train.state import TrainState
from motionmixerconv_tpu.train.state import save_checkpoint as jax_save
from motionmixerconv_tpu.viz import ais_raw as jax_ais_raw
from motionmixerconv_tpu.viz import galleries as jax_galleries
from motionmixerconv_tpu.viz import gif as jax_gif
from motionmixerconv_tpu.viz import live as jax_live
from motionmixerconv_tpu.viz._meta import \
    resolve_h36m_eval_args as jax_resolve
from motionmixerconv_tpu_torch.cli import _runner
from motionmixerconv_tpu_torch.cli import train_mixer_h36m as cli
from motionmixerconv_tpu_torch.data import H36MDataset
from motionmixerconv_tpu_torch.data.constants import H36M_DIM_USED_XYZ
from motionmixerconv_tpu_torch.models import state_dict_from_jax
from motionmixerconv_tpu_torch.train import Trainer
from motionmixerconv_tpu_torch.viz import ais_raw, galleries, gif, live
from motionmixerconv_tpu_torch.viz._meta import resolve_h36m_eval_args

IN_N, OUT_N = 4, 3
TOL = 1e-5
N_HARMONICS = 4  # a small harmonic embedding on the CPU


@pytest.fixture(autouse=True, scope="module")
def _private_jax_reader(tmp_path_factory):
    """The JAX package's datasets read through its native reader built into
    a private cache, never the shared default one (where concurrent cold
    builds race, ``tests/test_torch_native_csv.py``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MMC_NATIVE_CACHE",
                  str(tmp_path_factory.mktemp("jax_native")))
        mp.setattr(jax_native, "_LIB", None)
        mp.setattr(jax_native, "_TRIED", False)
        assert jax_native.load_csv_reader() is not None
        yield


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, as the suite's workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    """Within ``tol`` of the reference's largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1.0))


def _train_argv(data_dir, save, *extra):
    return ["--data_dir", data_dir, "--save_path", save, "--loss_type",
            "mpjpe", "--input_n", str(IN_N), "--output_n", str(OUT_N),
            "--skip_rate", "5", "--num_blocks", "1", "--hidden_dim", "8",
            "--r_se", "4", "--actions_to_consider", "walking",
            "--batch_size", "512", *extra]


def _jax_ckpt(path, meta, seed):
    """A JAX-written ``.ckpt`` of the model ``meta`` describes,
    initialised from ``seed``; returns its variables (numpy)."""
    model, shape = jax_model_from_meta(meta)
    variables = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(seed), jnp.zeros(shape), training=False))
    opt = jax_make_optimizer(1e-3, steps_per_epoch=3)
    state = TrainState(step=jnp.asarray(0, jnp.int32),
                       params=variables["params"], batch_stats={},
                       opt_state=opt.init(variables["params"]),
                       rng=jax.random.PRNGKey(seed))
    jax_save(path, state, 0, meta=meta)
    return variables


def _meta(data_dir, *extra):
    meta = vars(jax_cli.parse_args(_train_argv(data_dir, "unused", *extra)))
    meta["encoder_n_harmonic_functions"] = N_HARMONICS
    return meta


@pytest.fixture(scope="module")
def h36m_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("h36m_viz"))
    jfix.make_h36m_corpus(d, n_frames=340, seed=11)
    return d


@pytest.fixture(scope="module")
def ckpts(h36m_dir, tmp_path_factory):
    """JAX ``.ckpt`` files with meta: {delta_x: (path, variables)}."""
    d = tmp_path_factory.mktemp("viz_ckpts")
    out = {}
    for dx in (False, True):
        path = str(d / f"model_dx{int(dx)}.ckpt")
        extra = ("--delta_x", "1") if dx else ()
        out[dx] = (path, _jax_ckpt(path, _meta(h36m_dir, *extra), 3 + dx))
    return out


def _trainers(h36m_dir, variables, delta_x):
    """A JAX (trainer, state) and the port's trainer on the CPU, both
    holding ``variables``."""
    args = jax_cli.parse_args(_train_argv(h36m_dir, "x"))
    args.encoder_n_harmonic_functions = N_HARMONICS
    jmodel = jax_runner.build_conv_mixer(args, 66, 66, IN_N, OUT_N)
    kw = dict(loss_type="mpjpe", dim_used=H36M_DIM_USED_XYZ, input_n=IN_N,
              output_n=OUT_N, input_scale=1e-3, delta_x=delta_x)
    jtr = JaxTrainer(jmodel, jax_make_optimizer(1e-3, steps_per_epoch=3), **kw)
    state = jtr.init_state(jax.random.PRNGKey(0)).replace(
        params=jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    return (jtr, state), Trainer(_port_model(h36m_dir, variables), None,
                                 **kw)


def _port_model(h36m_dir, variables):
    args = cli.parse_args(_train_argv(h36m_dir, "x"))
    args.encoder_n_harmonic_functions = N_HARMONICS
    model = _runner.build_conv_mixer(args, 66, 66, IN_N, OUT_N)
    model.load_state_dict(state_dict_from_jax(variables, 1, N_HARMONICS, 0.1))
    return model


# ---------------------------------------------------------------- rendering

def _captured(monkeypatch, module):
    """The images ``module``'s renderers hand to the GIF writer."""
    shots = []
    monkeypatch.setattr(module, "_write_gif",
                        lambda images, path: shots.append(images))
    return shots


def _walk(rs, t, d, scale):
    return (rs.randn(1, d) * scale
            + np.cumsum(rs.randn(t, d) * scale * 0.05, axis=0)
            ).astype(np.float32)


@pytest.mark.parametrize("kind", ["h36m", "h36m_prediction_only", "ais"])
def test_rendered_frames_bit_identical_to_jax(monkeypatch, kind):
    rs = np.random.RandomState(len(kind))
    d, scale = (57, 0.5) if kind == "ais" else (96, 300.0)
    full, gt_, train = (_walk(rs, 3, d, scale), _walk(rs, 3, d, scale),
                        _walk(rs, 2, d, scale))
    if kind == "h36m_prediction_only":
        gt_ = train = None
    name = "visualize_batch_ais" if kind == "ais" else "visualize_batch"
    shots = {}
    for tag, mod in (("jax", jax_gif), ("port", gif)):
        shots[tag] = _captured(monkeypatch, mod)
        getattr(mod, name)(full, "unused.gif", batch_gt=gt_,
                           batch_train=train)
    (want,), (got,) = shots["jax"], shots["port"]
    assert len(got) == len(want) == (3 if train is None else 5)
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_rendering_takes_tensors(monkeypatch):
    """A tensor renders as its numpy array does."""
    rs = np.random.RandomState(4)
    full, train = _walk(rs, 2, 96, 300.0), _walk(rs, 2, 96, 300.0)
    shots = _captured(monkeypatch, gif)
    gif.visualize_batch(full, "a.gif", batch_train=train)
    gif.visualize_batch(torch.from_numpy(full), "b.gif",
                        batch_train=torch.from_numpy(train))
    for a, b in zip(*shots):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------- model paths

@pytest.mark.parametrize("delta_x", [False, True])
def test_export_arrays_match_jax(h36m_dir, ckpts, monkeypatch, delta_x):
    """``h36m_visualization_arrays`` (windows 10-11 of the test split: the
    prediction, decoded under delta_x, in the full skeleton, the ignored
    joints re-inserted; the ground truth likewise; the input frames)
    against what JAX ``export_h36m_visualizations`` renders."""
    import motionmixerconv_tpu.viz as jax_viz

    _, variables = ckpts[delta_x]
    (jtr, state), tr = _trainers(h36m_dir, variables, delta_x)
    ds = JaxH36MDataset(h36m_dir, IN_N, OUT_N, 5, actions=["walking"],
                        split=2)
    calls = []
    monkeypatch.setattr(jax_viz, "visualize_batch",
                        lambda full, path, batch_gt, batch_train:
                        calls.append((full, batch_gt, batch_train)))
    jax_runner.export_h36m_visualizations(jtr, state, ds, "/nonexistent/x",
                                          "walking")
    got = _runner.h36m_visualization_arrays(
        tr, H36MDataset(h36m_dir, IN_N, OUT_N, 5, actions=["walking"],
                        split=2))
    assert len(calls) == 2 and all(a.shape[0] == 2 for a in got)
    for i, (full, gt_, train) in enumerate(calls):
        _close(got[0][i], full)
        _close(got[1][i], gt_)   # the frames: forward kinematics in each
        _close(got[2][i], train)


@pytest.mark.parametrize("kind", ["val", "h36m_xyz", "simple"])
def test_trainer_evaluate_matches_jax(h36m_dir, ckpts, kind):
    _, variables = ckpts[False]
    (jtr, state), tr = _trainers(h36m_dir, variables, False)
    ds = H36MDataset(h36m_dir, IN_N, OUT_N, 5, split=2,
                     actions=["walking", "eating"])
    jds = JaxH36MDataset(h36m_dir, IN_N, OUT_N, 5, split=2,
                         actions=["walking", "eating"])
    want = jtr.evaluate(state, jds, jnp.asarray(jds.frames), 96, kind=kind)
    got = tr.evaluate(ds, ds.frames_on("cpu"), 96, kind=kind)
    if kind == "val":
        assert isinstance(got, float)
        assert got == pytest.approx(want, rel=TOL)
        assert got == tr.validate(ds, ds.frames_on("cpu"), 96)
    else:
        assert len(got) == 2 and all(isinstance(v, float) for v in got)
        np.testing.assert_allclose(got, want, rtol=TOL)


def _table_numbers(path):
    return [tuple(float(x) for x in re.findall(r"[-\d.]+", ln.split("|", 2)[2]))
            for ln in open(path) if ln.startswith("| ") and "---" not in ln
            and "action" not in ln]


def test_galleries_tables_from_a_jax_ckpt(h36m_dir, ckpts, tmp_path,
                                          monkeypatch):
    """h36m_galleries on one JAX .ckpt (its meta rebuilds the model): the
    per-action MPJPE and AUC-PCK against the JAX galleries' at 1e-5, and
    tables.md's printed numbers within their last digit; with max_gifs 0
    the port imports no matplotlib."""
    path, _ = ckpts[False]
    acts = ["walking", "eating"]
    want = jax_galleries.h36m_galleries(path, h36m_dir, str(tmp_path / "jax"),
                                        actions=acts, max_gifs=0)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    got = galleries.main(["--checkpoint", path, "--data_dir", h36m_dir,
                          "--out", str(tmp_path / "port"), "--dev", "cpu",
                          "--max_gifs", "0", "--actions", *acts])
    assert [r[0] for r in got] == [r[0] for r in want] == acts
    np.testing.assert_allclose([r[1:] for r in got], [r[1:] for r in want],
                               rtol=TOL)
    tg = _table_numbers(tmp_path / "port" / "tables.md")
    tw = _table_numbers(tmp_path / "jax" / "tables.md")
    assert len(tg) == len(tw) == 3  # two actions and the average
    np.testing.assert_allclose(tg, tw, rtol=0, atol=0.0100001)


@pytest.mark.parametrize("delta_x", [False, True])
def test_predict_windows_matches_jax(h36m_dir, ckpts, delta_x):
    path, _ = ckpts[delta_x]
    want_gt, want = jax_live.predict_windows(path, h36m_dir, "walking",
                                             "test", n_viz=2)
    got_gt, got = live.predict_windows(path, h36m_dir, "walking", "test",
                                       n_viz=2, device="cpu")
    assert got.shape == got_gt.shape == (2, OUT_N, 32, 3)
    _close(got_gt, want_gt)
    _close(got, want)
    if delta_x:  # decoded: anchored at the last observed pose, not near 0
        assert np.abs(got).mean() > 10.0


def test_resolve_eval_args_matches_jax(h36m_dir, ckpts, tmp_path):
    """Defaults, then the checkpoint's meta, then explicit overrides; the
    same model (parameter count) as the JAX package's."""
    path, _ = ckpts[True]
    ov = {"skip_rate": 1}
    jargs, jmodel = jax_resolve(path, h36m_dir, str(tmp_path), overrides=ov)
    args, model = resolve_h36m_eval_args(path, h36m_dir, str(tmp_path),
                                         overrides=ov)
    for k in ("input_n", "output_n", "hidden_dim", "num_blocks", "delta_x",
              "loss_type", "skip_rate", "encoder_n_harmonic_functions",
              "data_dir", "save_path"):
        assert getattr(args, k) == getattr(jargs, k), k
    assert args.skip_rate == 1 and args.delta_x
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IN_N, 66)),
                            training=False)
    n_jax = sum(np.size(v) for v in jax.tree_util.tree_leaves(variables))
    assert sum(p.numel() for p in model.parameters()) == n_jax


def test_resolve_refuses_an_angle_checkpoint(tmp_path):
    meta = vars(jax_cli.parse_args(["--num_blocks", "1", "--hidden_dim",
                                    "8"]))
    meta["encoder_n_harmonic_functions"] = 2
    path = str(tmp_path / "angle.ckpt")
    _jax_ckpt(path, meta, 0)
    for resolve in (jax_resolve, resolve_h36m_eval_args):
        with pytest.raises(ValueError, match="needs an mpjpe checkpoint"):
            resolve(path, "d", str(tmp_path))


# --------------------------------------------------------------------- AIS

@pytest.fixture(scope="module")
def ais_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("ais_viz"))
    jfix.make_ais_corpus(d, actions=AIS_ALL_ACTIONS[:1], n_frames=12,
                         fail_frames=(1, 2), seed=2)
    return d


def test_load_raw_action_matches_jax(ais_dir):
    pos, score = ais_raw.load_raw_action(ais_dir, AIS_ALL_ACTIONS[0])
    jpos, jscore = jax_ais_raw.load_raw_action(ais_dir, AIS_ALL_ACTIONS[0])
    assert pos.dtype == score.dtype == np.float32
    assert pos.shape == (12, 27, 3) and (score == 0).sum() == 2
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(score, jscore)


def test_raw_action_frames_bit_identical_to_jax(ais_dir, monkeypatch):
    """visualize_raw_action's frames, failed keypoints skipped, as the JAX
    viewer draws them."""
    shots = {}
    for tag, mod in (("jax", jax_ais_raw), ("port", ais_raw)):
        shots[tag] = _captured(monkeypatch, mod)
        mod.visualize_raw_action(ais_dir, AIS_ALL_ACTIONS[0], "unused.gif",
                                 max_frames=3)
    (want,), (got,) = shots["jax"], shots["port"]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------- the viewers

def _gif_frames(path):
    with Image.open(path) as im:
        return [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]


def test_visualize_cli_writes_the_jax_frames(h36m_dir, tmp_path,
                                             monkeypatch):
    """``train_mixer_h36m --visualize --dev cpu`` after one epoch at lr 0
    (the weights stay the init's) writes the first test action's two GIFs,
    each decodable, of the JAX run's frames: given the arrays the JAX run
    rendered, the port's writer gives its GIF frame for frame; the port's
    own arrays (its forward kinematics and forward, 1e-6 relative from
    JAX's) move at most 0.1% of the pixels, at antialiased line edges."""
    import motionmixerconv_tpu.viz as jax_viz

    rendered = []
    jax_render = jax_viz.visualize_batch
    monkeypatch.setattr(jax_viz, "visualize_batch",
                        lambda *a, **k: (rendered.append((a, k)),
                                         jax_render(*a, **k)))
    jargs = jax_cli.parse_args(_train_argv(
        h36m_dir, str(tmp_path / "jax"), "--visualize", "--n_epochs", "1",
        "--lr", "0"))
    jargs.encoder_n_harmonic_functions = N_HARMONICS
    jmodel = jax_runner.build_conv_mixer(jargs, 66, 66, IN_N, OUT_N)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(5), jnp.zeros((1, IN_N, 66)), training=False))
    jax_runner.run_h36m(jargs, model=jmodel, init_variables=jax.tree_util
                        .tree_map(jnp.asarray, variables))
    argv = _train_argv(h36m_dir, str(tmp_path / "port"), "--visualize",
                       "--n_epochs", "1", "--lr", "0", "--dev", "cpu")
    cli._require_gif_writer(cli.parse_args(argv))
    args = cli.parse_args(argv)
    args.encoder_n_harmonic_functions = N_HARMONICS
    _runner.run_h36m(args, init_state_dict=state_dict_from_jax(
        variables, 1, N_HARMONICS, 0.1))
    run = "h36_3d_3frames_ckpt"
    assert len(rendered) == 2
    for i, (a, k) in enumerate(rendered):
        want = _gif_frames(tmp_path / "jax" / run / "visualization"
                           / f"walking_{i}.gif")
        same = str(tmp_path / f"same_{i}.gif")
        gif.visualize_batch(a[0], same, **k)
        got = _gif_frames(tmp_path / "port" / run / "visualization"
                          / f"walking_{i}.gif")
        assert len(got) == len(want) == IN_N + OUT_N
        for s_, g, w in zip(_gif_frames(same), got, want):
            np.testing.assert_array_equal(s_, w)
            assert g.shape == w.shape
            assert np.any(g != w, axis=-1).mean() <= 1e-3


def test_live_main_saves_a_gif_on_the_cpu(h36m_dir, ckpts, tmp_path):
    """``viz.live --dev cpu --save``: one decodable GIF a window of
    T_out frames, both skeletons drawn as the JAX viewer draws them."""
    import matplotlib

    matplotlib.use("Agg")
    path, _ = ckpts[False]
    out = tmp_path / "live"
    live.main(["--checkpoint", path, "--data_dir", h36m_dir,
               "--action", "walking", "--n_viz", "1", "--save", str(out),
               "--dev", "cpu"])
    assert os.listdir(out) == ["live_walking_0.gif"]
    assert len(_gif_frames(out / "live_walking_0.gif")) == OUT_N
    gt_, pred = live.predict_windows(path, h36m_dir, "walking", n_viz=1,
                                     device="cpu")
    fig, _ = live.pose_animation(gt_[0], pred[0])
    jfig, _ = jax_live.pose_animation(gt_[0], pred[0])
    lines = [ln.get_data_3d() for ln in fig.axes[0].lines]
    jlines = [ln.get_data_3d() for ln in jfig.axes[0].lines]
    assert len(lines) == len(jlines) == 2 * len(live.H36M_CONNECT)
    for a, b in zip(lines, jlines):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    import matplotlib.pyplot as plt

    plt.close(fig)
    plt.close(jfig)

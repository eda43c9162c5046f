"""The port's geometry, windows, H36M dataset and metrics against the
reference goldens and the JAX package, on the CPU.

Inputs come from numpy seeds and go to both packages; tolerances are the
JAX package's own tests' (tests/test_geometry.py, test_data.py,
test_metrics.py).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionmixerconv_tpu import geometry as jgeo
from motionmixerconv_tpu import metrics as jmet
from motionmixerconv_tpu.data import H36MDataset as JaxH36MDataset
from motionmixerconv_tpu.data import batch_starts as jax_batch_starts
from motionmixerconv_tpu.data import constants as jconst
from motionmixerconv_tpu.data import fixtures as jfix
from motionmixerconv_tpu.data import gather_windows as jax_gather
from motionmixerconv_tpu.metrics.metrics import auc_pck_from_dist as jax_auc
from motionmixerconv_tpu_torch import geometry as geo
from motionmixerconv_tpu_torch import metrics as met
from motionmixerconv_tpu_torch.data import (
    H36MDataset,
    WindowedCorpus,
    batch_starts,
    constants,
    find_indices_256,
    find_indices_srnn,
    fixtures,
    gather_windows,
)
from motionmixerconv_tpu_torch.metrics.metrics import auc_pck_from_dist

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _load(name):
    return np.load(os.path.join(GOLDEN, name))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


# ---------------------------------------------------------------- geometry

# port function, JAX function, golden input, golden output, tolerance
ROTATION_CASES = {
    "expmap2rotmat": ("expmap2rotmat", "r", "R", 1e-5),
    "rotmat2euler": ("rotmat2euler", "R", "eul", 1e-4),
    "rotmat2euler_gimbal_lock": ("rotmat2euler", "R_lock", "eul_lock", 1e-5),
    "rotmat2quat": ("rotmat2quat", "R", "quat", 1e-5),
    "expmap2quat": ("expmap2quat", "r", "equat", 1e-5),
    "quat2expmap": ("quat2expmap", "quats_for_expmap", "quat2expmap", 1e-5),
    "rotmat2expmap": ("rotmat2expmap", "R", "rotmat2expmap", 1e-4),
}


@pytest.mark.parametrize("case", sorted(ROTATION_CASES))
def test_rotations_match_golden_and_jax(case):
    fn, key_in, key_out, atol = ROTATION_CASES[case]
    g = _load("rotations.npz")
    got = getattr(geo, fn)(_t(g[key_in])).numpy()
    np.testing.assert_allclose(got, g[key_out], atol=atol)
    want = np.asarray(getattr(jgeo, fn)(jnp.asarray(g[key_in])))
    np.testing.assert_allclose(got, want, atol=atol)


def test_quat_norm_valid_and_rodrigues_match_jax():
    rs = np.random.RandomState(0)
    q = rs.randn(64, 4).astype(np.float32)
    q[:32] /= np.linalg.norm(q[:32], axis=-1, keepdims=True)
    np.testing.assert_array_equal(
        geo.quat_norm_valid(_t(q)).numpy(),
        np.asarray(jgeo.quat_norm_valid(jnp.asarray(q))))
    r = rs.randn(64, 3).astype(np.float32)
    r[0] = 0.0
    np.testing.assert_allclose(
        geo.rodrigues(_t(r)).numpy(),
        np.asarray(jgeo.rodrigues(jnp.asarray(r))), atol=1e-6)


def test_fkl_matches_golden_and_jax():
    g = _load("fkl.npz")
    got = geo.expmap2xyz(_t(g["frames"])).numpy()
    np.testing.assert_allclose(got, g["xyz"], atol=1e-3)
    want = np.asarray(jgeo.fkl(jnp.asarray(g["frames"], jnp.float32)))
    np.testing.assert_allclose(got, want, atol=1e-3)
    skel, jskel = geo.h36m_skeleton(), jgeo.h36m_skeleton()
    np.testing.assert_array_equal(skel.parent, jskel.parent)
    np.testing.assert_array_equal(skel.offset, jskel.offset)


# ----------------------------------------------------------------- windows

def test_find_indices_bit_parity():
    g = _load("find_indices.npz")
    i1, i2 = find_indices_256(1500, 1700, 35, input_n=10)
    np.testing.assert_array_equal(i1, g["i256_1"])
    np.testing.assert_array_equal(i2, g["i256_2"])
    s1, s2 = find_indices_srnn(1500, 1700, 35, input_n=10)
    np.testing.assert_array_equal(s1, g["isrnn_1"])
    np.testing.assert_array_equal(s2, g["isrnn_2"])


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_batch_starts_and_gather_match_jax(seed):
    """The same shuffle, the same weights and the same gathered windows as
    the JAX package; a weight-0 padding row repeats window 0 (the corpus's
    first window, as both packages' docstrings say), where the JAX package
    reads frame 0, so the two agree wherever the first window starts at
    frame 0 (seed 7 here) and the port's padding never reads a frame that
    no window reads."""
    rs = np.random.RandomState(seed)
    frames = rs.randn(300, 6).astype(np.float32)
    corpus = WindowedCorpus(frames, np.sort(rs.choice(280, 53, replace=False)), 20)
    ours = list(batch_starts(corpus, 16, shuffle=True, seed=seed))
    theirs = list(jax_batch_starts(corpus, 16, shuffle=True, seed=seed))
    assert len(ours) == len(theirs) == 4
    first = int(corpus.window_starts[0])
    assert (first == 0) == (seed == 7)
    ft = _t(frames)
    for (s, w), (js, jw) in zip(ours, theirs):
        np.testing.assert_array_equal(w, jw)
        real = w > 0
        np.testing.assert_array_equal(s[real], js[real])
        np.testing.assert_array_equal(js[~real], 0)
        np.testing.assert_array_equal(s[~real], first)
        np.testing.assert_array_equal(
            gather_windows(ft, torch.from_numpy(s).long(), 20).numpy(),
            np.asarray(jax_gather(jnp.asarray(frames), jnp.asarray(s), 20)))
    assert sum(float(w.sum()) for _, w in ours) == 53
    assert sum(int((w == 0).sum()) for _, w in ours) == 4 * 16 - 53


def test_constants_match_jax():
    for name in ("H36M_DIM_USED_XYZ", "H36M_DIM_USED_ANGLE",
                 "H36M_INDEX_TO_IGNORE_EVAL", "H36M_INDEX_TO_EQUAL_EVAL"):
        np.testing.assert_array_equal(getattr(constants, name),
                                      getattr(jconst, name), err_msg=name)
    assert constants.H36M_ACTIONS == jconst.H36M_ACTIONS
    assert constants.H36M_SUBJECT_SPLITS == jconst.H36M_SUBJECT_SPLITS
    np.testing.assert_array_equal(constants.h36m_dimensions_to_use_xyz(),
                                  jconst.h36m_dimensions_to_use_xyz())
    assert constants.define_actions("all") == jconst.define_actions("all")
    assert constants.define_actions("eating") == ["eating"]
    with pytest.raises(ValueError):
        constants.define_actions("flying")


# ----------------------------------------------------------------- dataset

@pytest.fixture(scope="module")
def h36m_dir(tmp_path_factory):
    td = tmp_path_factory.mktemp("h36m_torch")
    fixtures.make_h36m_corpus(str(td), actions=["walking", "eating"],
                              n_frames=400, seed=123)
    return str(td)


def test_fixtures_write_the_jax_packages_files(tmp_path):
    a, b = tmp_path / "port", tmp_path / "jax"
    fixtures.make_h36m_corpus(str(a), subjects=(5,), actions=["walking"],
                              n_frames=340, seed=4)
    jfix.make_h36m_corpus(str(b), subjects=(5,), actions=["walking"],
                          n_frames=340, seed=4)
    for sub in (1, 2):
        rel = os.path.join("h3.6m", "dataset", "S5", f"walking_{sub}.txt")
        assert (a / rel).read_bytes() == (b / rel).read_bytes()


@pytest.mark.parametrize("mode,split", [(m, s) for m in ("xyz", "angle")
                                        for s in (0, 1, 2)])
def test_h36m_dataset_matches_golden_and_jax(h36m_dir, mode, split):
    """Window starts equal the JAX package's; frames agree with its FK and
    with the reference golden at test_data.py's tolerances."""
    g = _load("dataset_h36m.npz")
    tag, atol = ("xyz", 2e-3) if mode == "xyz" else ("ang", 1e-5)
    kw = dict(actions=["walking", "eating"], split=split, mode=mode)
    ds = H36MDataset(h36m_dir, 10, 25, 5, **kw)
    jds = JaxH36MDataset(h36m_dir, 10, 25, 5, **kw)
    assert len(ds) == g[f"{tag}{split}_len"] == len(jds)
    np.testing.assert_array_equal(ds.window_starts, jds.window_starts)
    np.testing.assert_allclose(ds.frames, jds.frames, atol=atol)
    np.testing.assert_array_equal(ds.dim_used, jds.dim_used)
    for j, i in enumerate(g[f"{tag}{split}_idxs"]):
        np.testing.assert_allclose(ds[int(i)], g[f"{tag}{split}_items"][j],
                                   atol=atol)


# ----------------------------------------------------------------- metrics

def test_metrics_match_golden_and_jax():
    g = _load("metrics.npz")
    pred, gt = _t(g["pred"]), _t(g["gt"])
    np.testing.assert_allclose(met.mpjpe_error(pred, gt).item(), g["mpjpe"],
                               rtol=1e-5)
    auc = met.auc_pck_metric(pred.reshape(-1, 25, 22, 3) / 1000.0,
                             gt.reshape(-1, 25, 22, 3) / 1000.0)
    np.testing.assert_allclose(auc.item(), g["auc"], rtol=1e-4)
    ap, ag = _t(g["ang_pred"]), _t(g["ang_gt"])
    np.testing.assert_allclose(met.euler_error(ap, ag).item(), g["euler"],
                               rtol=1e-4)
    np.testing.assert_allclose(met.joint_angle_error(ap, ag).item(),
                               g["joint_angle"], rtol=1e-5)
    np.testing.assert_allclose(
        met.delta_2_gt(_t(g["delta"]), _t(g["last"])).numpy(),
        g["delta_decoded"], atol=1e-5)

    rs = np.random.RandomState(3)
    a, b = rs.randn(5, 10, 48).astype(np.float32), rs.randn(5, 10, 48).astype(np.float32)
    for fn in ("l1_angle_loss", "criterion_cos", "criterion_cos2",
               "joint_angle_error"):
        np.testing.assert_allclose(
            getattr(met, fn)(_t(a), _t(b)).numpy(),
            np.asarray(getattr(jmet, fn)(jnp.asarray(a), jnp.asarray(b))),
            rtol=1e-5, atol=1e-6, err_msg=fn)
    th = np.array([0.5, 1.0, 2.0], np.float32)
    np.testing.assert_allclose(
        met.pck(_t(a[..., :3]), _t(b[..., :3]), th).numpy(),
        np.asarray(jmet.pck(jnp.asarray(a[..., :3]), jnp.asarray(b[..., :3]),
                            jnp.asarray(th))), rtol=1e-6)


def test_auc_pck_per_sample_and_nan_match_jax():
    """The closed-form AUC per sample equals the JAX package's, including
    distances on the grid's own values and NaNs (zero credit)."""
    rs = np.random.RandomState(1)
    dist = np.abs(rs.randn(6, 5, 4).astype(np.float32)) * 0.15
    dist[0, 0, :2] = np.arange(0.001, 0.3, 0.001, dtype=np.float32)[[5, 100]]
    dist[1, 2, 3] = np.nan
    dist[2] = np.nan
    got = auc_pck_from_dist(_t(dist), dim=(1, 2)).numpy()
    want = np.asarray(jax_auc(jnp.asarray(dist), axis=(1, 2)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[2] == 0.0

"""The port's rest of data, geometry and models on the CPU, each against
the JAX package and the goldens of the executed reference: the CMU
pipeline (``cmu.npz``), the SRNN normalization (``normalization.npz``),
the AMASS graph (``amass_graph.npz``), the DCT, the masking augmentations,
``make_cmu_corpus`` and ``ConvEncoder``; one CMU training epoch against
the JAX trainer's; and the package surface against the JAX package's.
"""

import ast
import filecmp
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionmixerconv_tpu.data import augment as jax_augment
from motionmixerconv_tpu.data import cmu as jax_cmu
from motionmixerconv_tpu.data import fixtures as jax_fixtures
from motionmixerconv_tpu.geometry import dct as jax_dct
from motionmixerconv_tpu.geometry import graph as jax_graph
from motionmixerconv_tpu.models import ConvEncoder as JaxConvEncoder
from motionmixerconv_tpu.models import ConvMixer as JaxConvMixer
from motionmixerconv_tpu.models import MlpMixer as JaxMlpMixer
from motionmixerconv_tpu.train import Trainer as JaxTrainer
from motionmixerconv_tpu.train import make_optimizer as jax_make_optimizer
from motionmixerconv_tpu_torch.data import augment, cmu, fixtures
from motionmixerconv_tpu_torch.data.normalization import (
    normalization_stats, normalize_data, revert_output_format,
    unNormalizeData)
from motionmixerconv_tpu_torch.geometry import (cmu_skeleton, dct_transform,
                                                fkl, get_adj_AMASS,
                                                get_dct_matrix, idct_transform,
                                                normalize_A,
                                                spatio_temporal_graph)
from motionmixerconv_tpu_torch.geometry.graph import AMASS_EDGES_22
from motionmixerconv_tpu_torch.models import (ConvEncoder, MlpMixer,
                                              PoseEncoder, state_dict_from_jax)
from motionmixerconv_tpu_torch.train import Trainer, make_optimizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
ACTIONS = ["basketball", "walking"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _golden(name):
    return np.load(os.path.join(GOLDEN, name))


@pytest.fixture(scope="module")
def golden():
    return _golden("cmu.npz")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The fixture recipe the CMU golden was made from, by the port."""
    d = str(tmp_path_factory.mktemp("cmu"))
    fixtures.make_cmu_corpus(d, actions=tuple(ACTIONS), n_files=2,
                             n_frames=300, seed=77)
    return d


# ------------------------------------------------------------------- CMU

def test_make_cmu_corpus_writes_the_jax_writers_bytes(corpus, tmp_path):
    jax_fixtures.make_cmu_corpus(str(tmp_path), actions=tuple(ACTIONS),
                                 n_files=2, n_frames=300, seed=77)
    names = [os.path.join(a, f"{a}_{i}.txt") for a in ACTIONS for i in (1, 2)]
    for a in ACTIONS:
        assert sorted(os.listdir(os.path.join(corpus, a))) == sorted(
            os.listdir(tmp_path / a))
    match, mismatch, errors = filecmp.cmpfiles(corpus, str(tmp_path), names,
                                               shallow=False)
    assert (sorted(match), mismatch, errors) == (sorted(names), [], [])


def test_define_actions_cmu():
    assert cmu.define_actions_cmu("walking") == ["walking"]
    assert cmu.define_actions_cmu("all") == list(cmu.CMU_ACTIONS)
    assert cmu.CMU_ACTIONS == jax_cmu.CMU_ACTIONS
    with pytest.raises(ValueError):
        cmu.define_actions_cmu("flying")


def test_load_data_cmu_train_matches_the_golden(golden, corpus):
    sampled, ignore, use, mean, std = cmu.load_data_cmu(corpus, ACTIONS, 10,
                                                        25)
    assert sampled.shape == golden["train_sampled"].shape
    np.testing.assert_allclose(sampled, golden["train_sampled"], atol=1e-6)
    np.testing.assert_array_equal(ignore, golden["train_ignore"])
    np.testing.assert_array_equal(use, golden["train_use"])
    np.testing.assert_allclose(mean, golden["train_mean"], atol=1e-6)
    np.testing.assert_allclose(std, golden["train_std"], atol=1e-6)


def test_load_data_cmu_test_matches_the_golden(golden, corpus):
    sampled, ignore, use, _, _ = cmu.load_data_cmu(
        corpus, ACTIONS, 10, 25, data_std=golden["train_std"].copy(),
        data_mean=golden["train_mean"].copy(), is_test=True)
    assert sampled.shape == (32, 35, 117)  # 2 actions x 2 files x 8 windows
    np.testing.assert_allclose(sampled, golden["test_sampled"], atol=1e-6)
    np.testing.assert_array_equal(ignore, golden["test_ignore"])
    np.testing.assert_array_equal(use, golden["test_use"])


def test_cmu_fk_matches_the_golden_and_jax(golden):
    """The 38-joint FK against the reference's ``fkl_torch`` golden (the
    JAX test's tolerance) and against the JAX package's FK."""
    angles = golden["fk_angles"]
    xyz = cmu.expmap2xyz_cmu(torch.from_numpy(angles)).numpy()
    assert xyz.shape == (64, 38, 3) and cmu_skeleton().num_joints == 38
    scale = np.abs(golden["fk_xyz"]).max()
    np.testing.assert_allclose(xyz, golden["fk_xyz"], atol=2e-4 * scale)
    want = np.asarray(jax_cmu.expmap2xyz_cmu(jnp.asarray(angles)))
    np.testing.assert_allclose(xyz, want, atol=1e-6 * scale)
    zeros = fkl(torch.zeros(2, 3 + 38 * 3), skeleton=cmu_skeleton())
    assert zeros.shape == (2, 38, 3) and torch.isfinite(zeros).all()


def test_load_data_cmu_3d_is_fk_of_the_golden_windows(golden, corpus):
    """xyz windows are the FK of the golden expmap windows; the fixed
    13-joint ignore table in the reference's unsorted order, ignored dims
    at mean 0 and std 1."""
    sampled, ignore, use, mean, std = cmu.load_data_cmu_3d(corpus, ACTIONS,
                                                           10, 25)
    exp = golden["train_sampled"]
    w, t, _ = exp.shape
    want = cmu.expmap2xyz_cmu(torch.from_numpy(exp.reshape(-1, 117))
                              ).numpy().reshape(w, t, 114)
    assert sampled.shape == (w, t, 114)
    np.testing.assert_allclose(sampled, want, atol=1e-3)
    j = cmu.CMU_JOINT_TO_IGNORE_3D
    np.testing.assert_array_equal(
        ignore, np.concatenate((j * 3, j * 3 + 1, j * 3 + 2)))
    np.testing.assert_array_equal(use, np.setdiff1d(np.arange(114), ignore))
    assert np.all(std[ignore] == 1.0) and np.all(mean[ignore] == 0.0)
    assert np.all(std[use] > 0)


@pytest.mark.parametrize("mode,split", [("expmap", 0), ("xyz", 0),
                                        ("xyz", 2)])
def test_cmu_dataset_matches_jax(corpus, golden, mode, split):
    """The port's CMUDataset against the JAX package's: the same window
    starts, dims and statistics, frames within float32 FK rounding."""
    kw = dict(actions=ACTIONS, split=split, mode=mode)
    if split == 2:
        kw.update(data_mean=np.zeros(114), data_std=np.ones(114))
    got = cmu.CMUDataset(corpus, 10, 25, **kw)
    want = jax_cmu.CMUDataset(corpus, 10, 25, **kw)
    np.testing.assert_array_equal(got.window_starts, want.window_starts)
    np.testing.assert_array_equal(got.dimensions_to_use,
                                  want.dimensions_to_use)
    np.testing.assert_array_equal(got.dimensions_to_ignore,
                                  want.dimensions_to_ignore)
    scale = max(1.0, float(np.abs(want.frames).max()))
    np.testing.assert_allclose(got.frames, want.frames, atol=1e-6 * scale)
    np.testing.assert_allclose(got.data_mean, want.data_mean,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(got.data_std, want.data_std, rtol=1e-5,
                               atol=1e-6 * scale)


def test_cmu_dataset_windows_match_dense(corpus):
    ds = cmu.CMUDataset(corpus, 10, 25, actions=["basketball"], split=0)
    dense = ds.dense_windows()
    assert len(ds) == dense.shape[0]
    for i in (0, len(ds) // 2, len(ds) - 1):
        np.testing.assert_array_equal(ds[i], dense[i])


def test_cmu_test_split_reseed_quirk(corpus):
    """The reference reseeds its RandomState per file (data_utils.py:
    369-370): files of equal length draw the same window offsets."""
    ds = cmu.CMUDataset(corpus, 10, 25, actions=["basketball"], split=2,
                        data_mean=np.zeros(117), data_std=np.ones(117))
    file_len = 150  # 300 frames, downsampled 2x
    np.testing.assert_array_equal(ds.window_starts[:8],
                                  ds.window_starts[8:] - file_len)
    with pytest.raises(ValueError, match="test split needs"):
        cmu.CMUDataset(corpus, 10, 25, actions=["basketball"], split=2)


def test_cmu_training_epoch_matches_jax(corpus):
    """One training epoch of a small MlpMixer on the CMU xyz corpus (its 75
    used dims) and its validation, the port's Trainer against the JAX
    package's from one init (dropout off): rtol 1e-4."""
    ds = cmu.CMUDataset(corpus, 10, 10, actions=["basketball"], split=0,
                        mode="xyz")
    dim_used = ds.dimensions_to_use
    cfg = dict(num_classes=len(dim_used), num_blocks=1, hidden_dim=16,
               tokens_mlp_dim=8, channels_mlp_dim=16, seq_len=10, pred_len=10,
               activation="gelu", regularization=0.0,
               input_size=len(dim_used), r_se=4, use_se=True)
    kw = dict(loss_type="mpjpe", dim_used=dim_used, input_n=10, output_n=10,
              input_scale=1.0)
    jtr = JaxTrainer(JaxMlpMixer(**cfg),
                     jax_make_optimizer(lr=1e-3, steps_per_epoch=10), **kw)
    state = jtr.init_state(jax.random.PRNGKey(0))
    model = MlpMixer(**cfg)
    model.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, state.variables()), 1), strict=True)
    tr = Trainer(model, make_optimizer(model.parameters(), lr=1e-3,
                                       steps_per_epoch=10), **kw)
    jframes, frames = jnp.asarray(ds.frames), torch.from_numpy(ds.frames)
    state, want = jtr.train_epoch(state, ds, jframes, batch_size=32, seed=0)
    got = tr.train_epoch(ds, frames, 32, seed=0)
    assert np.isfinite(got) and got > 0
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(tr.validate(ds, frames, 32),
                               jtr.validate(state, ds, jframes, 32),
                               rtol=1e-4)


# ---------------------------------------------------------- normalization

def test_normalization_quartet_matches_the_golden():
    """The SRNN normalization quartet against the executed reference
    (data_utils.py:128-277), exactly where the JAX test is exact."""
    g = _golden("normalization.npz")
    actions = ["walking", "eating", "smoking"]
    mean, std, ignore, use = normalization_stats(g["complete"])
    np.testing.assert_allclose(mean, g["mean"], rtol=1e-6)
    np.testing.assert_allclose(std, g["std"], rtol=1e-6)
    assert ignore == list(g["ignore"]) and use == list(g["use"])

    mean, std = g["mean"], g["std"]
    normed = normalize_data({"a": g["seq_a"], "b": g["seq_b"]}, mean, std,
                            list(g["use"]), actions, one_hot=False)
    np.testing.assert_array_equal(normed["a"], g["normed_a"])
    np.testing.assert_array_equal(normed["b"], g["normed_b"])
    normed_oh = normalize_data({"a": g["seq_oh_a"], "b": g["seq_oh_b"]},
                               mean, std, list(g["use"]), actions,
                               one_hot=True)
    np.testing.assert_array_equal(normed_oh["a"], g["normed_oh_a"])
    np.testing.assert_array_equal(normed_oh["b"], g["normed_oh_b"])
    un = unNormalizeData(g["normed_a"], mean, std, list(g["ignore"]), actions,
                         one_hot=False)
    np.testing.assert_array_equal(un, g["un"])
    np.testing.assert_allclose(
        un[:, g["ignore"]],
        np.broadcast_to(mean[g["ignore"]], un[:, g["ignore"]].shape),
        rtol=1e-6)
    un_oh = unNormalizeData(g["normed_oh_a"], mean, std, list(g["ignore"]),
                            actions, one_hot=True)
    np.testing.assert_array_equal(un_oh, g["un_oh"])
    reverted = revert_output_format(list(g["poses"]), mean, std,
                                    list(g["ignore"]), actions, one_hot=False)
    np.testing.assert_array_equal(np.stack(reverted), g["reverted"])
    assert revert_output_format([], mean, std, list(g["ignore"]), actions,
                                one_hot=False) == []


# ----------------------------------------------------------- AMASS graph

def test_amass_graph_matches_the_golden_and_jax():
    g = _golden("amass_graph.npz")
    A = np.zeros((22, 22))
    for i, j in AMASS_EDGES_22:
        A[i, j] = A[j, i] = 1.0
    assert AMASS_EDGES_22 == jax_graph.AMASS_EDGES_22
    np.testing.assert_allclose(normalize_A(A), g["normalized_A"], atol=1e-12)
    np.testing.assert_allclose(spatio_temporal_graph(22, 4, g["normalized_A"]),
                               g["adj_t4"], atol=1e-6)
    adj = get_adj_AMASS(22, 4)
    assert adj.dtype == np.float32
    np.testing.assert_allclose(adj, g["adj_t4"], atol=1e-6)
    np.testing.assert_array_equal(adj, jax_graph.get_adj_AMASS(22, 4))
    for j in (3, 6, 9, 13, 14):  # joints the edge list leaves out
        assert adj[0, j, j] == 1.0 and np.count_nonzero(adj[0, j]) == 1
    with pytest.raises(ValueError):
        get_adj_AMASS(18, 4)


# -------------------------------------------------------------------- DCT

def test_dct_matches_the_reference_loop_and_jax():
    n = 10
    dct_m, idct_m = get_dct_matrix(n)
    ref = np.eye(n)
    for k in range(n):
        for i in range(n):
            w = np.sqrt(2 / n) if k != 0 else np.sqrt(1 / n)
            ref[k, i] = w * np.cos(np.pi * (i + 1 / 2) * k / n)
    np.testing.assert_allclose(dct_m, ref, atol=1e-12)
    np.testing.assert_allclose(dct_m @ idct_m, np.eye(n), atol=1e-10)
    seq = np.random.RandomState(0).randn(3, n, 6).astype(np.float32)
    coeffs = dct_transform(torch.from_numpy(seq))
    np.testing.assert_allclose(
        coeffs.numpy(), np.asarray(jax_dct.dct_transform(jnp.asarray(seq))),
        atol=1e-5)
    np.testing.assert_allclose(idct_transform(coeffs).numpy(), seq,
                               atol=1e-4)


# ------------------------------------------------------------ augmentations

@pytest.mark.parametrize("name,n,high", [("mask_sequence", 3, 10),
                                         ("mask_joints", 4, 22)])
def test_masks_on_jax_draws_match_jax_exactly(name, n, high):
    """Fed the indices the JAX key draws, each mask gives the JAX
    package's output bit for bit; from a torch.Generator it zeroes 1..n
    whole frames or joint triplets."""
    seq = np.random.RandomState(1).randn(2, 10, 66).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want = np.asarray(getattr(jax_augment, name)(key, jnp.asarray(seq), n))
    idx = np.asarray(jax.random.randint(key, (n,), 0, high))
    got = getattr(augment, name)(torch.from_numpy(seq), n, idx=idx).numpy()
    np.testing.assert_array_equal(got, want)

    out = getattr(augment, name)(torch.ones(2, 10, 66), n,
                                 generator=torch.Generator().manual_seed(0))
    if name == "mask_sequence":
        zero = np.where(np.all(out.numpy() == 0, axis=(0, 2)))[0]
    else:
        zero = np.where(np.all(out.numpy().reshape(2, 10, 22, 3) == 0,
                               axis=(0, 1, 3)))[0]
    assert 1 <= len(zero) <= n
    assert int((out == 0).sum()) == len(zero) * (2 * 66 if name ==
                                                 "mask_sequence" else 2 * 30)


# ------------------------------------------------------------- ConvEncoder

def test_conv_encoder_matches_jax():
    """The port's ConvEncoder (PoseEncoder with no harmonics) against the
    JAX package's, its weights carried across by ``state_dict_from_jax``
    from a JAX ConvMixer whose encoder is that ConvEncoder."""
    B, T, D, E, C = 4, 10, 66, 50, 3
    jmodel = JaxConvMixer(
        num_blocks=1, dimPosIn=D, dimPosEmb=E, dimPosOut=D, in_nTP=T,
        out_nTP=5, conv_nChan=C, conv1_kernel_shape=(3, 3),
        conv1_stride=(1, 1), conv1_padding=None, mode_conv="twice",
        activation="mish", regularization=0.0, use_se=True, r_se=2,
        use_max_pooling=False, encoder_n_harmonic_functions=0,
        encoder_omega0=0.0)
    x = np.random.RandomState(7).randn(B, T, D).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.asarray(x), training=False))
    want = np.asarray(JaxConvEncoder(dimPosIn=D, dimPosEmb=E, conv_nChan=C)
                      .apply({"params": variables["params"]["encoder"]},
                             jnp.asarray(x)))
    sd = state_dict_from_jax(variables, 1)
    enc = ConvEncoder(dimPosIn=D, dimPosEmb=E, conv_nChan=C)
    assert isinstance(enc, PoseEncoder) and enc.n_harmonic_functions == 0
    enc.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()
                         if k.startswith("encoder.")}, strict=True)
    with torch.no_grad():
        got = enc(torch.from_numpy(x)).numpy()
    assert got.shape == (B, T, E, C)
    np.testing.assert_allclose(got, want, atol=2e-5)


# ----------------------------------------------------- the package surface

# Names of the JAX package's subpackage ``__all__`` lists that the port
# leaves out on purpose, each with its reason.
JAX_ONLY = {
    "models.export_conv_mixer": "flax -> torch converter; the port's "
                                "weights are the reference layout already "
                                "(state_dict_from_jax reads flax variables)",
    "models.export_mlp_mixer": "as export_conv_mixer",
    "models.save_torch_state_dict": "as export_conv_mixer",
    "models.convert_conv_mixer": "torch -> flax converter; the port loads "
                                 "a reference state_dict as it is",
    "models.convert_mlp_mixer": "as convert_conv_mixer",
    "models.load_torch_state_dict": "as convert_conv_mixer",
    "train.TrainState": "a flax pytree of params and optimizer state; the "
                        "port keeps the nn.Module and train.Optimizer",
    "train.multistep_schedule": "an optax schedule; the port's "
                                "train.Optimizer steps MultiStepLR itself "
                                "(Optimizer.lr_at)",
    "train.load_checkpoint_meta": "models.torch_io.read_weights returns "
                                  "(state_dict, meta) of either format",
}
# whole subpackages and modules still queued (ROADMAP queue A)
JAX_ONLY_MODULES = {
    "viz": "A16, viz (no matplotlib or Pillow on the card's machine)",
    "_native": "A20, the native CSV reader",
    "profiling": "A18, the H100 measurement harness",
}


def _jax_all(sub: str) -> list:
    """The ``__all__`` of the JAX package's ``sub`` (read, not imported)."""
    path = os.path.join(REPO, "motionmixerconv_tpu", sub, "__init__.py")
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    return []


def _jax_subpackages() -> list:
    root = os.path.join(REPO, "motionmixerconv_tpu")
    return sorted(d for d in os.listdir(root)
                  if os.path.isfile(os.path.join(root, d, "__init__.py")))


@pytest.mark.parametrize("sub", _jax_subpackages())
def test_port_surface_covers_the_jax_subpackage(sub):
    """Every name in a JAX subpackage's ``__all__`` exists in the port's
    counterpart, or is a listed JAX-only name; a whole subpackage is
    JAX-only only where it is still queued."""
    if sub in JAX_ONLY_MODULES:
        assert not os.path.exists(os.path.join(
            REPO, "motionmixerconv_tpu_torch", sub))
        return
    port = importlib.import_module(f"motionmixerconv_tpu_torch.{sub}")
    missing = [n for n in _jax_all(sub)
               if not hasattr(port, n) and f"{sub}.{n}" not in JAX_ONLY]
    assert missing == []
    for name in _jax_all(sub):
        if f"{sub}.{name}" not in JAX_ONLY:
            assert name in getattr(port, "__all__", [name]), name


def test_port_top_level_matches_jax():
    """``from motionmixerconv_tpu_torch import Predictor, geometry,
    metrics`` works as the JAX package's top level does, and every module
    the JAX package has beside its subpackages is ported or queued."""
    import motionmixerconv_tpu_torch as port
    from motionmixerconv_tpu_torch.serving import Predictor

    assert port.Predictor is Predictor
    assert port.geometry.__name__ == "motionmixerconv_tpu_torch.geometry"
    assert port.metrics.__name__ == "motionmixerconv_tpu_torch.metrics"
    root = os.path.join(REPO, "motionmixerconv_tpu")
    for f in os.listdir(root):
        name = f[:-3]
        if f.endswith(".py") and name != "__init__" \
                and name not in JAX_ONLY_MODULES:
            importlib.import_module(f"motionmixerconv_tpu_torch.{name}")

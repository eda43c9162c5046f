"""The port's data-parallel path on the CPU: two gloo ranks
(``parallel.launch``) run every stanza of ``parallel/dryrun.py`` once for
the module, at small widths, and hand their results to the parent:

- the mesh run at world 2 against the port's ``mesh=None`` trainer with
  dropout off: train step, epoch loss and parameters, grouped sums,
  autoregressive epoch with ``clip_grad``, fused epochs, at the JAX dry
  run's tolerances (``__graft_entry__.dryrun_multichip``);
- world 2 against world 1 with dropout 0.1 (the masks do not depend on the
  number of ranks);
- the BatchNorm autoregressive model's losses and running statistics
  against ``mesh=None`` (the global batch's statistics);
- a ragged corpus, where a mean of per-rank means would be wrong, and the
  refusal of a batch the ranks do not divide.

Then ``Predictor(mesh=)`` over two CPU devices, and the port's
``mesh=None`` run against the JAX package's from one init (the JAX dry run
holds JAX's mesh run to that).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionmixerconv_tpu.data.constants import H36M_DIM_USED_XYZ
from motionmixerconv_tpu.models import ConvMixer as JaxConvMixer
from motionmixerconv_tpu.train import Trainer as JaxTrainer
from motionmixerconv_tpu.train import make_optimizer as jax_make_optimizer
from motionmixerconv_tpu_torch.data import WindowedCorpus
from motionmixerconv_tpu_torch.models import ConvMixer, state_dict_from_jax
from motionmixerconv_tpu_torch.parallel import (DataMesh, batch_sharding,
                                                launch, make_mesh)
from motionmixerconv_tpu_torch.parallel import dryrun
from motionmixerconv_tpu_torch.serving import Predictor
from motionmixerconv_tpu_torch.train import Trainer, make_optimizer

# the dry run's models at small widths
CFG = dict(dryrun.FLAGSHIP, num_blocks=2, dimPosEmb=16,
           encoder_n_harmonic_functions=4)
AR_CFG = dict(dryrun.AR_MODEL, dimPosEmb=16, encoder_n_harmonic_functions=2)
BN_CFG = dict(dryrun.BN_MODEL, dimPosEmb=16, conv_nChan=3,
              conv1_kernel_shape=(3, 3))
WORLD = 2
STANZAS = ("step", "epoch", "params", "grouped", "ar", "fused", "clip")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks():
    """Every rank's results of the dry run's stanzas (rank 0 first)."""
    return launch(dryrun.rank_stanzas, WORLD, "gloo", "cpu",
                  args=(CFG, AR_CFG, BN_CFG))


def _close(name, got, want):
    """Hold one stanza's mesh result to its twin's at the dry run's
    tolerance."""
    if name == "params":
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                       atol=dryrun.TOL["params"], err_msg=k)
    elif name == "clip":
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=dryrun.TOL["clip"])
    elif name == "grouped":
        for i in (0, 1):
            np.testing.assert_allclose(got[i], want[i],
                                       rtol=dryrun.TOL["grouped"])
        np.testing.assert_array_equal(got[2], want[2])  # counts exact
    else:
        np.testing.assert_allclose(got, want, rtol=dryrun.TOL[name])


@pytest.mark.parametrize("stanza", STANZAS)
def test_world2_matches_mesh_none_dropout_off(ranks, stanza):
    r0 = ranks[0]["off"]
    _close(stanza, r0["mesh"][stanza], r0["twin"][stanza])


@pytest.mark.parametrize("stanza", STANZAS)
def test_world2_matches_world1_with_dropout(ranks, stanza):
    """Dropout 0.1: every rank draws the global batch's mask and keeps its
    rows, so the run at world 2 is the run at world 1."""
    r0 = ranks[0]["dropout"]
    _close(stanza, r0["mesh"][stanza], r0["twin"][stanza])


@pytest.mark.parametrize("tag", ["off", "dropout"])
def test_ranks_end_identical(ranks, tag):
    """One reduced gradient, clipped after the reduction, steps every rank
    alike from rank 0's parameters: the ranks end bit-identical and
    report the same reduced losses."""
    m0 = ranks[0][tag]["mesh"]
    for r in ranks[1:]:
        m = r[tag]["mesh"]
        for k in ("step", "epoch", "ar", "fused", "clip"):
            np.testing.assert_array_equal(m[k], m0[k], err_msg=k)
        for k, v in m["params"].items():
            assert torch.equal(v, m0["params"][k]), k


def test_batchnorm_takes_the_global_batch(ranks):
    """The BatchNorm autoregressive model (teacher forcing, closed loop,
    validation; its once-per-step harvest forward included) against
    mesh=None: the losses and the running statistics; per-rank statistics
    would leave the ranks' running stats apart."""
    m, t = ranks[0]["bn"]["mesh"], ranks[0]["bn"]["twin"]
    np.testing.assert_allclose(m["bn_ar"], t["bn_ar"],
                               rtol=dryrun.TOL["bn_ar"])
    for key in ("bn_first", "bn_stats"):  # one forward; after training
        assert m[key]
        for k, v in m[key].items():
            want = t[key][k].numpy()
            np.testing.assert_allclose(v.numpy(), want, rtol=0,
                                       atol=dryrun.TOL[key]
                                       * np.abs(want).max())
            # the statistics moved from their init (mean 0, var 1)
            assert not torch.equal(v, torch.full_like(v, float("var" in k)))
            for r in ranks[1:]:
                assert torch.equal(r["bn"]["mesh"][key][k], v), k


def test_ragged_batch_needs_the_global_weight_sum(ranks):
    """The last batch of a 3 * batch - 2 corpus: its two weight-0 rows sit
    on the last rank. The ranks' parts (their weighted sums over the
    global weight sum) add up to the global mean; a mean of per-rank
    means, DDP's reduction, does not."""
    parts = [r["ragged"] for r in ranks]
    glob = parts[0]["global"]
    np.testing.assert_allclose(sum(p["part"] for p in parts), glob,
                               rtol=1e-6)
    ddp = np.mean([p["own_mean"] for p in parts])
    assert abs(ddp - glob) > 100 * dryrun.TOL["epoch"] * abs(glob)


def test_indivisible_batch_raises(ranks):
    for r in ranks:
        msg = r["indivisible"]
        assert msg is not None
        assert f"{4 * WORLD + 1} rows" in msg and f"{WORLD} ranks" in msg


def test_only_rank0_writes(ranks):
    assert [r["off"]["mesh"]["writer"] for r in ranks] == [True, False]


def test_dryrun_check_accepts_the_ranks(ranks):
    diffs = dryrun.check(ranks, say=lambda _: None)
    assert all(np.isfinite(v) for v in diffs.values())


# ------------------------------------------------------------- one process

def test_mesh_rows_and_make_mesh_outside_a_group():
    mesh = make_mesh(["cpu", "cpu", "cpu"])
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 3)
    assert mesh.backend is None
    ranked = DataMesh(None, 1, 2, [torch.device("cpu")])
    x = torch.arange(8)
    assert batch_sharding(ranked, x).tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="7 rows .* 2 ranks"):
        ranked.rows(7)


@pytest.mark.parametrize("rows", [5, 8, 257])
def test_predictor_spreads_a_bulk_batch_over_two_devices(rows):
    """Predictor(mesh=) on two CPU devices: a bulk batch padded to a
    multiple of 2, one chunk a replica, the padding sliced off; the result
    is the plain forward's. Batches within fused_max_batch stay on the
    fused kernel's path."""
    model = ConvMixer(**dict(CFG, regularization=0.0),
                      generator=torch.Generator().manual_seed(3))
    pred = Predictor(model, device="cpu", mesh=make_mesh(["cpu", "cpu"]),
                     fused_max_batch=4)
    assert len(pred._replicas) == 2 and pred.mesh.size == 2
    x = torch.from_numpy(np.random.RandomState(rows).randn(
        rows, 10, 66).astype(np.float32))
    with torch.no_grad():
        want = pred.model(x)
        np.testing.assert_allclose(pred.predict(x).numpy(), want.numpy(),
                                   rtol=0, atol=1e-5)
        np.testing.assert_array_equal(pred.predict(x[:3]).numpy(),
                                      pred._fused(x[:3]).numpy())
    with pytest.raises(ValueError, match="one process"):
        Predictor(model, device="cpu",
                  mesh=DataMesh(object(), 0, 2, [torch.device("cpu")]))


def test_port_mesh_none_matches_jax():
    """The port's mesh=None trainer against the JAX package's from one
    init on the dry run's ragged corpus, dropout off: a train step, an
    epoch and the grouped evaluation at rtol 1e-5 (grouped sums 1e-4, as
    the dry run). ``dryrun_multichip`` holds JAX's mesh run to its
    mesh=None run; the fixture above holds the port's mesh run to its."""
    cfg = dict(CFG, regularization=0.0)
    batch = 4 * WORLD
    rs = np.random.RandomState(dryrun.SEED)
    frames_h = rs.randn(dryrun.FRAMES, 96).astype(np.float32)
    n_windows = 3 * batch - 2
    corpus = WindowedCorpus(frames_h, (np.arange(n_windows) % (
        dryrun.FRAMES - dryrun.SEQ)).astype(np.int64), dryrun.SEQ)
    gids = np.arange(n_windows) % 3
    kw = dict(loss_type="mpjpe", dim_used=H36M_DIM_USED_XYZ, input_n=10,
              output_n=25, input_scale=1e-3)
    jtr = JaxTrainer(JaxConvMixer(**cfg),
                     jax_make_optimizer(lr=1e-3, steps_per_epoch=10), **kw)
    state = jtr.init_state(jax.random.PRNGKey(0))
    model = ConvMixer(**cfg)
    model.load_state_dict(state_dict_from_jax(jax.tree_util.tree_map(
        np.asarray, state.variables()), cfg["num_blocks"],
        cfg["encoder_n_harmonic_functions"], cfg["encoder_omega0"]),
        strict=True)
    tr = Trainer(model, make_optimizer(model.parameters(), lr=1e-3,
                                       steps_per_epoch=10), **kw)
    jframes, frames = jnp.asarray(frames_h), torch.from_numpy(frames_h)
    starts = np.arange(batch) % (dryrun.FRAMES - dryrun.SEQ)
    state, want = jtr._train_step(state, jframes,
                                  jnp.asarray(starts, jnp.int32),
                                  jnp.ones(batch, jnp.float32))
    got = tr.train_step(frames, torch.from_numpy(starts), torch.ones(batch))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    state, want = jtr.train_epoch(state, corpus, jframes, batch, seed=0)
    got = tr.train_epoch(corpus, frames, batch, seed=0)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    want = jtr.evaluate_grouped(state, jframes, corpus.window_starts, gids,
                                3, batch, "h36m_xyz")
    got = tr.evaluate_grouped(frames, corpus.window_starts, gids, 3, batch,
                              "h36m_xyz")
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4)
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))

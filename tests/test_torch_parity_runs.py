"""The port's convergence-parity runs (``motionmixerconv_tpu_torch/
parity_runs.py``) on the CPU: its configurations and batch-order stream
against ``tools/parity_runs.py`` and the golden's, ``batch_starts(order=,
pad_to_full=)`` and ``run_h36m(batch_order_fn=)`` against the JAX
package's, ``compare`` on the recorded runs, and the first 3 epochs of the
flagship lockstep run against the recorded torch reference.

The full schedules run on the card (``chip_smoke.py`` phase 24); here the
lockstep run is cut to its first 3 epochs (306 steps at the flagship
widths), the rest at small widths.
"""

import json
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
from motionmixerconv_tpu.data import windows as jax_windows
from motionmixerconv_tpu_torch import parity_runs as pr
from motionmixerconv_tpu_torch.cli import train_mixer_h36m as cli
from motionmixerconv_tpu_torch.cli._runner import run_h36m
from motionmixerconv_tpu_torch.data import H36MDataset, WindowedCorpus
from motionmixerconv_tpu_torch.data import windows
from motionmixerconv_tpu_torch.models import state_dict_from_jax
from motionmixerconv_tpu_torch.train import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def recorded():
    return pr.load_recorded(GOLDEN)


@pytest.fixture(scope="module")
def corpora(recorded, tmp_path_factory):
    """The recorded runs' synthetic corpora, written by the port."""
    return pr.make_corpora(str(tmp_path_factory.mktemp("parity")), recorded)


@pytest.fixture(scope="module")
def tool():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import parity_runs
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    return parity_runs


# ------------------------------------------------------- configurations

@pytest.mark.parametrize("name", ["H36M_CFG", "AMASS_CFG", "AR_CFG",
                                  "AR_SMALL_CFG", "H36M_SYNC_CFG",
                                  "H36M_SYNC_LOWLR_CFG"])
def test_configs_match_the_tool(tool, name):
    assert getattr(pr, name) == getattr(tool, name)


def test_configs_match_the_golden(recorded):
    """The golden's recorded corpora and schedules are the configurations'
    (JSON turns the kernel tuple into a list)."""
    for key, cfg in (("h36m_cfg", pr.H36M_CFG), ("amass_cfg", pr.AMASS_CFG)):
        assert recorded[key] == json.loads(json.dumps(cfg)), key


def test_sync_order_matches_the_tool(tool):
    for n, epoch in ((5100, 0), (5100, 19), (17, 3)):
        np.testing.assert_array_equal(pr._sync_order(n, epoch),
                                      tool._sync_order(n, epoch))


def test_init_loads_strictly_into_the_runs_models(corpora):
    """Every recorded init is a reference state_dict the run's model
    loads strictly (``run_h36m`` and its siblings load it so)."""
    from motionmixerconv_tpu_torch.cli import (train_autoreg_mixer_h36m,
                                               train_mixer_amass)
    from motionmixerconv_tpu_torch.cli._runner import (build_conv_mixer,
                                                       build_mlp_mixer)

    h36m = cli.parse_args(pr._h36m_argv(pr.H36M_CFG, "d", "s", "cpu", False,
                                        None))
    amass = train_mixer_amass.parse_args([])
    for kind in pr.INIT_KINDS:
        if kind == "amass":
            model = build_mlp_mixer(amass, 54, 10, 25)
        elif kind.startswith("ar"):
            c = pr.AR_CFG if kind == "ar" else pr.AR_SMALL_CFG
            a = train_autoreg_mixer_h36m.parse_args(
                ["--hidden_dim", str(c["hidden_dim"]), "--num_blocks",
                 str(c["num_blocks"]), "--conv_nChan", str(c["conv_nChan"])])
            a.conv1_kernel_shape = (a.kernel1_x, a.kernel1_y)
            model = build_conv_mixer(a, 66, 66, 10, 5)
        else:
            model = build_conv_mixer(h36m, 66, 66, 10, 25)
        model.load_state_dict(pr.load_init(GOLDEN, kind), strict=True)
    with pytest.raises(ValueError, match="unknown init"):
        pr.load_init(GOLDEN, "h36m_sync_highlr")


# --------------------------------------------------------- batch order

def _corpus(n, first_start=0):
    return WindowedCorpus(frames=np.zeros((n + 40, 3), np.float32),
                          window_starts=np.arange(n) * 2 + first_start,
                          seq_len=5)


@pytest.mark.parametrize("pad_to_full", [True, False])
@pytest.mark.parametrize("source", ["order", "shuffle", "identity"])
def test_batch_starts_with_order_matches_jax(source, pad_to_full):
    """``batch_starts(order=, pad_to_full=)`` yields the JAX package's
    batches: an explicit order replaces the shuffle, ``pad_to_full=False``
    leaves the last batch ragged (a corpus whose first window starts at
    frame 0, where the two packages' padding agrees)."""
    corpus = _corpus(23)
    order = np.random.RandomState(4).permutation(23) \
        if source == "order" else None
    kw = dict(shuffle=source != "identity", seed=7, pad_to_full=pad_to_full,
              order=order)
    got = list(windows.batch_starts(corpus, 10, **kw))
    want = list(jax_windows.batch_starts(corpus, 10, **kw))
    assert len(got) == len(want) == 3
    for (s, w), (js, jw) in zip(got, want):
        np.testing.assert_array_equal(s, js)
        np.testing.assert_array_equal(w, jw)
    assert len(got[-1][0]) == (10 if pad_to_full else 3)


def test_batch_starts_order_of_the_wrong_length_raises_as_jax():
    corpus = _corpus(23)
    with pytest.raises(ValueError) as got:
        next(windows.batch_starts(corpus, 10, shuffle=True,
                                  order=np.arange(22)))
    with pytest.raises(ValueError) as want:
        next(jax_windows.batch_starts(corpus, 10, shuffle=True,
                                      order=np.arange(22)))
    assert str(got.value) == str(want.value) == \
        "order has 22 entries for 23 windows"


def test_epoch_batches_carry_the_order_to_the_device_buffers():
    """``Trainer._epoch_batches`` puts an explicit order into the starts it
    copies to the device (what a captured step reads), padded with the
    first window as ``batch_starts`` pads."""
    corpus = _corpus(23, first_start=6)
    trainer = Trainer(torch.nn.Linear(2, 2), None, loss_type="mpjpe",
                      dim_used=np.arange(3), input_n=2, output_n=3)
    order = np.random.RandomState(5).permutation(23)
    starts, w = trainer._epoch_batches(corpus, 10, [0, 1], [order, None])
    want = np.concatenate([corpus.window_starts[order], [6] * 7])
    np.testing.assert_array_equal(starts[0].flatten().numpy(), want)
    shuffled = np.concatenate([s for s, _ in windows.batch_starts(
        corpus, 10, shuffle=True, seed=1)])
    np.testing.assert_array_equal(starts[1].flatten().numpy(), shuffled)
    assert float(w[0].sum()) == 23.0


# ---------------------------------------------------------- the runner

def _argv(data_dir, save):
    return ["--data_dir", data_dir, "--save_path", save, "--loss_type",
            "mpjpe", "--skip_rate", "5", "--num_blocks", "1", "--hidden_dim",
            "16", "--actions_to_consider", "walking", "--batch_size", "256",
            "--n_epochs", "2", "--regularization", "0.0",
            "--epochs_per_dispatch", "2"]


def test_run_h36m_batch_order_fn_matches_jax(corpora, tmp_path, capsys):
    """JAX ``run_h36m(batch_order_fn=)`` and the port's, from one init,
    dropout off, the lockstep order stream: per-epoch train and val
    losses, MPJPE and AUC-PCK agree at rtol 1e-3. Both take the per-epoch
    path in spite of ``--epochs_per_dispatch 2`` and say so."""
    h36m_dir, _ = corpora
    jargs = jax_cli.parse_args(_argv(h36m_dir, str(tmp_path / "jax")))
    args = cli.parse_args(_argv(h36m_dir, str(tmp_path / "port"))
                          + ["--dev", "cpu"])
    for a in (jargs, args):
        a.encoder_n_harmonic_functions = 8
    n = len(H36MDataset(h36m_dir, 10, 25, 5, split=0))
    calls = []

    def order(ep):
        calls.append(ep)
        return pr._sync_order(n, ep)

    jmodel = jax_build(jargs, 66, 66, 10, 25)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(3), jnp.zeros((2, 10, 66)), training=False))
    want, _, _ = jax_run_h36m(jargs, model=jmodel, init_variables=jax
                              .tree_util.tree_map(jnp.asarray, variables),
                              batch_order_fn=lambda ep: pr._sync_order(n, ep))
    got, _ = run_h36m(args, init_state_dict=state_dict_from_jax(
        variables, 1, 8, 0.1), batch_order_fn=order)
    assert calls == [0, 1]
    for key in ("train", "val", "test"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3,
                                   err_msg=key)
    for key in ("mpjpe", "auc_pck"):
        np.testing.assert_allclose(got["metrics"][key], want["metrics"][key],
                                   rtol=1e-3, err_msg=key)
    said = capsys.readouterr().out
    assert said.count("an explicit batch-order stream (parity run) requires "
                      "the per-epoch path") == 2


# ------------------------------------------------------------- compare

RECORDED_PAIRS = {"h36m": "jax_h36m", "h36m_sync": "jax_h36m_sync",
                  "amass": "jax_amass", "ar": "jax_ar",
                  "ar_small": "jax_ar_small"}


def test_compare_passes_the_recorded_jax_runs(recorded):
    """The JAX runs the golden records pass ``compare`` against the torch
    runs (the tolerances of tests/test_parity_runs.py, which they met)."""
    results = {k: recorded["results"][v] for k, v in RECORDED_PAIRS.items()}
    verdict = pr.compare(results, recorded)
    assert verdict["failures"] == []
    assert set(verdict["rows"]) == set(RECORDED_PAIRS)


@pytest.mark.parametrize("key,scale", [("train", 1.03), ("test_mpjpe", 1.07),
                                       ("train_per_epoch", 1.03)])
def test_compare_fails_a_run_outside_its_tolerance(recorded, key, scale):
    """The recorded JAX lockstep run with one entry set to the torch
    run's times ``scale``, just outside its tolerance, fails that check
    alone."""
    run = dict(recorded["results"]["jax_h36m_sync"])
    v = recorded["results"]["torch_h36m_sync"][key]
    run[key] = [x * scale for x in v] if isinstance(v, list) else v * scale
    failures = pr.compare({"h36m_sync": run}, recorded)["failures"]
    assert len(failures) == 1 and failures[0].startswith(f"h36m_sync: {key}")


def test_param_drift_of_the_reference_endpoint_is_zero(tmp_path):
    """``param_drift`` reads a run's ``train_state.pt`` (weights and the
    flags that rebuild its model) and measures the parameters against
    ``parity_drift.npz``, as the JAX test measures its flax params: no
    buffer, and ``se2`` (the same module as ``se``) once."""
    args = cli.parse_args(pr._h36m_argv(pr.H36M_SYNC_CFG, "d", "s", "cpu",
                                        False, None))
    ref = pr._npz_state_dict(os.path.join(GOLDEN, "parity_drift.npz"),
                             "h36m_sync_drift")
    path = str(tmp_path / "train_state.pt")
    torch.save({"model": dict(ref, **{
        "encoder.frequencies": ref["encoder.frequencies"] * 2}),
        "meta": vars(args)}, path)
    assert pr.param_drift(path, GOLDEN, "h36m_sync_drift") == 0.0
    init = pr.load_init(GOLDEN, "h36m_sync_drift")
    torch.save({"model": init, "meta": vars(args)}, path)
    names = [k for k in init
             if k != "encoder.frequencies" and ".se2." not in k]
    a = torch.cat([init[k].double().flatten() for k in names])
    b = torch.cat([ref[k].double().flatten() for k in names])
    assert pr.param_drift(path, GOLDEN, "h36m_sync_drift") == pytest.approx(
        float(torch.linalg.norm(a - b) / torch.linalg.norm(b)), rel=1e-12)


# ------------------------------------------------- the lockstep prefix

def test_flagship_lockstep_prefix_matches_the_recorded_reference(
        recorded, corpora, tmp_path):
    """The port's lockstep run (flagship widths, dropout off, the recorded
    batch order, the recorded init) for its first 3 epochs, 306 steps:
    the per-epoch train loss and test MPJPE agree with the recorded torch
    reference at rtol 2e-4 (the recorded JAX run was within 5e-5)."""
    h36m_dir, amass_dir = corpora
    ours = pr.run("h36m_sync", GOLDEN, h36m_dir, amass_dir, str(tmp_path),
                  dev="cpu", n_epochs=3)
    ref = recorded["results"]["torch_h36m_sync"]
    for key in ("train_per_epoch", "test_per_epoch"):
        np.testing.assert_allclose(ours[key], ref[key][:3], rtol=2e-4,
                                   err_msg=key)
    assert os.path.isfile(ours["checkpoint"])

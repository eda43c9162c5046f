"""Whole epochs per dispatch in the port on the CPU, against the JAX
package: the epoch chunking, ``Trainer.run_epochs_fused`` for the direct,
the autoregressive and the AMASS trainer, the CLIs' ``--epochs_per_dispatch``
chunks (checkpoints and resume), the per-step host work the captured step
must not hold (the B1 weight reorder, the lr schedule), the optimizer's
state across its CPU and CUDA modes, ``--embed_dtype bf16`` and the H36M
evaluation CLI.

On the CPU every step and evaluation batch runs eagerly (the captured CUDA
graph of ``train/graphs.py`` is the card's); ``chip_smoke.py`` holds the
graph path to the eager one on the card, and ``test_torch_card.py`` the
optimizer's state across the CPU and the card.
"""

import copy
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionmixerconv_tpu.cli import test_mixer_h36m as jax_test_cli
from motionmixerconv_tpu.cli import train_mixer_h36m as jax_cli
from motionmixerconv_tpu.cli._runner import _chunk_epochs as jax_chunk_epochs
from motionmixerconv_tpu.cli._runner import build_conv_mixer as jax_build
from motionmixerconv_tpu.cli._runner import make_amass_test_fn
from motionmixerconv_tpu.cli._runner import run_h36m as jax_run_h36m
from motionmixerconv_tpu.data import fixtures as jfix
from motionmixerconv_tpu.data.windows import WindowedCorpus as JaxCorpus
from motionmixerconv_tpu.models import ConvMixer as JaxConvMixer
from motionmixerconv_tpu.models import MlpMixer as JaxMlpMixer
from motionmixerconv_tpu.models.torch_io import export_mlp_mixer
from motionmixerconv_tpu.train import Trainer as JaxTrainer
from motionmixerconv_tpu.train import make_optimizer as jax_make_optimizer
from motionmixerconv_tpu.train.autoreg_trainer import \
    AutoregressiveTrainer as JaxARTrainer
from motionmixerconv_tpu_torch.cli import _runner
from motionmixerconv_tpu_torch.cli import test_mixer_h36m as test_cli
from motionmixerconv_tpu_torch.cli import train_mixer_h36m as cli
from motionmixerconv_tpu_torch.data import WindowedCorpus
from motionmixerconv_tpu_torch.data.constants import (AMASS_DIM_USED,
                                                      H36M_DIM_USED_XYZ)
from motionmixerconv_tpu_torch.models import (ConvMixer, MlpMixer,
                                              PoseEncoder, state_dict_from_jax)
from motionmixerconv_tpu_torch.ops import harmonic
from motionmixerconv_tpu_torch.train import (AutoregressiveTrainer, Trainer,
                                             make_optimizer)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """These tests compute small tensors, which one intra-op thread does as
    fast as eight; the suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ (a) chunking

@pytest.mark.parametrize("start,stop,epd,tf", [
    (0, 12, 4, None),   # exact division
    (0, 10, 4, None),   # a divisor in [ceil(epd/2), epd] preferred
    (0, 7, 4, None),    # prime length: balanced 4 + 3
    (0, 10, 4, 3),      # the teacher-forcing boundary never straddled
    (0, 3, 2, None),    # 3 epochs by 2: chunks of one
    (2, 17, 5, 8),
    (3, 23, 8, 11),
    (0, 13, 6, 1),
    (5, 6, 3, None),
    (0, 50, 10, 50),
])
def test_chunk_epochs_equals_jax(start, stop, epd, tf):
    """The port's ``_chunk_epochs`` splits [start, stop) exactly as the JAX
    package's."""
    got = [list(c) for c in _runner._chunk_epochs(start, stop, epd, tf)]
    assert got == [list(c) for c in jax_chunk_epochs(start, stop, epd, tf)]


def test_chunk_epochs_equals_jax_over_a_grid():
    """Over every stop < 23, epd < 9 and boundary (the JAX package's
    coverage grid), and from a resumed start."""
    for start in (0, 4):
        for stop in range(start + 1, 23):
            for epd in range(1, 9):
                for tf in (None, 1, stop // 2, stop):
                    got = [list(c) for c in
                           _runner._chunk_epochs(start, stop, epd, tf)]
                    want = [list(c) for c in
                            jax_chunk_epochs(start, stop, epd, tf)]
                    assert got == want, (start, stop, epd, tf)


# ----------------------------------------- (b) run_epochs_fused against JAX

CONV = dict(
    num_blocks=2, dimPosIn=66, dimPosEmb=16, dimPosOut=66, in_nTP=10,
    out_nTP=25, conv_nChan=1, conv1_kernel_shape=(1, 3), conv1_stride=(1, 1),
    conv1_padding=(0, 1), mode_conv="twice", activation="mish",
    regularization=0.0, use_se=True, r_se=8, use_max_pooling=False,
    encoder_n_harmonic_functions=4, encoder_omega0=0.1)
AR = dict(CONV, num_blocks=1, dimPosEmb=24, out_nTP=5, conv_nChan=3,
          conv1_kernel_shape=(3, 3), conv1_padding=None, regularization=-1.0,
          r_se=2, encoder_n_harmonic_functions=0)
MLP = dict(num_classes=54, num_blocks=2, hidden_dim=16, tokens_mlp_dim=8,
           channels_mlp_dim=16, seq_len=10, pred_len=25, activation="gelu",
           regularization=0.0, input_size=54, r_se=4, use_max_pooling=False,
           use_se=True)
BATCH, BATCH_TEST, STEPS_PER_EPOCH = 48, 40, 4


def _family(kind):
    """(JAX trainer, port trainer from the same exported init, frames as
    numpy, test kind, n_groups, chunks of (epochs, teacher_forcing))."""
    opt = dict(lr=1e-3, milestones=[1], steps_per_epoch=STEPS_PER_EPOCH)
    common = dict(loss_type="mpjpe", input_n=10, output_n=25)
    rs = np.random.RandomState({"direct": 0, "ar": 1, "amass": 2}[kind])
    if kind == "direct":
        jtr = JaxTrainer(JaxConvMixer(**CONV), jax_make_optimizer(**opt),
                         dim_used=H36M_DIM_USED_XYZ, input_scale=1e-3, **common)
        model = ConvMixer(**CONV, encoder_fused=True)
        make = lambda m, o: Trainer(m, o, dim_used=H36M_DIM_USED_XYZ,
                                    input_scale=1e-3, **common)
        frames = rs.randn(900, 96).astype(np.float32) * 300.0
        test = ("h36m_xyz", 3, [([0, 1], None), ([2], None)])
        nh = CONV["encoder_n_harmonic_functions"]
    elif kind == "ar":
        geo = dict(input_n_model=10, output_n_model=5, step_window=5)
        jtr = JaxARTrainer(JaxConvMixer(**AR), jax_make_optimizer(**opt),
                           dim_used=H36M_DIM_USED_XYZ, **geo, **common)
        model = ConvMixer(**AR)
        make = lambda m, o: AutoregressiveTrainer(
            m, o, dim_used=H36M_DIM_USED_XYZ, **geo, **common)
        frames = rs.randn(900, 96).astype(np.float32) * 300.0
        test = ("ar", 1, [([0], True), ([1, 2], False)])
        nh = 0
    else:
        jtr = JaxTrainer(JaxMlpMixer(**MLP), jax_make_optimizer(**opt),
                         dim_used=AMASS_DIM_USED, loss_scale=1000.0, **common)
        model = MlpMixer(**MLP)
        make = lambda m, o: Trainer(m, o, dim_used=AMASS_DIM_USED,
                                    loss_scale=1000.0, **common)
        frames = rs.randn(900, 66).astype(np.float32) * 0.3
        test = ("amass22", 1, [([0, 1], None), ([2], None)])
        make_amass_test_fn(jtr)  # registers the JAX trainer's amass22 kind
        nh = 0
    state = jtr.init_state(jax.random.PRNGKey(3))
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    model.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables), model.num_blocks, nh,
        0.1), strict=True)
    trainer = make(model, make_optimizer(model.parameters(), **opt))
    return jtr, state, trainer, frames, test


def _port_direct():
    """A port direct trainer (fused encoder, dropout off) from a seed."""
    model = ConvMixer(**CONV, encoder_fused=True,
                      generator=torch.Generator().manual_seed(4))
    return Trainer(model, make_optimizer(model.parameters(), lr=1e-3),
                   loss_type="mpjpe", dim_used=H36M_DIM_USED_XYZ, input_n=10,
                   output_n=25, input_scale=1e-3)


@pytest.mark.parametrize("kind", ["direct", "ar", "amass"])
def test_run_epochs_fused_matches_jax(kind):
    """The port's ``run_epochs_fused`` and the JAX package's from one
    exported init (dropout off), 3 epochs in chunks of 2 and 1 (the
    autoregressive trainer across its teacher-forcing boundary, a lr
    milestone after the first epoch): per-epoch train and val losses and
    the per-group test sums agree at rtol 1e-3, the tolerance of
    ``test_runner_matches_jax_run_h36m``."""
    jtr, state, trainer, frames, (test_kind, n_groups, chunks) = \
        _family(kind)
    rs = np.random.RandomState(7)
    seq_len = 35
    starts = [rs.randint(0, len(frames) - seq_len, n).astype(np.int64)
              for n in (4 * BATCH - 5, 70, 90)]
    gids = np.arange(90) % n_groups
    jframes, tframes = jnp.asarray(frames), torch.from_numpy(frames)
    got, want = [], []
    for epochs, tf in chunks:
        args = (BATCH, epochs)
        evals = (starts[2], gids, n_groups, test_kind, BATCH_TEST)
        got.append(trainer.run_epochs_fused(
            WindowedCorpus(frames, starts[0], seq_len), tframes, *args,
            WindowedCorpus(frames, starts[1], seq_len), tframes, tframes,
            *evals, teacher_forcing=tf))
        state, out = jtr.run_epochs_fused(
            state, JaxCorpus(frames, starts[0], seq_len), jframes, *args,
            JaxCorpus(frames, starts[1], seq_len), jframes, jframes, *evals,
            teacher_forcing=tf)
        want.append(out)
    for key in ("train", "val", "m1", "m2", "n"):
        np.testing.assert_allclose(
            np.concatenate([o[key] for o in got]),
            np.concatenate([o[key] for o in want]), rtol=1e-3, err_msg=key)
    assert np.concatenate([o["train"] for o in got]).shape == (3,)


def test_run_epochs_fused_equals_the_per_epoch_calls():
    """One chunk of two epochs equals ``train_epoch``, ``validate`` and
    ``evaluate_grouped`` called epoch by epoch from the same init (the
    same steps in the same order on the CPU: bit for bit)."""
    frames = np.random.RandomState(9).randn(900, 96).astype(np.float32) * 300
    runs = []
    for fused in (True, False):
        trainer = _port_direct()
        rs = np.random.RandomState(8)
        corpus = WindowedCorpus(frames, rs.randint(0, 860, 100), 35)
        vald = WindowedCorpus(frames, rs.randint(0, 860, 30), 35)
        test = rs.randint(0, 860, 40), np.arange(40) % 2
        f = torch.from_numpy(frames)
        if fused:
            out = trainer.run_epochs_fused(corpus, f, 32, [0, 1], vald, f, f,
                                           *test, 2, "h36m_xyz", 16)
        else:
            out = {k: [] for k in ("train", "val", "m1", "m2", "n")}
            for e in (0, 1):
                out["train"].append(trainer.train_epoch(corpus, f, 32, e))
                out["val"].append(trainer.validate(vald, f, 32))
                for k, v in zip(("m1", "m2", "n"), trainer.evaluate_grouped(
                        f, *test, 2, 16, "h36m_xyz")):
                    out[k].append(v)
        runs.append({k: np.asarray(v) for k, v in out.items()})
    for k in runs[0]:
        np.testing.assert_array_equal(runs[0][k], runs[1][k], err_msg=k)


# -------------------------------------------------- (c) the CLI's chunks

@pytest.fixture(scope="module")
def h36m_dir(tmp_path_factory):
    td = tmp_path_factory.mktemp("h36m_torch_fused")
    jfix.make_h36m_corpus(str(td), n_frames=340, seed=3)
    return str(td)


def _argv(data_dir, save, *extra):
    return ["--data_dir", data_dir, "--save_path", save, "--dev", "cpu",
            "--loss_type", "mpjpe", "--skip_rate", "5", "--num_blocks", "2",
            "--hidden_dim", "16", "--actions_to_consider", "walking",
            "--batch_size", "128", "--fused_encoder", *extra]


def test_cli_chunks_equal_the_default_and_resume(h36m_dir, tmp_path,
                                                 monkeypatch):
    """``--epochs_per_dispatch 2`` over 4 epochs equals the default per
    epoch at rtol 1e-5 (the JAX ``test_cli_fused_matches_default``
    tolerance; on the CPU the same steps run), writes its checkpoint at
    each chunk's last epoch only, and ``--resume`` from the first chunk's
    checkpoint continues the run (dropout on: the RNG state resumes too)."""
    saved = []
    save_checkpoint = _runner.save_checkpoint

    def spy(path, model, opt, epoch, **kw):
        saved.append((os.path.basename(path), epoch))
        save_checkpoint(path, model, opt, epoch, **kw)

    monkeypatch.setattr(_runner, "save_checkpoint", spy)
    default = cli.main(_argv(h36m_dir, str(tmp_path / "a"), "--n_epochs", "4"))
    saved.clear()
    chunked = cli.main(_argv(h36m_dir, str(tmp_path / "b"), "--n_epochs", "4",
                             "--epochs_per_dispatch", "2"))
    assert saved == [("train_state.pt", 1), ("train_state.pt", 3)]
    for key in ("train", "val", "test"):
        np.testing.assert_allclose(chunked[key], default[key], rtol=1e-5,
                                   err_msg=key)
    for key in default["metrics"]:
        np.testing.assert_allclose(chunked["metrics"][key],
                                   default["metrics"][key], rtol=1e-5)

    first = str(tmp_path / "c")
    cli.main(_argv(h36m_dir, first, "--n_epochs", "2",
                   "--epochs_per_dispatch", "2"))
    state = os.path.join(first, "h36_3d_25frames_ckpt", "train_state.pt")
    assert torch.load(state, weights_only=True)["epoch"] == 1
    resumed = cli.main(_argv(h36m_dir, first, "--n_epochs", "4",
                             "--epochs_per_dispatch", "2", "--resume", state))
    np.testing.assert_allclose(resumed["train"], chunked["train"][2:],
                               rtol=1e-5)
    np.testing.assert_allclose(resumed["test"], chunked["test"][2:],
                               rtol=1e-5)


# ------------------------------------- (d) no host state in the step body

def test_training_forward_reorders_the_kernel_weight_every_call(monkeypatch):
    """In training mode the fused encoder reorders its B1 weight on every
    call, with no parameter change in between (a captured step must hold
    the reorder; a cache keyed on the parameter's version would hide it),
    and a training step does so once; in eval mode the weight is cached."""
    calls = []
    reorder = harmonic.reorder_weight

    def counting(*a):
        calls.append(1)
        return reorder(*a)

    monkeypatch.setattr(harmonic, "reorder_weight", counting)
    enc = PoseEncoder(6, 8, n_harmonic_functions=3, fused=True)
    x = torch.randn(4, 10, 6)
    with torch.no_grad():
        enc(x), enc(x)
    assert len(calls) == 2
    enc.eval()
    with torch.no_grad():
        enc(x), enc(x)
    assert len(calls) == 3

    trainer = _port_direct()
    f = torch.randn(500, 96) * 300
    starts, w = torch.arange(0, 400, 50), torch.ones(8)
    calls.clear()
    trainer.train_step(f, starts, w)
    trainer.train_step(f, starts, w)
    assert len(calls) == 2


# --------------------------------------------------------- (e) the optimizer

@pytest.mark.parametrize("milestones,gamma", [
    ((15, 25, 35, 40), 0.1),
    ((1, 1, 3), 0.5),     # a repeated milestone: gamma ** 2 at once
    ((0, 2), 0.1),        # a milestone at step 0
])
def test_schedule_equals_multistep_lr(milestones, gamma):
    """The port's schedule (host arithmetic that sets the device lr on the
    card only at a milestone) gives torch's ``MultiStepLR`` lr at every
    step, stepped per batch at milestone * steps_per_epoch."""
    p = torch.nn.Parameter(torch.zeros(3))
    opt = make_optimizer([p], lr=1e-3, milestones=milestones, gamma=gamma,
                         steps_per_epoch=3)
    q = torch.nn.Parameter(torch.zeros(3))
    ref_opt = torch.optim.Adam([q], lr=1e-3)
    ref = torch.optim.lr_scheduler.MultiStepLR(
        ref_opt, [m * 3 for m in milestones], gamma)
    for _ in range(140):
        assert opt.lr == ref_opt.param_groups[0]["lr"]
        assert opt.adam.param_groups[0]["lr"] == opt.lr
        p.grad = q.grad = torch.ones(3)
        opt.step()
        ref_opt.step()
        ref.step()


def _trajectory(opt, p, n):
    """``n`` steps of ``opt`` on gradients that depend on ``p``; the
    parameter after each."""
    out = []
    for i in range(n):
        p.grad = torch.sin(p.detach() * 3 + i)
        opt.step()
        out.append(p.detach().clone())
    return out


def test_optimizer_state_round_trips():
    """A state written after 5 steps and loaded into a fresh optimizer
    continues the uninterrupted trajectory bit for bit across a milestone;
    so does the same state as the card writes it (capturable groups, the
    step counts float32), and one whose schedule is the ``MultiStepLR``
    state_dict earlier checkpoints hold."""
    kw = dict(lr=1e-2, milestones=[2], gamma=0.5, steps_per_epoch=4,
              clip_grad=0.5)
    p = torch.nn.Parameter(torch.linspace(-1, 1, 7))
    opt = make_optimizer([p], **kw)
    _trajectory(opt, p, 5)
    sd = copy.deepcopy(opt.state_dict())  # as written to a file
    p0 = p.detach().clone()
    want = _trajectory(opt, p, 6)

    card_sd = {"adam": {"state": {k: dict(v, step=v["step"].float())
                                  for k, v in sd["adam"]["state"].items()},
                        "param_groups": [dict(g, capturable=True) for g in
                                         sd["adam"]["param_groups"]]},
               "scheduler": sd["scheduler"]}
    old = torch.optim.lr_scheduler.MultiStepLR(
        torch.optim.Adam([torch.nn.Parameter(torch.zeros(1))], lr=1e-2),
        [8], 0.5)
    for _ in range(5):
        old.optimizer.step()
        old.step()
    old_sd = dict(sd, scheduler=old.state_dict())
    for state in (sd, card_sd, old_sd):
        q = torch.nn.Parameter(p0.clone())
        fresh = make_optimizer([q], **kw)
        fresh.load_state_dict(copy.deepcopy(state))  # as read from a file
        assert (fresh.steps, fresh.lr) == (5, 1e-2)
        assert fresh.adam.param_groups[0]["capturable"] is False
        got = _trajectory(fresh, q, 6)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# ----------------------------------------- (f) the non-finite chunk guard

def test_nan_chunk_logs_its_finite_prefix_then_raises():
    """With the autoregressive guard, a chunk whose train losses go
    non-finite logs its finite epochs, raises FloatingPointError naming the
    first bad epoch, and writes no checkpoint for that chunk."""
    logged, saved = [], []

    class FakeTrainer:
        def run_epochs_fused(self, dataset, frames, bs, epochs, *a, **k):
            n = len(epochs)
            return {"train": np.array([1.0 if e < 3 else np.nan
                                       for e in epochs]),
                    "val": np.zeros(n), "m1": np.ones((n, 1)),
                    "m2": np.ones((n, 1)), "n": np.ones((n, 1))}

    class Logger:
        def add_scalar(self, tag, value, epoch):
            if tag == "loss/train":
                logged.append(epoch)

    history = {"train": [], "val": [], "test": [], "train_s": [],
               "epoch_s": [], "metrics": {n: [] for n in _runner.METRIC_NAMES}}
    with pytest.raises(FloatingPointError, match="epoch 3"):
        _runner._train_and_evaluate_fused(
            SimpleNamespace(n_epochs=4, batch_size=8), FakeTrainer(),
            Logger(), history, saved.append, 2, dataset=[0] * 16,
            frames=None, vald=None, vframes=None, test_frames=None,
            test_starts=None, test_gids=None, action_names=["a"],
            test_kind="ar", batch_size_test=8, start_epoch=0,
            teacher_forcing_epochs=0)
    assert logged == [0, 1, 2] and saved == [1]
    assert history["train"] == [1.0, 1.0, 1.0]


# ------------------------------------------------- (g) --embed_dtype bf16

def test_embed_dtype_bf16_matches_jax(h36m_dir, tmp_path):
    """One epoch of the port's CLI with ``--embed_dtype bf16`` (the
    embedding stored in bfloat16, the projection in float32) agrees with
    the JAX CLI's from one init at rtol 1e-3; with ``--fused_encoder`` it
    raises the JAX package's ValueError."""
    common = ["--data_dir", h36m_dir, "--loss_type", "mpjpe", "--skip_rate",
              "5", "--num_blocks", "2", "--hidden_dim", "16",
              "--actions_to_consider", "walking", "--batch_size", "128",
              "--n_epochs", "1", "--regularization", "0", "--embed_dtype",
              "bf16"]
    jargs = jax_cli.parse_args([*common, "--save_path", str(tmp_path / "j")])
    args = cli.parse_args([*common, "--save_path", str(tmp_path / "p"),
                           "--dev", "cpu"])
    for a in (jargs, args):
        a.encoder_n_harmonic_functions = 8
    jmodel = jax_build(jargs, 66, 66, 10, 25)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 10, 66)), training=False))
    want, _, _ = jax_run_h36m(jargs, model=jmodel, init_variables=jax.tree_util
                              .tree_map(jnp.asarray, variables))
    got, trainer = _runner.run_h36m(args, init_state_dict=state_dict_from_jax(
        variables, 2, 8, 0.1))
    assert trainer.model.encoder.embed_dtype == torch.bfloat16
    for key in ("train", "val"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, err_msg=key)
    for key in ("mpjpe", "auc_pck"):
        np.testing.assert_allclose(got["metrics"][key], want["metrics"][key],
                                   rtol=1e-3, err_msg=key)
    with pytest.raises(ValueError, match="embed_dtype only applies"):
        cli.main(["--data_dir", h36m_dir, "--save_path", str(tmp_path / "f"),
                  "--loss_type", "mpjpe", "--dev", "cpu", "--embed_dtype",
                  "bf16", "--fused_encoder"])
    with pytest.raises(ValueError, match="embed_dtype only applies"):
        jax_build(jax_cli.parse_args(["--loss_type", "mpjpe", "--embed_dtype",
                                      "bf16", "--fused_encoder"]),
                  66, 66, 10, 25).init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 10, 66)), training=False)


# ---------------------------------------------- (h) the H36M evaluation CLI

MLP_FLAGS = ["--hidden_dim", "16", "--num_blocks", "2", "--tokens_mlp_dim",
             "8", "--channels_mlp_dim", "16", "--r_se", "4"]


@pytest.mark.parametrize("output_n", [25, 10])
def test_test_cli_matches_jax(h36m_dir, tmp_path, output_n):
    """``cli.test_mixer_h36m`` on a reference-layout MlpMixer ``.pt`` that
    the JAX package's ``export_mlp_mixer`` wrote returns the JAX CLI's two
    numbers (overall 32-joint MPJPE, final horizon) at rtol 1e-5, over all
    15 actions (the horizon sums run on across actions, as in the JAX CLI)
    and with an output_n that keeps only the horizons it predicts."""
    jmodel = JaxMlpMixer(**dict(MLP, num_classes=66, input_size=66,
                                pred_len=output_n, r_se=4, regularization=0.1))
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 10, 66)),
                            training=False)
    path = str(tmp_path / "mlp.pt")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                export_mlp_mixer(variables, 2).items()}, path)
    argv = ["--data_dir", h36m_dir, "--model_path", path, "--skip_rate", "5",
            "--output_n", str(output_n), *MLP_FLAGS]
    want = jax_test_cli.main(argv)
    got = test_cli.main([*argv, "--dev", "cpu"])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_test_cli_refuses_a_ckpt_and_defaults_to_the_card(h36m_dir, tmp_path):
    """A JAX-written MlpMixer ``.ckpt`` (no meta: the flags give the
    widths) returns the JAX CLI's numbers on it at rtol 1e-5, and a
    ``.ckpt`` whose pickle names a foreign class is refused, named;
    ``--dev`` defaults to the card, and without one the CLI raises instead
    of running on the CPU."""
    import pickle

    from motionmixerconv_tpu.train.state import TrainState
    from motionmixerconv_tpu.train.state import save_checkpoint as jax_save

    jmodel = JaxMlpMixer(**dict(MLP, num_classes=66, input_size=66, r_se=4,
                                regularization=0.1))
    variables = jmodel.init(jax.random.PRNGKey(2), jnp.zeros((1, 10, 66)),
                            training=False)
    ckpt = str(tmp_path / "m.ckpt")
    jax_save(ckpt, TrainState(
        step=jnp.zeros((), jnp.int32), params=variables["params"],
        batch_stats={}, opt_state=jax_make_optimizer(1e-3).init(
            variables["params"]), rng=jax.random.PRNGKey(0)), 0)
    argv = ["--data_dir", h36m_dir, "--model_path", ckpt, "--skip_rate", "5",
            "--actions_to_consider", "walking", *MLP_FLAGS]
    np.testing.assert_allclose(test_cli.main([*argv, "--dev", "cpu"]),
                               jax_test_cli.main(argv), rtol=1e-5)
    with open(ckpt, "rb") as f:
        payload = pickle.load(f)
    with open(ckpt, "wb") as f:
        pickle.dump({**payload, "meta": {"model": SimpleNamespace()}}, f)
    with pytest.raises(pickle.UnpicklingError, match="SimpleNamespace"):
        test_cli.main([*argv, "--dev", "cpu"])
    model = MlpMixer(**dict(MLP, num_classes=66, input_size=66, r_se=4))
    path = str(tmp_path / "mlp.pt")
    torch.save(model.state_dict(), path)
    assert test_cli.parse_args(["--model_path", path]).dev == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            test_cli.main(["--data_dir", h36m_dir, "--model_path", path,
                           *MLP_FLAGS])

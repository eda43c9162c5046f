"""The port's hyperparameter studies on the CPU, against the JAX package's.

The engine (samplers, pruner, ask/tell, the sqlite schema, optuna export)
is held to ``motionmixerconv_tpu/sweep/engine.py`` on quadratic objectives
with no training: the same suggestions in the same order, the same pruned
trials, one ``results.db`` continued across packages. The three studies
run one real trial each at tiny widths against the JAX study, both
from the JAX init (the tests patch each package's model builder and the
search space's widths): equal parameters and user-attribute keys, values
at the runner parity tolerance of ``tests/test_torch_train.py`` (rtol
1e-3).
"""

import os
import sqlite3
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionmixerconv_tpu.data import fixtures as jfix
from motionmixerconv_tpu.data.constants import AIS_ALL_ACTIONS
from motionmixerconv_tpu.sweep import analysis as jax_analysis
from motionmixerconv_tpu.sweep import autoreg_study as jax_autoreg_study
from motionmixerconv_tpu.sweep import conv_study as jax_conv_study
from motionmixerconv_tpu.sweep import engine as jeng
from motionmixerconv_tpu.sweep import mlp_study as jax_mlp_study
from motionmixerconv_tpu.sweep import optuna_export as jax_export
from motionmixerconv_tpu_torch.cli import _runner
from motionmixerconv_tpu_torch.models.torch_io import state_dict_from_jax
from motionmixerconv_tpu_torch.sweep import analysis, autoreg_study, conv_study
from motionmixerconv_tpu_torch.sweep import engine as peng
from motionmixerconv_tpu_torch.sweep import mlp_study, optuna_export

TOL_RUNNER = 1e-3  # tests/test_torch_train.py runner parity
ENGINES = {"jax": jeng, "port": peng}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def quadratic(trial):
    """A three-parameter objective with no training."""
    x = trial.suggest_int("x", -5, 5)
    y = trial.suggest_float("y", -1.0, 1.0)
    c = trial.suggest_categorical("c", ["a", "b"])
    trial.set_user_attr("sum", x + y)
    return (x - 1) ** 2 + (y - 0.3) ** 2 + (0.5 if c == "b" else 0.0)


def _record(study) -> list:
    return [(t.number, t.state, t.values, t.params, t.user_attrs,
             t.intermediate_values) for t in study.trials]


SAMPLERS = {"grid": lambda e: e.GridSampler(),
            "random": lambda e: e.RandomSampler(seed=3),
            "tpe": lambda e: e.TPESampler(seed=3, n_startup=5)}


@pytest.mark.parametrize("sampler", list(SAMPLERS))
def test_samplers_match_jax(sampler):
    """Grid, Random and TPE with the same seed suggest the same parameters
    in the same order and find the same best trial."""
    runs = {}
    for name, e in ENGINES.items():
        study = e.Study("q", sampler=SAMPLERS[sampler](e))
        study.optimize(quadratic, n_trials=25)
        runs[name] = study
    assert _record(runs["port"]) == _record(runs["jax"])
    assert runs["port"].best_trial.number == runs["jax"].best_trial.number


def curve(trial):
    """Per-step reports whose level depends on the parameter; the caller
    prunes when the study's pruner says so."""
    a = trial.suggest_int("a", 0, 7)
    for step in range(4):
        trial.report(float(abs(a - 3) + 1.0 / (step + 1)), step)
        if trial.should_prune():
            raise jeng.TrialPruned() if isinstance(
                trial, jeng.Trial) else peng.TrialPruned()
    return float(abs(a - 3))


def test_median_pruner_prunes_the_same_trials():
    """MedianPruner (2 startup trials, 1 warm-up step) prunes the same
    trials at the same steps in both packages."""
    runs = {}
    for name, e in ENGINES.items():
        study = e.Study("p", sampler=e.GridSampler(),
                        pruner=e.MedianPruner(n_startup_trials=2,
                                              n_warmup_steps=1))
        study.optimize(curve, n_trials=8)
        runs[name] = _record(study)
    assert runs["port"] == runs["jax"]
    assert sum(r[1] == "PRUNED" for r in runs["port"]) >= 2


def test_ask_tell_matches_jax():
    """Ask/tell with an enqueued trial, every state, and TPE learning from
    the told values: the same parameters, records and best trial."""
    runs = {}
    for name, e in ENGINES.items():
        study = e.Study("a", sampler=e.TPESampler(seed=1, n_startup=3))
        study.enqueue_trial({"x": 4})
        for i in range(10):
            t = study.ask()
            value = quadratic(t)
            state = ("PRUNED", "FAIL", "COMPLETE")[i % 3] if i < 6 else "COMPLETE"
            study.tell(t, value, state=state)
        runs[name] = (_record(study), study.best_trial.number)
    assert runs["port"] == runs["jax"]
    assert runs["port"][0][0][3]["x"] == 4


@pytest.mark.parametrize("first", ["jax", "port"])
def test_results_db_is_continued_by_the_other_package(first, tmp_path):
    """A grid study of 6 trials in one package's results.db, continued for
    6 more by the other, equals 12 trials in one package: the grid space,
    numbers and records persist across packages."""
    second = "port" if first == "jax" else "jax"
    db = f"sqlite:///{tmp_path}/results.db"
    for name in (first, second):
        e = ENGINES[name]
        e.Study("shared", storage=db, sampler=e.GridSampler()).optimize(
            quadratic, n_trials=6)
    straight = peng.Study("straight", sampler=peng.GridSampler())
    straight.optimize(quadratic, n_trials=12)
    for name, e in ENGINES.items():
        resumed = e.Study("shared", storage=db, sampler=e.GridSampler())
        assert [r[:5] for r in _record(resumed)] == \
            [r[:5] for r in _record(straight)], name


def test_optuna_export_matches_jax(tmp_path):
    """optuna_export of one native DB (pruned trials with intermediates, a
    study attribute) writes the same optuna-schema rows as the JAX
    package's, timestamps aside."""
    db = str(tmp_path / "results.db")
    study = peng.Study("e", storage=f"sqlite:///{db}",
                       sampler=peng.GridSampler(),
                       pruner=peng.MedianPruner(n_startup_trials=2))
    study.set_user_attr("origin", "port")
    study.optimize(curve, n_trials=8)
    rows = {}
    for name, mod in (("jax", jax_export), ("port", optuna_export)):
        out = str(tmp_path / f"{name}.db")
        assert mod.export_optuna_sqlite(db, out) == ["e"]
        conn = sqlite3.connect(out)
        tables = [r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' ORDER BY name")]
        rows[name] = {t: conn.execute(
            f"SELECT * FROM {t}" if t != "trials" else
            "SELECT trial_id, number, study_id, state FROM trials").fetchall()
            for t in tables}
        conn.close()
    assert rows["port"] == rows["jax"]
    assert rows["port"]["trial_intermediate_values"]


def test_njobs_two_gives_the_grid_trials_of_njobs_one():
    """A grid study on two worker threads records the trials, parameters
    and values of the sequential one (the grid space discovered by a
    first trial alone)."""
    runs = {}
    for n_jobs in (1, 2):
        study = peng.Study("j", sampler=peng.GridSampler())
        study.optimize(quadratic, n_trials=16, n_jobs=n_jobs)
        runs[n_jobs] = sorted(r[:5] for r in _record(study))
    assert runs[2] == runs[1] and len(runs[1]) == 16


def test_devices_place_trial_i_on_devices_i_mod_n(monkeypatch, tmp_path):
    """optimize(devices=[d0, d1]) runs trial i on devices[i % 2] with two
    workers, and conv_study's objective trains it there through args.dev."""
    seen = {}

    def fake_run(args, model=None, model_name=None, epoch_callback=None):
        seen.setdefault(args.dev, []).append(args.save_path)
        h = {"train": [1.0], "val": [1.0], "test": [float(len(seen))],
             "metrics": {args.loss_type: [1.0]}, "per_action": {}}
        return h, None

    monkeypatch.setattr(_runner, "run_h36m", fake_run)
    monkeypatch.setattr(conv_study, "_build_model", lambda *a: None)
    devices = [torch.device("cpu", 0), torch.device("cpu", 1)]
    study = peng.Study("d", sampler=peng.GridSampler(), directions=[
        "minimize", "minimize"])
    args = conv_study.parse_args(["--study_dir", str(tmp_path)])
    study.optimize(conv_study.Objective(str(tmp_path), base_args=args),
                   n_trials=6, devices=devices)
    assert [t.state for t in study.trials] == ["COMPLETE"] * 6
    for i, d in enumerate(devices):
        # two runs (mpjpe, angle) per trial, each in its trial's directory
        assert sorted(seen[str(d)]) == sorted(
            os.path.join(str(tmp_path), f"trial{n}")
            for n in range(6) if n % 2 == i for _ in range(2))


@pytest.mark.parametrize("mod", [conv_study, autoreg_study, mlp_study])
def test_study_main_forwards_the_sweep_flags(mod, monkeypatch, tmp_path):
    """Each study's main passes --n_jobs, --pruner and its devices (--dev
    alone, or every CUDA device with --spread_devices) to optimize."""
    got = {}
    monkeypatch.setattr(peng.Study, "optimize",
                        lambda self, objective, **kw: got.update(
                            kw, pruner=self.pruner, sampler=self.sampler))
    mod.main(["--study_dir", str(tmp_path / "s"), "--n_jobs", "2",
              "--pruner", "median", "--dev", "cpu"])
    assert got["n_jobs"] == 2 and got["devices"] == [torch.device("cpu")]
    assert isinstance(got["pruner"], peng.MedianPruner)
    assert got["catch"] == (Exception,)
    assert os.path.exists(tmp_path / "s" / "results.db")
    assert conv_study._trial_devices(SimpleNamespace(spread_devices=True)) \
        == [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


# ------------------------------------------------------------ the studies


@pytest.fixture(scope="module")
def h36m_dir(tmp_path_factory):
    td = tmp_path_factory.mktemp("h36m_sweep")
    jfix.make_h36m_corpus(str(td), n_frames=340, seed=5)
    return str(td)


@pytest.fixture(scope="module")
def ais_dir(tmp_path_factory):
    td = tmp_path_factory.mktemp("ais_sweep")
    jfix.make_ais_corpus(str(td), actions=AIS_ALL_ACTIONS, n_frames=300,
                         seed=4)
    return str(td)


def _tiny_space(args, trial):
    """The studies' parameter names over tiny widths and two kernel
    shapes, the trials' first grid point (1, 1) among them."""
    args.dimPosEmb = trial.suggest_int("dimPosEmb", 16, 16, step=32)
    args.channels_conv_blocks = trial.suggest_int("channels_conv_blocks", 2,
                                                  2, step=4)
    args.kernel1_x_Time = trial.suggest_int("kernel1_x_Time", 1, 5, step=4)
    args.kernel1_y_Pose = trial.suggest_int("kernel1_y_Pose", 1, 5, step=4)
    args.num_blocks = trial.suggest_int("num_blocks", 1, 1, step=2)
    return args, trial


def _jax_init_state_dict(jmodel, args, in_ntp, dim):
    """The port state_dict of the JAX runner's init of ``jmodel``
    (Trainer.init_state: the first half of PRNGKey(seed)'s split)."""
    key = jax.random.split(jax.random.PRNGKey(args.seed))[0]
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        key, jnp.zeros((2, in_ntp, dim)), training=False))
    return state_dict_from_jax(variables, args.num_blocks,
                               getattr(args, "encoder_n_harmonic_functions", 0),
                               getattr(args, "encoder_omega0", 0.1))


def _patch_conv_builders(monkeypatch, jax_mod, port_mod):
    monkeypatch.setattr(jax_mod, "overwrite_optuna_params", _tiny_space)
    monkeypatch.setattr(port_mod, "overwrite_optuna_params", _tiny_space)
    port_build = port_mod._build_model

    def build(args, pose_dim, in_ntp, out_ntp):
        model = port_build(args, pose_dim, in_ntp, out_ntp)
        model.load_state_dict(_jax_init_state_dict(
            jax_mod._build_model(args, pose_dim, in_ntp, out_ntp), args,
            in_ntp, pose_dim))
        return model

    monkeypatch.setattr(port_mod, "_build_model", build)


def _assert_same_trials(port_study, jax_study):
    assert len(port_study.trials) == len(jax_study.trials) >= 1
    for t, w in zip(port_study.trials, jax_study.trials):
        assert (t.number, t.state, t.params) == (w.number, w.state, w.params)
        assert set(t.user_attrs) == set(w.user_attrs)
        np.testing.assert_allclose(t.values, w.values, rtol=TOL_RUNNER)
        for k, v in w.user_attrs.items():
            np.testing.assert_allclose(t.user_attrs[k], v, rtol=TOL_RUNNER,
                                       err_msg=k)
        assert t.intermediate_values.keys() == w.intermediate_values.keys()
        np.testing.assert_allclose(list(t.intermediate_values.values()),
                                   list(w.intermediate_values.values()),
                                   rtol=TOL_RUNNER)


def test_conv_study_trial_matches_jax(h36m_dir, tmp_path, monkeypatch):
    """conv_study on H36M (mpjpe, then angle): one grid trial from the JAX
    init, dropout off, against the JAX study."""
    _patch_conv_builders(monkeypatch, jax_conv_study, conv_study)
    argv = ["--data_dir", h36m_dir, "--n_trials", "1", "--n_epochs", "1",
            "--skip_rate", "5", "--actions_to_consider", "walking",
            "--batch_size", "128", "--regularization", "0"]
    want = jax_conv_study.main([*argv, "--study_dir", str(tmp_path / "j")])
    got = conv_study.main([*argv, "--study_dir", str(tmp_path / "p"),
                           "--dev", "cpu"])
    _assert_same_trials(got, want)
    assert {"test_loss_mpjpe", "test_loss_angle", "walking/euler_angle"} \
        <= set(got.trials[0].user_attrs)


def test_autoreg_study_trial_matches_jax(ais_dir, tmp_path, monkeypatch):
    """autoreg_study on AIS: one grid trial, a teacher-forcing epoch then a
    closed-loop one, from the JAX init against the JAX study."""
    _patch_conv_builders(monkeypatch, jax_autoreg_study, autoreg_study)
    argv = ["--data_dir", ais_dir, "--dataset_type", "ais", "--n_trials", "1",
            "--n_epochs", "2", "--n_epochs_teacher_forcing", "1",
            "--skip_rate", "2", "--regularization", "0"]
    want = jax_autoreg_study.main([*argv, "--study_dir", str(tmp_path / "j")])
    got = autoreg_study.main([*argv, "--study_dir", str(tmp_path / "p"),
                              "--dev", "cpu"])
    _assert_same_trials(got, want)


def test_mlp_study_trial_matches_jax(h36m_dir, tmp_path, monkeypatch):
    """mlp_study: TPE (seed 0) draws the same first trial in both packages
    (6 blocks of width 54, no dropout); from the JAX init its validation
    loss is the JAX study's."""
    from motionmixerconv_tpu.cli import _runner as jax_runner

    port_build = _runner.build_mlp_mixer

    def build(args, dim, in_ntp, out_ntp, generator=None):
        model = port_build(args, dim, in_ntp, out_ntp)
        model.load_state_dict(_jax_init_state_dict(
            jax_runner.build_mlp_mixer(args, dim, in_ntp, out_ntp), args,
            in_ntp, dim))
        return model

    monkeypatch.setattr(_runner, "build_mlp_mixer", build)
    argv = ["--data_dir", h36m_dir, "--n_trials", "1", "--n_epochs", "1",
            "--skip_rate", "5", "--actions_to_consider", "walking",
            "--batch_size", "128"]
    want = jax_mlp_study.main([*argv, "--study_dir", str(tmp_path / "j")])
    got = mlp_study.main([*argv, "--study_dir", str(tmp_path / "p"),
                          "--dev", "cpu"])
    assert got.trials[0].params["regularization"] == 0
    _assert_same_trials(got, want)


def test_epoch_callback_takes_the_per_epoch_path(h36m_dir, tmp_path, capsys):
    """With --epochs_per_dispatch 2 an epoch_callback still runs after every
    epoch (the per-epoch path, with the JAX package's message), after that
    epoch's checkpoint is written."""
    args = _runner_args(h36m_dir, tmp_path, "--n_epochs", "2",
                        "--epochs_per_dispatch", "2")
    calls = []

    def callback(epoch, history):
        state = os.path.join(args.save_path, "h36_3d_25frames_ckpt",
                             _runner.STATE_FILE)
        calls.append((epoch, len(history["test"]),
                      torch.load(state, weights_only=True)["epoch"]))

    history, _ = _runner.run_h36m(args, epoch_callback=callback)
    assert calls == [(0, 1, 0), (1, 2, 1)]
    assert len(history["train"]) == 2
    assert "--epochs_per_dispatch ignored" in capsys.readouterr().out


def _runner_args(h36m_dir, tmp_path, *extra):
    from motionmixerconv_tpu_torch.cli import train_mixer_h36m

    args = train_mixer_h36m.parse_args(
        ["--data_dir", h36m_dir, "--save_path", str(tmp_path / "run"),
         "--loss_type", "mpjpe", "--skip_rate", "5", "--num_blocks", "1",
         "--hidden_dim", "16", "--actions_to_consider", "walking",
         "--batch_size", "128", "--dev", "cpu", *extra])
    args.encoder_n_harmonic_functions = 0
    return args


def test_pruned_trial_leaves_its_checkpoint(h36m_dir, tmp_path):
    """A trial the median pruner stops after its first epoch (a completed
    peer reported 0 there) is recorded PRUNED with its reported value, and
    its run directory keeps that epoch's checkpoint and logged metrics."""
    study = peng.Study("prune", sampler=peng.GridSampler(),
                       pruner=peng.MedianPruner(n_startup_trials=1))
    study.tell(study.ask(), 0.0)  # a completed peer far below any run
    study.trials[0].intermediate_values.update({0: 0.0, 1: 0.0})

    def objective(trial):
        args = _runner_args(h36m_dir, tmp_path, "--n_epochs", "3")
        _runner.run_h36m(args, epoch_callback=conv_study._epoch_reporter(
            trial, "test"))
        return 1.0

    study.optimize(objective, n_trials=1)
    trial = study.trials[-1]
    assert trial.state == "PRUNED" and list(trial.intermediate_values) == [0]
    run_dir = os.path.join(str(tmp_path / "run"), "h36_3d_25frames_ckpt")
    state = torch.load(os.path.join(run_dir, _runner.STATE_FILE),
                       weights_only=True)
    assert state["epoch"] == 0
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        assert any('"loss/test"' in line for line in f)


def test_analysis_tables_match_jax(tmp_path):
    """analysis's kernel grid, best-trials and per-action tables and the
    learning curves of a port-written results.db equal the JAX package's
    on the same file."""
    study_dir = str(tmp_path / "grid")
    os.makedirs(study_dir)
    study = peng.Study("grid", storage=f"sqlite:///{study_dir}/results.db",
                       sampler=peng.GridSampler())

    def objective(trial):
        kx = trial.suggest_int("kernel1_x_Time", 1, 9, step=4)
        ky = trial.suggest_int("kernel1_y_Pose", 1, 29, step=4)
        for a in ("walking", "eating"):
            trial.set_user_attr(f"{a}/mpjpe", float(kx * ky + len(a)))
        for step in range(2):
            trial.report(float(kx + ky + step), step)
        return float((kx - 5) ** 2 + (ky - 13) ** 2)

    study.optimize(objective, n_trials=24)
    for fn in (lambda m, df: m.kernel_grid_table(df),
               lambda m, df: m.best_trials_table(df, top=5),
               lambda m, df: m.per_action_table(df)):
        got = fn(analysis, analysis.load_study_dataframe(study_dir))
        want = fn(jax_analysis, jax_analysis.load_study_dataframe(study_dir))
        if isinstance(want, dict):
            assert got == want
        else:
            assert got.equals(want)
    assert analysis.learning_curves(study_dir).equals(
        jax_analysis.learning_curves(study_dir))
    assert analysis.kernel_grid_table(
        analysis.load_study_dataframe(study_dir)).shape == (3, 8)

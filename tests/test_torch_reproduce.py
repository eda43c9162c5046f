"""docs/REPRODUCE_TORCH.md — the port's runbook, held to docs/REPRODUCE.md.

(a) The port's ``# runbook:`` blocks are the JAX runbook's, by name. (b)
Each block's commands, parsed with ``shlex`` after joining continued lines,
equal the JAX block's once the differences the port's file lists are
normalised away (entry points, ``--dev``, ``--max_gifs``,
``--fused_encoder`` on ``h36m-direct``, the checkpoint names); any other
drift between the runbooks fails. (c) Every command's arguments, expanded
by bash at the shrink values, go through the port CLI's own
``parse_args``. (d) The blocks run end to end on synthetic corpora with
``DEV=cpu`` (``h36m-direct`` and ``amass`` here; the rest are ``slow``, as
in ``tests/test_reproduce.py``). (e) ``train_mixer_amass --model_path``
writes the format its name is read as: a ``.ckpt`` is the JAX package's
(the JAX reader and the port's read the same weights), a ``.pt`` the
port's ``train_state.pt`` payload; by default nothing is written outside
the run directory. Also: ``chip_smoke.py``'s runbook phase reads these
blocks, and its ``--as-python`` stand-in runs a module or a script as the
interpreter does and writes its launch counts.
"""

import ast
import hashlib
import json
import math
import os
import pickle
import re
import shlex
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from motionmixerconv_tpu.cli._runner import build_mlp_mixer as jax_build_mlp
from motionmixerconv_tpu.train import make_optimizer as jax_make_optimizer
from motionmixerconv_tpu.train.state import TrainState
from motionmixerconv_tpu.train.state import \
    load_checkpoint_meta as jax_load_meta
from motionmixerconv_tpu.train.state import load_variables as jax_load_variables
from motionmixerconv_tpu.train.state import \
    restore_checkpoint as jax_restore_checkpoint
from motionmixerconv_tpu_torch.cli import train_mixer_amass
from motionmixerconv_tpu_torch.cli._runner import STATE_FILE, run_amass
from motionmixerconv_tpu_torch.data import fixtures
from motionmixerconv_tpu_torch.data.constants import AIS_ALL_ACTIONS
from motionmixerconv_tpu_torch.models.torch_io import (jax_from_state_dict,
                                                       read_weights)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_MD = os.path.join(REPO, "docs", "REPRODUCE.md")
PORT_MD = os.path.join(REPO, "docs", "REPRODUCE_TORCH.md")
BLOCK_RE = re.compile(r"```bash\n# runbook: ([\w-]+)\n(.*?)```", re.S)
JAX_PKG, PORT_PKG = "motionmixerconv_tpu", "motionmixerconv_tpu_torch"
# the shrink values of tests/test_reproduce.py; the blocks default to the
# reference's real values
SHRINK = {"EPOCHS": "1", "TRIALS": "1", "TF_EPOCHS": "1",
          "ACTIONS": "walking", "OUTPUT_N": "10", "BATCH": "50"}
# the listed differences: flag pairs every port command (or the galleries)
# adds, the block whose training takes --fused_encoder, the checkpoint name
DEV_PAIR = ("--dev", "${DEV:-cuda}")
GIFS_PAIR = ("--max_gifs", "${MAX_GIFS:-3}")
FUSED_BLOCK = "h36m-direct"
HEREDOC_DEV = ',"--dev",os.environ.get("DEV","cuda")'
TOL_EVAL = 1e-4  # the test CLI against the last epoch's test, relative


def _blocks(path: str) -> dict:
    with open(path) as f:
        return dict(BLOCK_RE.findall(f.read()))


def _commands(script: str) -> list:
    """(shlex tokens, raw line, heredoc body or None) of each command of a
    block, continued lines joined."""
    lines = script.replace("\\\n", " ").splitlines()
    out, i = [], 0
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if not line:
            continue
        body = None
        m = re.search(r"<<'?(\w+)'?$", line)
        if m:
            end = lines.index(m.group(1), i)
            body, i = "\n".join(lines[i:end]), end + 1
        out.append((shlex.split(line), line, body))
    return out


def _console_scripts() -> dict:
    """mmc-* name -> module, from pyproject's [project.scripts]."""
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    return {name: target.split(":")[0] for name, target in scripts.items()}


def _jax_normal(tokens: list) -> list:
    """A JAX command as the port would spell it: console scripts as
    ``python -m <module>``, the module in the port's package."""
    scripts = _console_scripts()
    if tokens[0] in scripts:
        tokens = ["python", "-m", scripts[tokens[0]], *tokens[1:]]
    if tokens[:2] == ["python", "-m"]:
        assert tokens[2].startswith(JAX_PKG + ".")
        tokens = [*tokens[:2], PORT_PKG + tokens[2][len(JAX_PKG):],
                  *tokens[3:]]
    return tokens


def _drop_pair(tokens: list, pair: tuple) -> tuple:
    """(tokens without each ``flag value`` pair, how many were dropped)."""
    out, n, i = [], 0, 0
    while i < len(tokens):
        if tuple(tokens[i:i + 2]) == pair:
            n, i = n + 1, i + 2
        else:
            out.append(tokens[i])
            i += 1
    return out, n


def _port_normal(block: str, tokens: list) -> list:
    """A port command with the listed differences taken out; asserts that
    each one is where the list puts it."""
    if tokens[:2] != ["python", "-m"]:
        return [t.replace("train_state.pt", "model.ckpt") for t in tokens]
    tokens, n_dev = _drop_pair(tokens, DEV_PAIR)
    assert n_dev == 1, f"{block}: {tokens[2]} without one --dev"
    tokens, n_gifs = _drop_pair(tokens, GIFS_PAIR)
    assert n_gifs == (tokens[2] == f"{PORT_PKG}.viz.galleries"), tokens
    n_fused = tokens.count("--fused_encoder")
    assert n_fused == (block == FUSED_BLOCK
                       and tokens[2].endswith(".train_mixer_h36m")), tokens
    tokens = [t for t in tokens if t != "--fused_encoder"]
    return [t.replace("train_state.pt", "model.ckpt") for t in tokens]


def _heredoc_normal(body: str, port: bool) -> str:
    text = re.sub(r"\s+", "", body)
    if port:
        assert text.count(HEREDOC_DEV) == 1, "the heredoc's argv lacks --dev"
        text = text.replace(HEREDOC_DEV, "").replace(PORT_PKG, JAX_PKG)
    return text


def _port_commands() -> list:
    """pytest params of every port command that runs a Python module:
    (block, module, raw line, heredoc body)."""
    params = []
    for block, script in _blocks(PORT_MD).items():
        for k, (tokens, line, body) in enumerate(_commands(script)):
            if tokens[0] != "python":
                continue
            module = tokens[2] if tokens[1] == "-m" else None
            name = module.split(".", 1)[1] if module else "heredoc"
            params.append(pytest.param(block, module, line, body,
                                       id=f"{block}-{k}-{name}"))
    return params


def _expand(line: str, env: dict) -> list:
    """The argv bash gives the module of a ``python -m <module> ...`` line
    under ``env``."""
    rest = line.split(None, 3)[3]
    r = subprocess.run(["bash", "-c", f"printf '%s\\0' {rest}"], env=env,
                       capture_output=True, check=True)
    return r.stdout.decode().split("\0")[:-1]


def _heredoc_argv(body: str, env: dict) -> list:
    """The ``argv`` list the h36m-best-config heredoc builds, evaluated
    with ``os.environ`` = ``env``."""
    tree = ast.parse(body)
    value = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                 and getattr(n.targets[0], "id", None) == "argv")
    fake_os = SimpleNamespace(environ=env)
    return eval(compile(ast.Expression(value), "<argv>", "eval"),
                {"os": fake_os, "study_dir": os.path.join(env["RUNS"], "x")})


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------- (a)-(c): the text itself


def test_block_names_are_the_jax_runbooks():
    port, jax_blocks = _blocks(PORT_MD), _blocks(JAX_MD)
    assert list(port) == list(jax_blocks)
    assert len(port) == 11


@pytest.mark.parametrize("block", list(_blocks(JAX_MD)))
def test_block_commands_equal_the_jax_block(block):
    """The block's commands against the JAX block's, the listed
    differences normalised away; the heredoc's body likewise."""
    port = _commands(_blocks(PORT_MD)[block])
    want = _commands(_blocks(JAX_MD)[block])
    assert len(port) == len(want)
    for (tokens, _, body), (jtokens, _, jbody) in zip(port, want):
        assert _port_normal(block, tokens) == _jax_normal(jtokens)
        assert (body is None) == (jbody is None)
        if body is not None:
            assert (_heredoc_normal(body, port=True)
                    == _heredoc_normal(jbody, port=False))


@pytest.mark.parametrize("block,module,line,body", _port_commands())
def test_command_parses_in_the_port_cli(block, module, line, body, tmp_path):
    """The command's argv at the shrink values with DEV=cpu through its
    module's own parse_args (no training runs); the heredoc's imports
    resolve in the port."""
    import importlib

    env = {"PATH": os.environ["PATH"], **SHRINK, "DEV": "cpu",
           "RUNS": str(tmp_path), "H36M_DATA": "/data/h36m",
           "AIS_DATA": "/data/ais", "AMASS_DATA": "/data/amass"}
    if module is None:  # the heredoc: the module it takes parse_args from
        for node in ast.walk(ast.parse(body)):
            if isinstance(node, ast.ImportFrom):
                assert node.module.startswith(PORT_PKG)
                mod = importlib.import_module(node.module)
                for alias in node.names:
                    assert hasattr(mod, alias.name), (node.module, alias.name)
                    if alias.name == "parse_args":
                        module = node.module
        argv = _heredoc_argv(body, env)
    else:
        argv = _expand(line, env)
    args = importlib.import_module(module).parse_args(argv)
    assert args.dev == "cpu"


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_runs_every_block():
    """chip_smoke.py's runbook phase reads the port's blocks, and names a
    kernel for every block that trains a model."""
    cs = _chip_smoke()
    blocks = cs.runbook_blocks()
    assert blocks == _blocks(PORT_MD)
    assert set(blocks) == set(cs.RUNBOOK_KERNELS) | set(cs.RUNBOOK_AFTER)
    assert not set(cs.RUNBOOK_KERNELS) & set(cs.RUNBOOK_AFTER)


def test_chip_smoke_phases_are_one_table(capsys):
    """chip_smoke.py's PHASES runs phases 1-32 once each, in order; its rows
    have unique names, need only earlier rows and take one argument (the
    Run); ``alone`` refuses a name that is not a row, naming the rows,
    before it looks for a card."""
    import inspect

    cs = _chip_smoke()
    assert [n for row in cs.PHASES for n in row[0]] == list(range(1, 33))
    names = [row[1] for row in cs.PHASES]
    assert len(set(names)) == len(names)
    for i, (_, name, fn, needs, _) in enumerate(cs.PHASES):
        assert set(needs) <= set(names[:i]), name
        assert len(inspect.signature(fn).parameters) == 1, name
    with pytest.raises(SystemExit) as e:
        cs.alone("no_such_phase")
    assert e.value.code != 0
    out = capsys.readouterr().out
    assert "no_such_phase" in out and all(n in out for n in names)


@pytest.mark.parametrize("argv,stdin,printed", [
    (["-m", f"{PORT_PKG}.cli.train_mixer_amass", "--help"], None, "usage:"),
    (["-"], "import sys; print(__name__, sys.argv)", "__main__ ['-']"),
], ids=["module", "stdin"])
def test_chip_smoke_stands_in_as_python(argv, stdin, printed, tmp_path):
    """`chip_smoke.py --as-python` runs `-m <module>` and `-` as the
    interpreter does and appends the process's launch counts as one JSON
    line, however the program ends (here argparse's exit)."""
    cs = _chip_smoke()
    counts = tmp_path / "counts.jsonl"
    env = {**os.environ, "PYTHONPATH": "", "RUNBOOK_COUNTS": str(counts),
           "RUNBOOK_BLOCK": "b"}
    r = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py"),
                        cs.AS_PYTHON, *argv], input=stdin, env=env, cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert printed in r.stdout
    (rec,) = [json.loads(ln) for ln in counts.read_text().splitlines()]
    assert rec["block"] == "b" and rec["argv"] == argv[:2]
    assert rec["launches"] == dict.fromkeys(
        ("conv_mixer_fused", "conv_mixer_mc", "harmonic_dense_fwd",
         "harmonic_dense_bwd", "mlp_mixer_fused"), 0)


# ------------------------------------------ (d): the blocks, end to end


@pytest.fixture(scope="session")
def corpora(tmp_path_factory):
    base = tmp_path_factory.mktemp("reproduce_torch_data")
    h36m, ais, amass = (str(base / n) for n in ("h36m", "ais", "amass"))
    fixtures.make_h36m_corpus(h36m, n_frames=400, seed=1)
    fixtures.make_ais_corpus(ais, actions=AIS_ALL_ACTIONS, n_frames=300,
                             seed=2)
    fixtures.make_amass_corpus(amass, n_frames=300, seed=4)
    return {"H36M_DATA": h36m, "AIS_DATA": ais, "AMASS_DATA": amass}


@pytest.fixture(scope="session")
def python_bin(tmp_path_factory):
    """A directory whose ``python`` is this interpreter, first on the
    blocks' PATH."""
    bindir = tmp_path_factory.mktemp("python_bin")
    path = bindir / "python"
    path.write_text(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    path.chmod(0o755)
    return str(bindir)


def _run_block(name, corpora, runs_dir, python_bin, extra=None,
               timeout=2400):
    env = dict(os.environ)
    env["PYTHONPATH"] = ""
    env["PATH"] = python_bin + os.pathsep + env["PATH"]
    # one torch thread a process: the suite's workers share the cores
    env.update({"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"})
    env.update(corpora)
    env.update(SHRINK)
    env.update({"DEV": "cpu", "RUNS": str(runs_dir)})
    env.update(extra or {})
    os.makedirs(runs_dir, exist_ok=True)
    r = subprocess.run(["bash", "-e", "-c", _blocks(PORT_MD)[name]], env=env,
                       cwd=REPO, capture_output=True, timeout=timeout)
    assert r.returncode == 0, (
        f"runbook block {name!r} failed:\n--- stdout:\n"
        f"{r.stdout.decode()[-1500:]}\n--- stderr:\n{r.stderr.decode()[-1500:]}")
    return r.stdout.decode()


def test_h36m_direct_block(corpora, tmp_path, python_bin):
    out = _run_block("h36m-direct", corpora, tmp_path / "runs", python_bin)
    assert "Training finished" in out
    assert "tables.md" in out
    table = tmp_path / "runs" / "h36m_report" / "tables.md"
    assert "| walking |" in table.read_text()
    gifs = list((tmp_path / "runs" / "h36m_report" / "visualization")
                .glob("*.gif"))
    assert gifs  # MAX_GIFS unset: the galleries' default renders


def test_amass_block(corpora, tmp_path, python_bin):
    """The JAX block's `--model_path amass_model.ckpt`: the trainer writes
    a JAX .ckpt there and the test CLI reads it back, evaluating what the
    last epoch's test evaluated."""
    out = _run_block("amass", corpora, tmp_path / "runs", python_bin)
    assert "Training finished" in out
    last_test = float(re.findall(r"^epoch \d+: .* test ([\d.]+)", out,
                                 re.M)[-1])
    evaluated = float(re.search(r"overall average loss in mm is: ([\d.]+)",
                                out).group(1))
    assert math.isfinite(evaluated)
    assert abs(evaluated - last_test) <= TOL_EVAL * last_test
    with open(tmp_path / "runs" / "amass_model.ckpt", "rb") as f:
        assert {"state", "variables", "epoch", "meta"} <= set(pickle.load(f))


@pytest.mark.slow
def test_h36m_eval_block(corpora, tmp_path, python_bin):
    out = _run_block("h36m-eval", corpora, tmp_path / "runs", python_bin)
    assert "Training finished" in out


@pytest.mark.slow
def test_h36m_study_blocks(corpora, tmp_path, python_bin):
    _run_block("h36m-study", corpora, tmp_path / "runs", python_bin)
    out = _run_block("h36m-study-tables", corpora, tmp_path / "runs",
                     python_bin)
    assert "kernel" in out.lower()


@pytest.mark.slow
def test_h36m_autoreg_block(corpora, tmp_path, python_bin):
    # the reference AR defaults (hidden 192, 8 channels, BN) exceed the
    # CPU budget; the shrink variables default to the real values
    _run_block("h36m-autoreg", corpora, tmp_path / "runs", python_bin,
               extra={"AR_HIDDEN": "32", "AR_BLOCKS": "1", "AR_NCHAN": "1"})


@pytest.mark.slow
def test_h36m_autoreg_study_block(corpora, tmp_path, python_bin):
    _run_block("h36m-autoreg-study", corpora, tmp_path / "runs", python_bin)


@pytest.mark.slow
def test_ais_blocks(corpora, tmp_path, python_bin):
    _run_block("ais-local", corpora, tmp_path / "runs", python_bin)
    _run_block("ais-global", corpora, tmp_path / "runs", python_bin)


@pytest.mark.slow
def test_ais_autoreg_block(corpora, tmp_path, python_bin):
    _run_block("ais-autoreg", corpora, tmp_path / "runs", python_bin)


@pytest.mark.slow
def test_h36m_best_config_block(corpora, tmp_path, python_bin):
    out = _run_block("h36m-best-config", corpora, tmp_path / "runs",
                     python_bin)
    assert "[" in out  # printed trial values


# ----------------------------- (e): train_mixer_amass --model_path, routed


@pytest.fixture(scope="module")
def amass_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("amass_copy") / "amass")
    fixtures.make_amass_corpus(d, n_frames=300, seed=4)
    return d


def _amass_args(amass_dir, save_path, *extra):
    return train_mixer_amass.parse_args([
        "--dev", "cpu", "--data_dir", amass_dir, "--save_path", save_path,
        "--n_epochs", "2", "--skip_rate", "5", "--num_blocks", "2",
        "--hidden_dim", "16", "--channels_mlp_dim", "16", "--batch_size",
        "64", *extra])


@pytest.mark.parametrize("epd", ["1", "2"], ids=["per_epoch", "chunked"])
def test_amass_ckpt_copy_is_the_jax_ckpt(amass_dir, tmp_path, epd):
    """`--model_path X.ckpt` (per epoch, and once a chunk with
    --epochs_per_dispatch 2) is the JAX package's .ckpt: JAX
    load_variables, load_checkpoint_meta and restore_checkpoint (its
    make_optimizer's chain) read the trained weights, the stored args and
    the optimizer's step count; the port's read_weights reads the same
    weights."""
    path = str(tmp_path / "amass_model.ckpt")
    args = _amass_args(amass_dir, str(tmp_path / "runs"), "--model_path",
                       path, "--epochs_per_dispatch", epd)
    _, trainer = run_amass(args)
    model, opt = trainer.model, trainer.optimizer
    want = jax_from_state_dict(model.state_dict(), args.num_blocks)
    jmodel = jax_build_mlp(args, 54, args.input_n, args.output_n)
    init = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 10, 54)),
                       training=False)
    got = jax_load_variables(path, init)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(want))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert jax_load_meta(path) == vars(args)
    jopt = jax_make_optimizer(args.lr, weight_decay=1e-5,
                              milestones=args.milestones, gamma=args.gamma,
                              steps_per_epoch=opt.steps // args.n_epochs)
    template = TrainState(step=jnp.zeros((), jnp.int32),
                          params=init["params"],
                          batch_stats=init.get("batch_stats", {}),
                          opt_state=jopt.init(init["params"]),
                          rng=jax.random.PRNGKey(0))
    state, epoch = jax_restore_checkpoint(path, template)
    assert epoch == args.n_epochs - 1 and int(state.step) == opt.steps
    sd, meta = read_weights(path)
    assert meta == vars(args)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(sd[k], v, rtol=0, atol=0)


def test_amass_pt_copy_is_the_train_state_payload(amass_dir, tmp_path):
    """A `.pt` name still gets train_state.pt's payload, equal to the run
    directory's."""
    path = tmp_path / "copy.pt"
    runs = tmp_path / "runs"
    run_amass(_amass_args(amass_dir, str(runs), "--model_path", str(path)))
    copy = torch.load(path, weights_only=True)
    state = torch.load(runs / "amass_3d_25frames_ckpt" / STATE_FILE,
                       weights_only=True)
    assert set(copy) == set(state) == {"model", "optimizer", "epoch",
                                       "rng_cpu", "rng_cuda", "meta"}
    assert copy["epoch"] == state["epoch"] == 1
    assert copy["meta"] == state["meta"]
    for k, v in state["model"].items():
        torch.testing.assert_close(copy["model"][k], v, rtol=0, atol=0)


def test_amass_default_writes_only_the_run_dir(amass_dir, tmp_path,
                                               monkeypatch):
    """--model_path defaults to None in the port (a divergence kept: the
    JAX default overwrites the committed checkpoints/amass_3d_25frames_ckpt
    on every default run): a default run, started in an empty directory,
    writes its run directory and nothing else there, and the committed
    checkpoint is untouched."""
    committed = os.path.join(REPO, "checkpoints", "amass_3d_25frames_ckpt")

    def digest():
        with open(committed, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    before = digest()
    cwd = tmp_path / "cwd"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    args = _amass_args(amass_dir, "runs")
    assert args.model_path is None
    run_amass(args)
    assert os.listdir(cwd) == ["runs"]
    assert os.listdir(cwd / "runs") == ["amass_3d_25frames_ckpt"]
    assert digest() == before

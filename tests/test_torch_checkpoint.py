"""Checkpoint interchange between the port and the JAX package, on the CPU.

The port reads and writes the JAX package's ``.ckpt`` (a pickle of flax
msgpack blobs) without the ``msgpack`` package: its decoder is held bit for
bit to ``flax.serialization`` on the committed checkpoint and on random
trees; JAX-written ``.ckpt`` files of every model family are served and
evaluated by the port against the JAX package's own ``Predictor`` and CLIs
(forwards at 2e-5, the tolerance of ``tests/test_models.py``; CLI numbers at
rtol 1e-5); port-written ``.ckpt`` files are read by the JAX package's
``load_variables``, ``load_checkpoint_meta`` and ``restore_checkpoint``;
and a run resumed in the other package matches the same package's own
resume at the runner parity tolerance of ``tests/test_torch_train.py``
(rtol 1e-3).
"""

import copy
import json
import os
import pickle
import shutil
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from motionmixerconv_tpu.cli import test_mixer_amass as jax_amass_cli
from motionmixerconv_tpu.cli import test_mixer_h36m as jax_h36m_cli
from motionmixerconv_tpu.cli import train_autoreg_mixer_h36m as jax_ar_cli
from motionmixerconv_tpu.cli import train_mixer_ais as jax_ais_cli
from motionmixerconv_tpu.cli import train_mixer_amass as jax_amass_train_cli
from motionmixerconv_tpu.cli import train_mixer_h36m as jax_h36m_train_cli
from motionmixerconv_tpu.cli._runner import build_conv_mixer as jax_build
from motionmixerconv_tpu.cli._runner import build_mlp_mixer as jax_build_mlp
from motionmixerconv_tpu.cli._runner import \
    model_from_checkpoint_meta as jax_model_from_meta
from motionmixerconv_tpu.cli._runner import run_h36m as jax_run_h36m
from motionmixerconv_tpu.data import fixtures as jfix
from motionmixerconv_tpu.serving import Predictor as JaxPredictor
from motionmixerconv_tpu.train import make_optimizer as jax_make_optimizer
from motionmixerconv_tpu.train.state import TrainState
from motionmixerconv_tpu.train.state import \
    load_checkpoint_meta as jax_load_meta
from motionmixerconv_tpu.train.state import load_variables as jax_load_variables
from motionmixerconv_tpu.train.state import \
    restore_checkpoint as jax_restore_checkpoint
from motionmixerconv_tpu.train.state import save_checkpoint as jax_save_checkpoint
from motionmixerconv_tpu_torch import serving_server
from motionmixerconv_tpu_torch.cli import test_mixer_amass as amass_cli
from motionmixerconv_tpu_torch.cli import test_mixer_h36m as h36m_cli
from motionmixerconv_tpu_torch.cli import train_mixer_h36m as port_train_cli
from motionmixerconv_tpu_torch.cli._runner import (STATE_FILE, build_conv_mixer,
                                                   build_mlp_mixer, run_h36m)
from motionmixerconv_tpu_torch.models import ConvMixer, MlpMixer
from motionmixerconv_tpu_torch.models.torch_io import state_dict_from_jax
from motionmixerconv_tpu_torch.serving import Predictor, model_io
from motionmixerconv_tpu_torch.serving_server import PredictionServer
from motionmixerconv_tpu_torch.train import flax_msgpack, make_optimizer
from motionmixerconv_tpu_torch.train.state import (read_jax_checkpoint,
                                                   restore_checkpoint,
                                                   save_jax_checkpoint)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANCHOR = os.path.join(REPO, "checkpoints", "amass_3d_25frames_ckpt")
# the anchor: a 2-block MlpMixer of hidden width 30 on 54 dims, 10 -> 25
ANCHOR_MLP = dict(num_classes=54, num_blocks=2, hidden_dim=30,
                  tokens_mlp_dim=20, channels_mlp_dim=128, seq_len=10,
                  pred_len=25, activation="gelu", regularization=0.1,
                  input_size=54, r_se=8, use_se=True)
TOL_FORWARD = 2e-5   # tests/test_models.py
TOL_RUNNER = 1e-3    # tests/test_torch_train.py runner parity


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Small tensors: one intra-op thread, as the suite's workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, tree


def _bits(x) -> np.ndarray:
    """A leaf's raw bytes as an array: a bfloat16 leaf (a torch tensor in
    the port, an ml_dtypes array in flax) through its 16 bits."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16)
    return x


def _assert_same_tree(mine, ref):
    got, want = dict(_leaves(mine)), dict(_leaves(ref))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (np.ndarray, np.generic)) or hasattr(w, "dtype"):
            assert np.asarray(_bits(g)).dtype == np.asarray(_bits(w)).dtype, k
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=k)
        else:
            assert type(g) is type(w) and g == w, k


# ---------------------------------------------------------------- msgpack


@pytest.mark.parametrize("blob", ["state", "variables"])
def test_decoder_matches_flax_on_the_committed_checkpoint(blob):
    """Both blobs of the committed JAX checkpoint decode to exactly what
    flax.serialization.msgpack_restore gives, leaf for leaf and bit for
    bit, and the port's encoding of that tree is the file's bytes."""
    with open(ANCHOR, "rb") as f:
        payload = pickle.load(f)
    mine = flax_msgpack.msgpack_restore(payload[blob])
    _assert_same_tree(mine, serialization.msgpack_restore(payload[blob]))
    assert flax_msgpack.msgpack_serialize(mine) == payload[blob]


def test_flax_restores_the_port_encoding():
    """flax's msgpack_restore of the port's encoding equals the tree it
    encoded (every leaf type flax writes), and the port decodes flax's
    encoding of the same tree to it."""
    rs = np.random.RandomState(0)
    tree = {"a": rs.randn(3, 4).astype(np.float32),
            "b": {"i32": np.arange(6, dtype=np.int32).reshape(2, 3),
                  "u32": np.asarray([0, 2 ** 32 - 1], np.uint32),
                  "f64": rs.randn(5),
                  "bool": np.asarray([True, False]),
                  "scalar": np.float32(1.5), "count": np.asarray(7, np.int32),
                  "empty": {}},
            "py": {"int": -70000, "big": 2 ** 40, "float": 0.25, "str": "x" * 40,
                   "bytes": b"\x00" * 300, "none": None, "list": [1, 2.0, "z"],
                   "complex": complex(1.0, -2.0)}}
    encoded = flax_msgpack.msgpack_serialize(tree)
    back = serialization.msgpack_restore(encoded)
    back["py"]["list"] = list(back["py"]["list"])
    _assert_same_tree(back, tree)
    _assert_same_tree(flax_msgpack.msgpack_restore(
        serialization.msgpack_serialize(tree)), back)


_DTYPES = ["float32", "float64", "int32", "uint32", "bool", "bfloat16"]


@st.composite
def _arrays(draw):
    dtype = draw(st.sampled_from(_DTYPES))
    shape = draw(st.lists(st.integers(0, 4), max_size=3))
    n = int(np.prod(shape))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    rs = np.random.RandomState(seed)
    if dtype == "bool":
        return rs.rand(n).reshape(shape) < 0.5
    if dtype == "bfloat16":
        return jnp.asarray(rs.randn(n).reshape(shape), jnp.bfloat16)
    if dtype in ("int32", "uint32"):
        info = np.iinfo(dtype)
        return rs.randint(info.min, info.max, size=n, dtype=np.int64
                          ).astype(dtype).reshape(shape)
    return rs.randn(n).reshape(shape).astype(dtype)


_text = st.text(st.characters(exclude_categories=("Cs",)), max_size=40)
_leaf = st.one_of(_arrays(), st.integers(-2 ** 63, 2 ** 64 - 1),
                  st.floats(allow_nan=False), _text,
                  st.booleans(), st.none(),
                  st.builds(np.float32, st.floats(-1e3, 1e3)),
                  st.builds(np.int32, st.integers(-2 ** 31, 2 ** 31 - 1)))
_keys = st.text(st.characters(exclude_categories=("Cs",)), min_size=1,
                max_size=8)
_trees = st.recursive(_leaf, lambda kids: st.dictionaries(
    _keys, kids, max_size=5), max_leaves=12)


@settings(max_examples=60, deadline=None)
@given(tree=st.dictionaries(_keys, _trees, max_size=5))
def test_msgpack_round_trip_matches_flax(tree):
    """Nested maps of f32, f64, i32, u32, bool and bf16 arrays and Python
    and numpy scalars: the port's encoding is flax's bytes, its decoding
    of them is flax's tree, leaf for leaf and bit for bit."""
    ref_bytes = serialization.msgpack_serialize(tree)
    mine = flax_msgpack.msgpack_restore(ref_bytes)
    _assert_same_tree(mine, serialization.msgpack_restore(ref_bytes))
    assert flax_msgpack.msgpack_serialize(mine) == ref_bytes


@pytest.mark.parametrize("data, match", [
    (b"\xc7\x01\x07\x00", "ext type 7"),            # an ext flax never writes
    (b"\x81\x01\x02", "int key"),                   # a non-str map key
    (b"\x01\x02", "1 bytes left"),                  # trailing bytes
    (b"\x92\x01", "truncated"),                     # a cut array
    (b"\xc1", "0xc1"),                              # msgpack's unused byte
    (b"\xc7\x14\x01\x93\x91\x01\xadfloat8_e4m3fn\xc4\x01\x00",
     "float8_e4m3fn"),                              # a dtype numpy lacks
])
def test_decoder_refuses_what_flax_does_not_write(data, match):
    with pytest.raises(ValueError, match=match):
        flax_msgpack.msgpack_restore(data)


class _Foreign:
    """A class a JAX checkpoint never holds; unpickling must not build it."""

    built = 0

    def __reduce__(self):
        return (_Foreign._make, ())

    @staticmethod
    def _make():
        _Foreign.built += 1
        return _Foreign()


def test_restricted_unpickler_refuses_a_foreign_class(tmp_path):
    """A pickle naming any class beyond builtins and numpy raises, naming
    it, before that class runs; a file that is no checkpoint raises
    ValueError; numpy arrays and scalars in the meta load."""
    path = str(tmp_path / "bad.ckpt")
    with open(ANCHOR, "rb") as f:
        payload = pickle.load(f)
    with open(path, "wb") as f:
        pickle.dump({**payload, "meta": {"x": _Foreign()}}, f)
    with pytest.raises(pickle.UnpicklingError, match="_Foreign"):
        read_jax_checkpoint(path)
    assert _Foreign.built == 0
    with open(path, "wb") as f:
        f.write(b"not a pickle")
    with pytest.raises(ValueError, match="not a pickled checkpoint"):
        read_jax_checkpoint(path)
    with open(path, "wb") as f:
        pickle.dump({**payload, "meta": {"a": np.arange(3), "b": np.int64(2)}},
                    f)
    meta = read_jax_checkpoint(path).meta
    np.testing.assert_array_equal(meta["a"], np.arange(3))
    assert meta["b"] == 2


# ----------------------------------------------------- JAX .ckpt -> port


def test_committed_anchor_serves_like_the_jax_forward():
    """The committed JAX checkpoint (no meta, no extension) served by the
    port's Predictor (B4's plain version on the CPU) matches the flax
    forward of its variables at 2e-5."""
    jmodel = jax_build_mlp(_ns(hidden_dim=30, num_blocks=2, tokens_mlp_dim=20,
                               channels_mlp_dim=128, activation="gelu",
                               regularization=0.1, r_se=8), 54, 10, 25)
    template = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 10, 54)),
                           training=False)
    variables = jax_load_variables(ANCHOR, template)
    pred = Predictor.from_checkpoint(None, ANCHOR, device="cpu",
                                     model_factory=lambda: MlpMixer(**ANCHOR_MLP))
    assert type(pred._fused).__name__ == "FusedMlpMixer"
    x = np.random.RandomState(1).randn(5, 10, 54).astype(np.float32)
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), training=False))
    np.testing.assert_allclose(pred.predict(x).numpy(), want, atol=TOL_FORWARD)


def _ns(**kw):
    from types import SimpleNamespace

    return SimpleNamespace(**kw)


def _cli_meta(cli, argv) -> dict:
    """A JAX training CLI's stored meta: its parsed flags, with the kernel
    shape its ``main`` adds before training."""
    args = cli.parse_args(argv)
    if hasattr(args, "kernel1_x"):
        args.conv1_kernel_shape = (args.kernel1_x, args.kernel1_y)
    return vars(args)


# the five families, each at small widths: (CLI, argv, meta overrides)
FAMILIES = {
    "flagship": (jax_h36m_train_cli, ["--loss_type", "mpjpe", "--num_blocks",
                                      "2", "--hidden_dim", "16"],
                 {"encoder_n_harmonic_functions": 4}),
    "angle": (jax_h36m_train_cli, ["--num_blocks", "2", "--hidden_dim", "12"],
              {"encoder_n_harmonic_functions": 2}),
    "autoregressive_bn": (jax_ar_cli, ["--loss_type", "mpjpe", "--num_blocks",
                                       "2", "--hidden_dim", "16",
                                       "--conv_nChan", "3"], {}),
    "amass_mlp": (jax_amass_train_cli, ["--num_blocks", "2", "--hidden_dim",
                                        "16", "--channels_mlp_dim", "24",
                                        "--tokens_mlp_dim", "8",
                                        "--regularization", "-1"], {}),
    "ais": (jax_ais_cli, ["--num_blocks", "2", "--hidden_dim", "16"], {}),
}


def _jax_ckpt(path, meta, seed, clip_grad=None):
    """A JAX-written .ckpt of the model ``meta`` describes, initialised
    from ``seed``, with random BatchNorm statistics where it has any;
    returns (flax model, its variables)."""
    model, shape = jax_model_from_meta(meta)
    variables = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(seed), jnp.zeros(shape), training=False))
    rs = np.random.RandomState(seed)
    stats = jax.tree_util.tree_map(
        lambda a: (rs.rand(*a.shape) + 0.5).astype(np.float32),
        variables.get("batch_stats", {}))
    opt = jax_make_optimizer(1e-3, steps_per_epoch=3, clip_grad=clip_grad)
    state = TrainState(step=jnp.asarray(5, jnp.int32),
                       params=variables["params"], batch_stats=stats,
                       opt_state=opt.init(variables["params"]),
                       rng=jax.random.PRNGKey(seed))
    jax_save_checkpoint(path, state, 2, meta=meta)
    out = {"params": variables["params"]}
    if stats:
        out["batch_stats"] = stats
    return model, out


@pytest.mark.parametrize("family", list(FAMILIES))
def test_jax_ckpt_with_meta_rebuilds_each_family(family, tmp_path):
    """A JAX-written .ckpt with meta rebuilds through
    Predictor.from_checkpoint(None, path) and matches the JAX Predictor on
    the same inputs at 2e-5 (the fused kernels' plain versions on the
    CPU)."""
    cli, argv, extra = FAMILIES[family]
    meta = {**_cli_meta(cli, argv), **extra}
    path = str(tmp_path / "model.ckpt")
    _jax_ckpt(path, meta, seed=len(family))
    want_pred = JaxPredictor.from_checkpoint(None, path)
    pred = Predictor.from_checkpoint(None, path, device="cpu")
    assert pred._fused is not None, pred.fused_fallback_reason
    in_n, _, dim = model_io(pred.model)
    x = np.random.RandomState(2).randn(6, in_n, dim).astype(np.float32) * 0.5
    want = np.asarray(want_pred.predict(jnp.asarray(x)))
    np.testing.assert_allclose(pred.predict(x).numpy(), want,
                               atol=TOL_FORWARD)


@pytest.fixture(scope="module")
def h36m_dir(tmp_path_factory):
    td = tmp_path_factory.mktemp("h36m_ckpt")
    jfix.make_h36m_corpus(str(td), n_frames=340, seed=3)
    return str(td)


@pytest.fixture(scope="module")
def amass_dir(tmp_path_factory):
    td = tmp_path_factory.mktemp("amass_ckpt")
    jfix.make_amass_corpus(str(td), n_frames=300, seed=4)
    return str(td)


def test_h36m_test_cli_on_a_jax_ckpt_matches_the_jax_cli(h36m_dir, tmp_path):
    """cli.test_mixer_h36m on a JAX .ckpt (its meta fills the architecture:
    a ConvMixer) gives the JAX CLI's numbers (rtol 1e-5)."""
    meta = {**_cli_meta(jax_h36m_train_cli, FAMILIES["flagship"][1]),
            "encoder_n_harmonic_functions": 4}
    path = str(tmp_path / "model.ckpt")
    _jax_ckpt(path, meta, seed=3)
    argv = ["--data_dir", h36m_dir, "--model_path", path, "--skip_rate", "5",
            "--actions_to_consider", "walking"]
    want = jax_h36m_cli.main(argv)
    got = h36m_cli.main([*argv, "--dev", "cpu"])
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_amass_test_cli_on_the_committed_ckpt_matches_the_jax_cli(amass_dir):
    """cli.test_mixer_amass on the committed JAX checkpoint (no meta: the
    widths come from the flags) gives the JAX CLI's number (rtol 1e-5)."""
    argv = ["--data_dir", amass_dir, "--model_path", ANCHOR, "--skip_rate",
            "5", "--num_blocks", "2", "--hidden_dim", "30",
            "--batch_size", "20"]
    want = jax_amass_cli.main(argv)
    got = amass_cli.main([*argv, "--dev", "cpu"])
    assert got == pytest.approx(want, rel=1e-5)


def test_serving_server_answers_predict_from_a_jax_ckpt(tmp_path):
    """serving_server --model_path x.ckpt (--arch auto: the meta rebuilds
    the model) answers /predict with the JAX forward's numbers."""
    cli, argv, extra = FAMILIES["flagship"]
    path = str(tmp_path / "x.ckpt")
    jmodel, variables = _jax_ckpt(path, {**_cli_meta(cli, argv), **extra}, 9)
    pred = serving_server.load_predictor(
        serving_server.build_parser().parse_args(["--model_path", path]), "cpu")
    server = PredictionServer(pred, port=0, max_wait_ms=1.0, warmup=False)
    server.start_background()
    x = np.random.RandomState(3).randn(2, 10, 66).astype(np.float32) * 0.5
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.port}/predict",
            data=json.dumps({"inputs": x.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = np.asarray(json.loads(r.read())["outputs"], np.float32)
    finally:
        server.close()
    want = np.asarray(jmodel.apply(variables, jnp.asarray(x), training=False))
    np.testing.assert_allclose(out, want, atol=TOL_FORWARD)


# ----------------------------------------------------- port .ckpt -> JAX


def _trained_port_model(model, clip_grad, steps=3):
    """``model`` after ``steps`` Adam steps on random data (so the moments
    are not zero), with random BatchNorm statistics; its optimizer."""
    gen = torch.Generator().manual_seed(5)
    opt = make_optimizer(model.parameters(), lr=1e-3, steps_per_epoch=2,
                         milestones=[1], clip_grad=clip_grad)
    model.train()
    for _ in range(steps):
        x = torch.randn(4, 10, 66, generator=gen)
        loss = model(x).square().mean()
        opt.zero_grad()
        loss.backward()
        opt.step()
    return model.eval(), opt


PORT_MODELS = {
    "conv_bn": lambda: ConvMixer(
        num_blocks=2, dimPosIn=66, dimPosEmb=16, dimPosOut=66, in_nTP=10,
        out_nTP=25, conv_nChan=3, conv1_kernel_shape=(3, 3), mode_conv="twice",
        activation="mish", regularization=-1.0, use_se=True, r_se=4,
        encoder_n_harmonic_functions=4,
        generator=torch.Generator().manual_seed(1)),
    "mlp": lambda: MlpMixer(
        num_classes=66, num_blocks=2, hidden_dim=16, tokens_mlp_dim=8,
        channels_mlp_dim=24, seq_len=10, pred_len=25, activation="gelu",
        regularization=0.1, input_size=66, r_se=4, use_se=True,
        generator=torch.Generator().manual_seed(2)),
}


def _jax_twin(name):
    """The flax model of PORT_MODELS[name]."""
    if name == "mlp":
        return jax_build_mlp(_ns(hidden_dim=16, num_blocks=2, tokens_mlp_dim=8,
                                 channels_mlp_dim=24, activation="gelu",
                                 regularization=0.1, r_se=4), 66, 10, 25)
    return jax_build(_ns(num_blocks=2, hidden_dim=16, conv_nChan=3,
                         conv1_kernel_shape=(3, 3), mode_conv="twice",
                         activation="mish", regularization=-1.0, r_se=4,
                         encoder_n_harmonic_functions=4), 66, 66, 10, 25)


@pytest.mark.parametrize("clip_grad", [None, 1.0])
@pytest.mark.parametrize("name", list(PORT_MODELS))
def test_jax_reads_a_port_ckpt(name, clip_grad, tmp_path):
    """A port-written .ckpt of a ConvMixer with BatchNorm and of an
    MlpMixer, with and without --clip_grad: JAX load_variables,
    load_checkpoint_meta and restore_checkpoint (template from JAX
    make_optimizer with the same chain) read it; the JAX forward on its
    variables matches the port's at 2e-5; the restored Adam state and
    step are the port's."""
    model, opt = _trained_port_model(PORT_MODELS[name](), clip_grad)
    path = str(tmp_path / "port.ckpt")
    meta = {"lr": 1e-3, "note": "port", "milestones": [1]}
    save_jax_checkpoint(path, model, opt, 4, meta=meta, seed=7)
    jmodel = _jax_twin(name)
    init = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((2, 10, 66)),
                       training=False)
    variables = jax_load_variables(path, init)
    assert jax_load_meta(path) == meta
    # both forwards in float64 (the variables as read, widened): in
    # float32 the JAX CPU forward of the BatchNorm ConvMixer strays ~1e-4
    # from a float64 forward of the same weights, the port's ~3e-7
    x = np.random.RandomState(4).randn(3, 10, 66)
    with jax.enable_x64(True):
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     variables)
        want = np.asarray(jmodel.apply(v64, jnp.asarray(x), training=False))
    with torch.no_grad():
        mine = copy.deepcopy(model).double()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(mine, want, atol=TOL_FORWARD)
    jopt = jax_make_optimizer(1e-3, steps_per_epoch=2, milestones=[1],
                              clip_grad=clip_grad)
    template = TrainState(step=jnp.zeros((), jnp.int32),
                          params=init["params"],
                          batch_stats=init.get("batch_stats", {}),
                          opt_state=jopt.init(init["params"]),
                          rng=jax.random.PRNGKey(0))
    state, epoch = jax_restore_checkpoint(path, template)
    assert epoch == 4 and int(state.step) == opt.steps
    np.testing.assert_array_equal(np.asarray(state.rng), [0, 7])
    adam = state.opt_state[-1][0]
    assert int(adam.count) == opt.steps
    mu = state_dict_from_jax({"params": jax.tree_util.tree_map(
        np.asarray, adam.mu), "batch_stats": variables.get("batch_stats", {})},
        2)
    names = {id(p): n for n, p in model.named_parameters()}
    for p in opt.params:
        np.testing.assert_array_equal(
            mu[names[id(p)]].numpy(), opt.adam.state[p]["exp_avg"].numpy())


def test_port_ckpt_round_trip_restores_the_optimizer(tmp_path):
    """A port-written .ckpt read back by the port: weights bit-identical,
    Adam's moments and count and the schedule's position (a milestone
    passed) restored; the next step equals the unbroken optimizer's."""
    model, opt = _trained_port_model(PORT_MODELS["conv_bn"](), None)
    path = str(tmp_path / "port.ckpt")
    save_jax_checkpoint(path, model, opt, 1)
    clone = PORT_MODELS["conv_bn"]()
    opt2 = make_optimizer(clone.parameters(), lr=1e-3, steps_per_epoch=2,
                          milestones=[1])
    assert restore_checkpoint(path, clone, opt2) == 1
    for (k, a), b in zip(model.state_dict().items(),
                         clone.state_dict().values()):
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    assert (opt2.steps, opt2.lr) == (opt.steps, opt.lr) and opt.lr < 1e-3
    for p, q in zip(opt.params, opt2.params):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(opt.adam.state[p][key],
                                       opt2.adam.state[q][key], rtol=0, atol=0)


# ------------------------------------------------ resume across packages


def _argv(data_dir, save, *extra):
    return ["--data_dir", data_dir, "--save_path", save, "--loss_type",
            "mpjpe", "--skip_rate", "5", "--num_blocks", "1", "--hidden_dim",
            "16", "--actions_to_consider", "walking", "--batch_size", "128",
            "--regularization", "0", "--milestones", "1", *extra]


def _jax_args(h36m_dir, save, *extra):
    args = jax_h36m_train_cli.parse_args(_argv(h36m_dir, save, *extra))
    args.encoder_n_harmonic_functions = 4
    return args


def _port_args(h36m_dir, save, *extra):
    args = port_train_cli.parse_args(_argv(h36m_dir, save, *extra, "--dev",
                                           "cpu"))
    args.encoder_n_harmonic_functions = 4
    return args


def _compare(got, want):
    for key in ("train", "val", "test"):
        np.testing.assert_allclose(got[key], want[key], rtol=TOL_RUNNER,
                                   err_msg=key)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_resume_across_packages(first, h36m_dir, tmp_path):
    """One epoch in one package, then the next epoch resumed from its
    checkpoint in the other package (dropout 0, a milestone at epoch 1):
    the resumed epoch matches the first package's own resume at rtol
    1e-3. A JAX model.ckpt resumes in run_h36m; a port run's .ckpt (written
    by save_jax_checkpoint) resumes in the JAX run_h36m."""
    jmodel = jax_build(_jax_args(h36m_dir, "x"), 66, 66, 10, 25)
    variables = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 10, 66)), training=False))
    one = str(tmp_path / "one")
    if first == "jax":
        jax_run_h36m(_jax_args(h36m_dir, one, "--n_epochs", "1"),
                     model=jmodel, init_variables=jax.tree_util.tree_map(
                         jnp.asarray, variables))
        ckpt = str(tmp_path / "epoch0.ckpt")  # the resumed run rewrites its own
        shutil.copy(os.path.join(one, "h36_3d_25frames_ckpt", "model.ckpt"),
                    ckpt)
        want, _, _ = jax_run_h36m(_jax_args(h36m_dir, one, "--n_epochs", "2",
                                            "--resume", ckpt), model=jmodel)
        got, _ = run_h36m(_port_args(h36m_dir, str(tmp_path / "port"),
                                     "--n_epochs", "2", "--resume", ckpt))
    else:
        _, trainer = run_h36m(
            _port_args(h36m_dir, one, "--n_epochs", "1"),
            init_state_dict=state_dict_from_jax(variables, 1, 4))
        ckpt = str(tmp_path / "port.ckpt")
        save_jax_checkpoint(ckpt, trainer.model, trainer.optimizer, 0,
                            meta={"seed": 0})
        state_pt = os.path.join(one, "h36_3d_25frames_ckpt", STATE_FILE)
        want, _ = run_h36m(_port_args(h36m_dir, one, "--n_epochs", "2",
                                      "--resume", state_pt))
        got, _, _ = jax_run_h36m(
            _jax_args(h36m_dir, str(tmp_path / "jax"), "--n_epochs", "2",
                      "--resume", ckpt), model=jmodel)
    assert len(got["train"]) == len(want["train"]) == 1
    _compare(got, want)

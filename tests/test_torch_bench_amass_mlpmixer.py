"""The AMASS MotionMixer cell of the benchmark (``amass_mlpmixer.train``)
on the CPU at a small size: the port's ``MlpMixer``, ``AMASSDataset`` and
``amass_test`` against the plain reference (``bench_h100/reference/``), the
harness's run of the cell, the planted faults its comparison catches, and
the training graphs' node counter with its reader."""

import copy
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_h100 import corpus_amass, harness  # noqa: E402
from bench_h100.drivers import train_epochs_amass as drv  # noqa: E402
from bench_h100.reference import amass as ref_amass  # noqa: E402
from bench_h100.reference import mlpmixer  # noqa: E402
from bench_h100.reference import train as ref_train  # noqa: E402
from motionmixerconv_tpu_torch import profiling  # noqa: E402
from motionmixerconv_tpu_torch.cli._runner import (  # noqa: E402
    amass_test, build_mlp_mixer)
from motionmixerconv_tpu_torch.data import AMASSDataset  # noqa: E402
from motionmixerconv_tpu_torch.data.constants import (  # noqa: E402
    AMASS_DIM_USED, AMASS_SPLITS)
from motionmixerconv_tpu_torch.data.windows import WindowedCorpus  # noqa: E402
from motionmixerconv_tpu_torch.models import mixer_mlp  # noqa: E402
from motionmixerconv_tpu_torch.models.common import (  # noqa: E402
    Dropout, LayerNorm)
from motionmixerconv_tpu_torch.train import Trainer, make_optimizer  # noqa: E402
from motionmixerconv_tpu_torch.train.graphs import (  # noqa: E402
    StepGraph, graph_node_counts)

CELL = "amass_mlpmixer.train"
SEED = 2 ** 31 + 77  # beyond 32 signed bits, as a run's --seed may be
# two blocks at the published widths, batch 50, three recordings of 200 raw
# frames (66 windows each) a training dataset: seven steps need 350 windows,
# and the one epoch of the window passes the milestone
LAYOUT = {"source": "synthetic_amass", "datasets": [2, 1, 1],
          "subjects": [1, 1, 1], "recordings": [3, 2, 2], "framerate": 50}
SMALL = {"config": {"num_blocks": 2, "batch_size": 50, "batch_size_test": 50,
                    "milestones": [1], "corpus": LAYOUT,
                    "corpus_frames": 200}}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def config(**small):
    c = harness.resolve(harness.load_benchmark(), CELL).config
    c.update(SMALL["config"], **small)
    return c


def program_model(c, params):
    model = build_mlp_mixer(drv.runner_args(c, 0), c["pose_dim"],
                            c["input_n"], c["output_n"])
    model.load_state_dict({k: v.clone() for k, v in params.items()},
                          strict=True)
    return model


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    return corpus_amass.write(str(tmp_path_factory.mktemp("amass")), SEED,
                              LAYOUT, 200)


def test_the_corpus_layout_is_the_amass_releases():
    assert ref_amass.SPLITS == AMASS_SPLITS
    assert np.array_equal(ref_amass.DIM_USED, AMASS_DIM_USED)
    full = harness.resolve(harness.load_benchmark(), CELL).config
    dirs = corpus_amass.layout(full["corpus"])
    assert [sum(1 for d in dirs if d[0] == s) for s in range(3)] == [8, 4, 1]
    recs = [sum(d[3] * d[4] for d in dirs if d[0] == s) for s in range(3)]
    windows = full["corpus_frames"] // 2 - 35 + 1
    assert [r * windows for r in recs] == [93_200, 7_456, 7_456]


def test_forward_matches_the_port():
    c = config()
    p = mlpmixer.init_params(c, SEED, "cpu")
    model = program_model(c, p).eval()
    x = torch.randn(7, 10, 54, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, want = model(x), mlpmixer.forward(p, x, c)
    assert got.shape == want.shape == (7, 25, 54)
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def test_loss_gradient_and_six_adam_steps_match_the_port():
    """Six steps of the port's trainer, each a one-batch epoch with its
    dropout masks, against the reference's Adam from the same weights and
    dropout seed: every loss, the first gradient and the weights after."""
    c = config()
    p0 = mlpmixer.init_params(c, SEED, "cpu")
    model = program_model(c, p0)
    opt = make_optimizer(model.parameters(), lr=c["lr"],
                         weight_decay=c["weight_decay"],
                         milestones=c["milestones"], steps_per_epoch=100)
    trainer = Trainer(model, opt, loss_type="mpjpe", dim_used=AMASS_DIM_USED,
                      input_n=10, output_n=25, loss_scale=1000.0)
    g = torch.Generator().manual_seed(2)
    frames = (torch.randn(400, 156, generator=g).cumsum(0) * 0.01).numpy()
    bs, steps = 20, 6
    starts = np.arange(steps * bs).reshape(steps, bs) * 3
    torch.manual_seed(5)
    losses, opt1 = [], None
    for k in range(steps):
        part = WindowedCorpus(frames, starts[k], 35)
        losses.append(trainer.train_epoch(part, torch.as_tensor(frames), bs,
                                          seed=k, order=np.arange(bs)))
        if k == 0:
            opt1 = drv.te.first_gradient(opt.adam, model)
    t = torch.as_tensor(frames)
    dims = torch.as_tensor(AMASS_DIM_USED)
    batches = [(ref_train.windows(t, torch.as_tensor(s), 35, dims),
                torch.ones(bs)) for s in starts]
    torch.manual_seed(5)
    ref = mlpmixer.follow(mlpmixer.Task(c, 10, 25), p0, batches, c["lr"],
                          c["weight_decay"])
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-6)
    for name, param in model.named_parameters():
        scale = float(ref["opt1"][name].abs().max()) + 1e-12
        assert (opt1[name] - ref["opt1"][name]).abs().max() <= 1e-5 * scale
        scale = float(ref["params"][name].abs().max())
        assert (param.detach() - ref["params"][name]).abs().max() \
            <= 1e-6 * scale, name


def test_dataset_equals_the_reference(corpus_dir):
    """The port's npz walk, windows and FK frames against the reference's
    loader; the frames to 1e-6 of their largest, as both compose float32
    rotations down a tree of up to 21 joints (the reference as 4x4
    transforms, the port as rotation and translation)."""
    for split in range(3):
        ds = AMASSDataset(corpus_dir, 10, 25, 1, split=split)
        frames, starts = ref_amass.corpus(corpus_dir, split, 35, 1, "cpu")
        assert ds.frames.shape == frames.shape
        assert np.array_equal(ds.window_starts, starts)
        err = np.abs(ds.frames - frames).max()
        assert err <= 1e-6 * np.abs(frames).max(), (split, err)


def test_amass_test_equals_the_references(corpus_dir):
    c = config()
    p = mlpmixer.init_params(c, SEED, "cpu")
    model = program_model(c, p)
    trainer = Trainer(model, None, loss_type="mpjpe",
                      dim_used=AMASS_DIM_USED, input_n=10, output_n=25,
                      loss_scale=1000.0)
    test = AMASSDataset(corpus_dir, 10, 25, 1, split=2)
    got = amass_test(trainer, test, test.frames_on("cpu"), 50)
    state = SimpleNamespace(
        ctx=SimpleNamespace(config=c, device=torch.device("cpu")),
        check={"test": ref_amass.corpus(corpus_dir, 2, 35, 1, "cpu")})
    want = drv.reference_test(state, mlpmixer.Task(c, 10, 25), p, False)
    assert got == pytest.approx(float(want[0]), rel=1e-6)


def run(**small):
    return harness.run_cell(CELL, SEED, 0.01, False, torch.device("cpu"), 0.0,
                            overrides={"config": config(**small)})


def test_the_harness_runs_the_cell_small():
    """The driver's own comparison, small: correct, every compared number
    a fifth of its limit or less; the result names the CPU."""
    out = run()
    for name, value, limit in out["rows"]:
        assert value < limit / 5, (name, value)
    res = out["result"]
    assert res["correct"] and res["device"]["kind"] == "cpu"
    assert res["metrics"]["train_samples_per_s"]["value"] > 0


def _separate_se(monkeypatch):
    """A second SE layer for the channel branch, drawn at construction and
    outside the state_dict, as a port with two SE layers would hold."""
    init = mixer_mlp.MixerBlock.__init__

    def __init__(self, *args, **kw):
        init(self, *args, **kw)
        self.__dict__["se_channel"] = copy.deepcopy(self.se)
        mixer_mlp.torch_default_init_(self.__dict__["se_channel"])

    def forward(self, x):
        y = self.mlp_block_token_mixing(self.LN1(x).transpose(1, 2))
        x = x + self.se(y.transpose(1, 2))
        return x + self.se_channel(self.mlp_block_channel_mixing(self.LN2(x)))

    monkeypatch.setattr(mixer_mlp.MixerBlock, "__init__", __init__)
    monkeypatch.setattr(mixer_mlp.MixerBlock, "forward", forward)


def _layer_norm_eps(monkeypatch):
    monkeypatch.setattr(
        mixer_mlp, "layer_norm", lambda features, dtype=None:
        LayerNorm(features, eps=1e-6, compute_dtype=dtype))


def _dropout_offset(monkeypatch):
    """Each dropout mask drawn one draw later in the generator's stream."""
    whole = Dropout.forward

    def forward(self, x):
        if self.training:
            torch.rand(1, device=x.device)
        return whole(self, x)

    monkeypatch.setattr(Dropout, "forward", forward)


def _no_update(monkeypatch):
    """A step that leaves the state unchanged."""
    from motionmixerconv_tpu_torch.train import optim

    monkeypatch.setattr(optim.Optimizer, "update", lambda self: None)


def _schedule_never_moves(monkeypatch):
    from motionmixerconv_tpu_torch.train import optim

    monkeypatch.setattr(optim.Optimizer, "_schedule", lambda self: None)


def _half_of_each_test_batch(monkeypatch):
    whole = Trainer._stack_eval_batches

    def half(self, *args, **kw):
        starts, w, gids = whole(self, *args, **kw)
        w = w.clone()
        w[:, w.shape[1] // 2:] = 0.0  # the mean taken over the rest
        return starts, w, gids

    monkeypatch.setattr(Trainer, "_stack_eval_batches", half)


# each fault with the number that must catch it
FAULTS = {"separate_se": (_separate_se, None),
          "layer_norm_eps_1e-6": (_layer_norm_eps, None),
          "dropout_offset": (_dropout_offset, None),
          "state_unchanged": (_no_update, "change_median_gap"),
          "schedule_never_moves": (_schedule_never_moves,
                                   "late_change_median_gap"),
          "half_of_each_test_batch": (_half_of_each_test_batch, "test_gap")}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_planted_fault_is_caught(fault, monkeypatch):
    plant, number = FAULTS[fault]
    plant(monkeypatch)
    checks = run()["result"]["checks"]
    over = {k for k, v in checks.items() if v["value"] > v["limit"]}
    assert over and (number is None or number in over), checks


def test_step_graph_nodes_reader_finds_nothing_on_the_cpu(monkeypatch):
    """After a CPU run (eager steps, no graph captured) the reader reads
    None; and None where the program keeps no count (a parent's)."""
    profiling.reset()
    run_ = SimpleNamespace(config={}, counters={}, trace=None,
                           device_kind="cpu")
    read = harness.metric_module("step_graph_nodes.train").read
    run()
    assert profiling.graph_nodes() == {}
    assert read(run_) is None
    monkeypatch.delattr(profiling, "graph_nodes")
    assert read(run_) is None


def test_step_graph_nodes_reader_takes_the_training_graphs(monkeypatch):
    counts = {"train": {"graphs": 2, "nodes": 1250, "kernel": 1200,
                        "memset": 50},
              "eval": {"graphs": 3, "nodes": 300, "kernel": 300}}
    monkeypatch.setattr(profiling, "graph_nodes", lambda: counts)
    read = harness.metric_module("step_graph_nodes.train").read
    assert read(None) == 625.0
    counts.pop("train")
    assert read(None) is None


def test_a_step_graph_without_capture_records_nothing():
    profiling.reset()
    runner = StepGraph(lambda sums, b: sums.add_(b.sum()), torch.device("cpu"),
                       (), capture=False)
    out = runner.run(torch.ones(5, 3))
    assert float(out) == 15.0
    assert runner.graph is None and profiling.graph_nodes() == {}


def test_graph_counts_add_up_and_reset():
    profiling.reset()
    profiling.count_graph("train", {"nodes": 10, "kernel": 8, "memset": 2})
    profiling.count_graph("train", {"nodes": 12, "kernel": 12})
    profiling.count_graph("eval", {"nodes": 4, "kernel": 4})
    got = profiling.graph_nodes()
    assert got == {"train": {"graphs": 2, "nodes": 22, "kernel": 20,
                             "memset": 2},
                   "eval": {"graphs": 1, "nodes": 4, "kernel": 4}}
    got["train"]["nodes"] = 0  # a copy
    assert profiling.graph_nodes()["train"]["nodes"] == 22
    profiling.reset()
    assert profiling.graph_nodes() == {}
    assert profiling.snapshot() == {"untraced": {}, "traced": {}}


def test_graph_node_counts_reads_the_driver(monkeypatch):
    """The count through the driver's two queries, on a stand-in driver:
    the node count first, then the nodes and each one's type."""
    from motionmixerconv_tpu_torch.train import graphs

    types = [0, 0, 2, 1, 0, 5]
    calls = []

    class Driver:
        @staticmethod
        def cuGraphGetNodes(handle, nodes, n):
            calls.append(handle.value)
            if nodes is not None:
                assert n._obj.value == len(types)
                for i in range(len(types)):
                    nodes[i] = i + 1
            n._obj.value = len(types)
            return 0

        @staticmethod
        def cuGraphNodeGetType(node, kind):
            kind._obj.value = types[node - 1]
            return 0

    monkeypatch.setattr(graphs, "_driver", lambda: Driver)
    graph = SimpleNamespace(raw_cuda_graph=lambda: 4096)
    assert graph_node_counts(graph) == {"nodes": 6, "kernel": 3, "memset": 1,
                                        "memcpy": 1, "type_5": 1}
    assert calls == [4096, 4096]
    Driver.cuGraphGetNodes = staticmethod(lambda *a: 2)
    with pytest.raises(RuntimeError, match="cuGraphGetNodes"):
        graph_node_counts(graph)

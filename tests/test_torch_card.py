"""Tests of the port that need an NVIDIA card; each skips without one.

They import neither JAX nor the JAX package, so they also run where only
PyTorch is installed. On the card, from the repository's root:

    python -m pytest --noconftest -p no:cacheprovider -m card tests/test_torch_card.py
"""

import pytest
import torch

from motionmixerconv_tpu_torch.train import make_optimizer


@pytest.fixture
def card():
    """The card, or a skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _trajectory(opt, p, n):
    """``n`` steps of ``opt`` on gradients that depend on ``p``; the
    parameter after each."""
    out = []
    for i in range(n):
        p.grad = torch.sin(p.detach() * 3 + i)
        opt.step()
        out.append(p.detach().clone())
    return out


@pytest.mark.card
def test_optimizer_state_crosses_cpu_and_card(card, tmp_path):
    """On the card the optimizer is capturable with a device lr; a state it
    saved loads on the CPU and the CPU's on the card (through the file, as
    ``restore_checkpoint`` reads it), and both continue the trajectory
    across a milestone (float32 Adam in two formulas: rtol 1e-5)."""
    kw = dict(lr=1e-2, milestones=[1], gamma=0.5, steps_per_epoch=4)
    for src, dst in ((torch.device("cpu"), card), (card, torch.device("cpu"))):
        p = torch.nn.Parameter(torch.linspace(-1, 1, 7, device=src))
        opt = make_optimizer([p], **kw)
        assert opt.capturable == (src.type == "cuda")
        _trajectory(opt, p, 3)
        torch.save(opt.state_dict(), tmp_path / "opt.pt")
        start = p.detach().cpu().clone()
        want = [t.cpu() for t in _trajectory(opt, p, 4)]
        q = torch.nn.Parameter(start.to(dst))
        fresh = make_optimizer([q], **kw)
        fresh.load_state_dict(torch.load(tmp_path / "opt.pt",
                                         map_location="cpu", weights_only=True))
        assert (fresh.steps, fresh.lr) == (3, 1e-2)
        assert fresh.adam.param_groups[0]["capturable"] == (dst.type == "cuda")
        got = [t.cpu() for t in _trajectory(fresh, q, 4)]
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.card
def test_harmonic_kernels_count_their_launches_on_the_device(card):
    """B1's forward and dW kernels count their own launches on the device
    (``harmonic.device_launches``): the eager calls and every replay of a
    captured CUDA graph, which runs no wrapper; the capture launches
    nothing. The counts only grow, so the test reads differences."""
    from motionmixerconv_tpu_torch.ops import harmonic

    gen = torch.Generator().manual_seed(0)
    x, g = (torch.randn(64, 6, generator=gen).to(card),
            torch.randn(64, 8, generator=gen).to(card))
    w = (torch.randn(8, 48, generator=gen) * 0.1).to(card)
    bias = torch.zeros(8, device=card)
    freqs = 0.1 * 2.0 ** torch.arange(4, dtype=torch.float32, device=card)

    def step():
        harmonic.harmonic_dense_fwd(x, w, bias, freqs)
        harmonic.harmonic_dense_bwd(x, g, w, freqs, need_dx=False)

    def since(before):
        now = harmonic.device_launches()
        return now[0] - before[0], now[1] - before[1]

    start = harmonic.device_launches()
    step()
    assert since(start) == (1, 1)
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    assert since(start) == (2, 2)
    for _ in range(5):
        graph.replay()
    assert since(start) == (7, 7)


@pytest.mark.card
def test_step_graphs_take_turns_across_threads(card):
    """Two trainers' step graphs, each drawing dropout, on threads of one
    process (a study's --n_jobs 2 on one card), each thread on a stream of
    its own: the second warms up and captures while the first replays.
    Every call holds ``GRAPH_LOCK``, so neither raises (the card's one CUDA
    generator refuses a replay's offset advance while another thread
    captures) and both keep drawing masks."""
    import threading

    from motionmixerconv_tpu_torch.train.graphs import StepGraph

    drop = torch.nn.Dropout(0.5)
    captured = threading.Event()
    results, errors = {}, []

    def run(tag, n, wait):
        try:
            with torch.cuda.stream(torch.cuda.Stream(card)):
                x = torch.ones(1 << 16, device=card)
                graph = StepGraph(lambda sums, b: sums.add_(drop(x * b).sum()),
                                  card, (), capture=True)
                if wait is not None and not wait.wait(timeout=60):
                    raise TimeoutError("the other thread never captured")

                def after():
                    if graph.graph is not None:
                        captured.set()

                sums = graph.run(torch.ones(n, device=card), after=after)
                results[tag] = (float(sums), graph.graph is not None)
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=("first", 3000, None)),
               threading.Thread(target=run, args=("second", 50, captured))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for tag, n in (("first", 3000), ("second", 50)):
        total, replayed = results[tag]
        # each call sums 2^16 draws of 0 or 2: about 2^16 a call
        assert replayed and abs(total / n / (1 << 16) - 1) < 0.05, results


@pytest.mark.card
def test_a_captured_epoch_records_its_capture_and_launches(card):
    """The program's spans of a training epoch on the card: the step
    graph's eager warm-up calls, one capture and a launch for every step
    after it, each inside its step; the next epoch launches every step;
    under a recording profiler the spans go to the traced bucket."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from motionmixerconv_tpu_torch import profiling
    from motionmixerconv_tpu_torch.data import WindowedCorpus
    from motionmixerconv_tpu_torch.data.constants import H36M_DIM_USED_XYZ
    from motionmixerconv_tpu_torch.models import ConvMixer
    from motionmixerconv_tpu_torch.train import Trainer
    from motionmixerconv_tpu_torch.train.graphs import WARMUP_CALLS

    model = ConvMixer(num_blocks=1, dimPosIn=66, dimPosEmb=8, dimPosOut=66,
                      in_nTP=10, out_nTP=25, use_se=True,
                      encoder_n_harmonic_functions=4).to(card)
    trainer = Trainer(model, make_optimizer(model.parameters(), lr=1e-3),
                      loss_type="mpjpe", dim_used=H36M_DIM_USED_XYZ,
                      input_n=10, output_n=25, input_scale=1e-3)
    frames = np.random.RandomState(5).randn(300, 96).astype(np.float32) * 300
    steps, bs = 7, 16
    corpus = WindowedCorpus(frames, np.arange(steps * bs) * 2, 35)
    on_card = torch.from_numpy(frames).to(card)

    def counts(bucket):
        return {k: v["count"] for k, v in profiling.snapshot()[bucket].items()}

    profiling.reset()
    trainer.train_epoch(corpus, on_card, bs, seed=0)
    assert counts("untraced") == {
        "train.epoch": 1, "train.batches": 1, "train.step": steps,
        "train.eager": WARMUP_CALLS, "capture": 1,
        "train.launch": steps - WARMUP_CALLS - 1, "read": 1}
    profiling.reset()
    trainer.train_epoch(corpus, on_card, bs, seed=1)
    u = profiling.snapshot()["untraced"]
    assert counts("untraced") == {"train.epoch": 1, "train.batches": 1,
                                  "train.step": steps, "train.launch": steps,
                                  "read": 1}
    assert u["train.step"]["self_ns"] == (u["train.step"]["total_ns"]
                                          - u["train.launch"]["total_ns"])
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.train_epoch(corpus, on_card, bs, seed=2)
    assert counts("untraced") == {}
    assert counts("traced")["train.launch"] == steps
    names = {e.name for e in prof.events()}
    assert {"mmc.train.epoch", "mmc.train.step", "mmc.train.launch",
            "mmc.read"} <= names


CONV_BLOCK_CASES = [  # (N, T, E, taps, activation, backward too)
    (50, 10, 50, (1, 3), "mish", True),    # the flagship's training step
    (50, 10, 50, (3, 1), "mish", True),
    (256, 10, 50, (1, 3), "mish", False),  # its evaluation batch
    (256, 10, 50, (3, 1), "mish", False),
    (50, 10, 50, (5, 5), "mish", True),    # the AIS autoregressive model
    (50, 10, 50, (2, 2), "gelu", True),    # an even kernel
]


@pytest.mark.card
@pytest.mark.parametrize("n,t,e,k,act,backward", CONV_BLOCK_CASES)
def test_conv_block_kernels_against_their_plain_versions(card, n, t, e, k,
                                                         act, backward):
    """The single-channel ConvBlock's kernels against their plain versions
    in float64: within 1e-5 of each output's largest magnitude (float32
    taps, and the batch's weight and bias sums in another order than
    cuDNN's); three launches bit for bit; no plain version called."""
    from motionmixerconv_tpu_torch.ops import conv_block

    gen = torch.Generator().manual_seed(7)
    x, g = (torch.randn(n, 1, t, e, generator=gen).to(card) for _ in range(2))
    w = (torch.randn(1, 1, *k, generator=gen) / (k[0] * k[1]) ** 0.5).to(card)
    b = torch.full((1,), 0.1, device=card)
    counter = torch.empty(1, device=card, dtype=torch.int32)
    plain = conv_block.PLAIN_CALLS.value
    got = [[conv_block.conv_block_fwd(x, w, b, act, counter)]
           + (list(conv_block.conv_block_bwd(x, g, w, b, act, counter))
              if backward else []) for _ in range(3)]
    assert conv_block.PLAIN_CALLS.value == plain
    for other in got[1:]:
        assert all(torch.equal(u, v) for u, v in zip(got[0], other))
    d = [v.double() for v in (x, g, w, b)]
    want = [conv_block.conv_block_plain(d[0], d[2], d[3], act)]
    if backward:
        want += list(conv_block.conv_block_bwd_plain(*d, act))
    for u, v in zip(got[0], want):
        assert u.shape == v.shape and u.dtype == torch.float32
        assert float((u.double() - v).abs().max()) <= 1e-5 * float(
            v.abs().max())


@pytest.mark.card
def test_conv_block_counts_launches_and_replays_in_a_graph(card):
    """A one-channel ConvBlock on the card runs the two kernels and nothing
    else (no cuDNN convolution, no elementwise chain); their device
    counters see every eager call and every replay of a captured forward
    and backward, whose result is the eager one bit for bit."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from motionmixerconv_tpu_torch.models import ConvBlock
    from motionmixerconv_tpu_torch.ops import conv_block

    block = ConvBlock(1, (1, 3), activation="mish", regularization=0.1).to(card)
    gen = torch.Generator().manual_seed(8)
    x, g = (torch.randn(50, 1, 10, 50, generator=gen).to(card)
            for _ in range(2))
    xs = x.clone().requires_grad_()
    params = [block.conv.weight, block.conv.bias]
    block.eval()  # no dropout: the replays repeat the eager step

    def step():
        a = block(xs)
        return (a, *torch.autograd.grad(a, [xs, *params], g))

    # every call on the capture's stream: the leaves' gradient nodes keep
    # the stream of their first backward, which a capture may not wait on
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        step()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eager = step()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False)]
        assert len(names) == 2 and all("conv_block_" in n for n in names), \
            names
        start = conv_block.device_launches()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            captured = step()
        now = conv_block.device_launches()
        assert (now[0] - start[0], now[1] - start[1]) == (0, 0)
        for _ in range(5):
            graph.replay()
        now = conv_block.device_launches()
        assert (now[0] - start[0], now[1] - start[1]) == (5, 5)
    assert all(torch.equal(u, v) for u, v in zip(captured, eager))


@pytest.mark.card
def test_conv_block_refuses_a_plane_too_large_for_shared_memory(card):
    """A one-channel float32 ConvBlock on the card whose planes exceed a
    block's shared memory raises NotImplementedError, forward or backward,
    and never falls back to its plain version or to the modules."""
    from motionmixerconv_tpu_torch.models import ConvBlock
    from motionmixerconv_tpu_torch.ops import conv_block

    block = ConvBlock(1, (1, 3), activation="mish").to(card)
    plain = conv_block.PLAIN_CALLS.value
    with pytest.raises(NotImplementedError, match="shared memory"):
        block(torch.zeros(2, 1, 300, 300, device=card))
    # a plane whose forward fits and whose backward (x and dz) does not
    x = torch.zeros(2, 1, 200, 200, device=card, requires_grad=True)
    a = block(x)
    with pytest.raises(NotImplementedError, match="shared memory"):
        a.sum().backward()
    assert conv_block.PLAIN_CALLS.value == plain


@pytest.mark.card
def test_step_graph_captures_with_the_collector_off(card):
    """A step graph's capture runs with Python's cyclic collector off, so
    no unreachable earlier graph is destroyed inside it (which invalidates
    the capture), and turns it on again; an earlier graph left in a
    reference cycle does not disturb the next capture."""
    import gc

    from motionmixerconv_tpu_torch.train.graphs import WARMUP_CALLS, StepGraph

    seen = []
    x = torch.ones(8, device=card)

    def body(sums, b):
        seen.append(gc.isenabled())
        sums.add_((x * b).sum())

    n = WARMUP_CALLS + 2
    old = StepGraph(body, card, (), capture=True)
    old.run(torch.ones(n, device=card))
    cycle = [old]
    cycle.append(cycle)
    del old, cycle
    seen.clear()
    sums = StepGraph(body, card, (), capture=True).run(
        torch.ones(n, device=card))
    assert seen == [True] * WARMUP_CALLS + [False]  # warm-ups, the capture
    assert gc.isenabled()
    assert float(sums) == 8 * n


@pytest.mark.card
def test_a_flagship_step_graph_records_its_nodes(card):
    """The nodes a flagship training step's capture records, against the
    device operations the profiler sees in one replay of its graph: every
    node is one of them, a kernel node a kernel, the memset node a
    ``Memset``, the memcpy node a copy kernel (``memcpy32_post``); the two
    operations left over are the int64 fills of the dropout generator's
    seed and offset that ``replay()`` launches before the graph (its
    generator prologue), which are not nodes."""
    from types import SimpleNamespace

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from motionmixerconv_tpu_torch import profiling
    from motionmixerconv_tpu_torch.cli._runner import build_conv_mixer
    from motionmixerconv_tpu_torch.data import WindowedCorpus
    from motionmixerconv_tpu_torch.data.constants import H36M_DIM_USED_XYZ
    from motionmixerconv_tpu_torch.train import Trainer
    from motionmixerconv_tpu_torch.train.graphs import WARMUP_CALLS

    args = SimpleNamespace(num_blocks=4, hidden_dim=50, activation="mish",
                           regularization=0.1, r_se=8,
                           encoder_n_harmonic_functions=64,
                           encoder_omega0=0.1, fused_encoder=True)
    model = build_conv_mixer(args, 66, 66, 10, 25,
                             generator=torch.Generator().manual_seed(0))
    model = model.to(card)
    trainer = Trainer(model, make_optimizer(model.parameters(), lr=1e-3),
                      loss_type="mpjpe", dim_used=H36M_DIM_USED_XYZ,
                      input_n=10, output_n=25, input_scale=1e-3)
    frames = np.random.RandomState(5).randn(2000, 96).astype(np.float32) * 300
    bs, steps = 50, WARMUP_CALLS + 2
    corpus = WindowedCorpus(frames, np.arange(steps * bs) * 3, 35)
    on_card = torch.from_numpy(frames).to(card)
    profiling.reset()
    trainer.train_epoch(corpus, on_card, bs, seed=0)
    nodes = profiling.graph_nodes()["train"]
    runner, = (r for k, r in trainer._graphs.items() if k[0] == "train")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        runner.graph.replay()
        torch.cuda.synchronize()
    ops = [e.name() for e in prof.profiler.kineto_results.events()
           if str(e.device_type()).endswith("CUDA")
           and not e.is_user_annotation()]
    memsets = sum(n.startswith("Memset") for n in ops)
    memcpys = sum("memcpy" in n.lower() for n in ops)
    fills = sum("FillFunctor<long>" in n for n in ops)
    print(f"step graph nodes {nodes}; one replay: {len(ops)} device "
          f"operations, {memsets} memsets, {memcpys} copies, {fills} int64 "
          "fills")
    assert nodes["graphs"] == 1
    assert nodes.get("memset", 0) == memsets
    assert nodes.get("memcpy", 0) == memcpys
    assert nodes["nodes"] == nodes["kernel"] + memsets + memcpys
    prologue = len(ops) - nodes["nodes"]
    assert prologue == 2 and fills >= prologue
    profiling.reset()
    trainer.train_epoch(corpus, on_card, bs, seed=1)  # replays alone
    assert profiling.graph_nodes() == {}


@pytest.mark.card
def test_tf32_in_the_amass_cells_program_is_caught(card, monkeypatch):
    """The AMASS cell's comparison on the card, at its published widths on
    a corpus of a few recordings: the sound program reads correct; with
    TF32 allowed in the program's matmuls (the reference keeps it off) it
    does not."""
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from bench_h100 import harness

    small = {"corpus": {"source": "synthetic_amass", "datasets": [1, 1, 1],
                        "subjects": [1, 1, 1], "recordings": [4, 1, 2],
                        "framerate": 50}}

    def run():
        return harness.run_cell("amass_mlpmixer.train", 2 ** 31 + 77, 0.01,
                                False, card, 0.0,
                                overrides={"config": small})["result"]

    assert run()["correct"]
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    res = run()
    assert not res["correct"], res["checks"]

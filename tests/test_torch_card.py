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


# ---------------------------------------------------------------- Adam kernel

ADAM_CELLS = ("flagship", "autoreg", "amass")  # 52, 68 and 78 tensors
ADAM_STEPS = 100   # across the milestone at step 50
ADAM_SCHEDULE = dict(lr=1e-3, milestones=[2], steps_per_epoch=25)
ADAM_ULPS = 0      # from torch's capturable Adam on the card, in ulps of
                   # each tensor's largest magnitude: the same float32
                   # operations in the same order, contracted alike (on the
                   # H100 with torch 2.11 all three lists agree bit for bit)


def _cell_params(cell, device, seed=0):
    """The parameters of a benchmark cell's model, built from ``seed``."""
    from types import SimpleNamespace

    from motionmixerconv_tpu_torch.cli._runner import build_conv_mixer
    from motionmixerconv_tpu_torch.models import ConvMixer, MlpMixer

    gen = torch.Generator().manual_seed(seed)
    if cell == "flagship":
        args = SimpleNamespace(num_blocks=4, hidden_dim=50, activation="mish",
                               regularization=0.1, r_se=8,
                               encoder_n_harmonic_functions=64,
                               encoder_omega0=0.1, fused_encoder=True)
        model = build_conv_mixer(args, 66, 66, 10, 25, generator=gen)
    elif cell == "autoreg":
        model = ConvMixer(num_blocks=4, dimPosIn=66, dimPosEmb=192,
                          dimPosOut=66, in_nTP=10, out_nTP=5, conv_nChan=8,
                          conv1_kernel_shape=(5, 5), activation="mish",
                          regularization=-1.0, use_se=True, r_se=8,
                          encoder_n_harmonic_functions=0, generator=gen)
    else:
        model = MlpMixer(num_classes=54, num_blocks=5, hidden_dim=128,
                         tokens_mlp_dim=20, channels_mlp_dim=128, seq_len=10,
                         pred_len=25, activation="gelu", regularization=0.1,
                         input_size=54, r_se=8, use_se=True, generator=gen)
    return [torch.nn.Parameter(p.detach().to(device))
            for p in model.parameters()]


def _torch_route(opt):
    """``opt`` stepping through ``torch.optim.Adam(capturable=True)``'s
    multi-tensor route, the card's route before the kernel."""
    for group in opt.adam.param_groups:
        group["foreach"] = True
    opt._kernel_update = opt.adam.step
    return opt


def _max_ulps(a, b) -> float:
    """The largest difference of ``a`` from ``b`` in ulps of ``b``'s
    largest magnitude (an element's own ulp is no unit near 0, where an
    update's rounding is that of a larger number)."""
    a, b = a.detach(), b.detach()
    top = b.abs().max()
    ulp = torch.nextafter(top, torch.full_like(top, float("inf"))) - top
    return float((a - b).abs().max() / ulp)


def _adam_steps(opts_and_params, card, steps, seed=1):
    """``steps`` steps of each (optimizer, parameters) on one sequence of
    gradients; the last parameter never gets one."""
    gen = torch.Generator(card).manual_seed(seed)
    for i in range(steps):
        grads = [torch.randn(p.shape, device=card, generator=gen)
                 * (1 + i % 3) for p in opts_and_params[0][1][:-1]]
        for opt, ps in opts_and_params:
            for p, g in zip(ps, grads):
                p.grad = g.clone()
            ps[-1].grad = None
            opt.step()


@pytest.mark.card
@pytest.mark.parametrize("cell", ADAM_CELLS)
def test_adam_kernel_follows_torch_capturable_adam(card, cell):
    """The kernel (``Optimizer.update`` on the card) against
    ``torch.optim.Adam(capturable=True)`` at a cell's parameter list over
    100 steps across a milestone, on one sequence of gradients: every
    parameter and moment within ``ADAM_ULPS``, the counts equal, no state
    for the parameter without a gradient; one launch a step; a second run
    bit-identical."""
    from motionmixerconv_tpu_torch.ops import adam

    runs = [(make_optimizer(ps, **ADAM_SCHEDULE), ps)
            for ps in (_cell_params(cell, card), _cell_params(cell, card))]
    ref_ps = _cell_params(cell, card)
    ref = _torch_route(make_optimizer(ref_ps, **ADAM_SCHEDULE))
    before = adam.device_launches()
    _adam_steps([*runs, (ref, ref_ps)], card, ADAM_STEPS)
    assert adam.device_launches() - before == 2 * ADAM_STEPS
    (opt, ps), (opt2, ps2) = runs
    assert ps[-1] not in opt.adam.state and ref_ps[-1] not in ref.adam.state
    worst = {"param": 0, "exp_avg": 0, "exp_avg_sq": 0}
    for p, p2, q in zip(ps[:-1], ps2[:-1], ref_ps[:-1]):
        st, st2, rt = opt.adam.state[p], opt2.adam.state[p2], ref.adam.state[q]
        assert float(st["step"]) == float(rt["step"]) == ADAM_STEPS
        worst["param"] = max(worst["param"], _max_ulps(p, q))
        assert torch.equal(p, p2)
        for key in ("exp_avg", "exp_avg_sq"):
            worst[key] = max(worst[key], _max_ulps(st[key], rt[key]))
            assert torch.equal(st[key], st2[key])
    print(f"{cell}: {len(ps)} tensors, ulps from torch's capturable Adam "
          f"{worst}")
    assert max(worst.values()) <= ADAM_ULPS, worst


@pytest.mark.card
def test_a_captured_adam_step_replays_as_eager(card):
    """A captured ``update`` replayed over steps that cross a milestone (the
    lr tensor written between replays) equals eager steps bit for bit; the
    device counts every replay and the capture runs nothing."""
    from motionmixerconv_tpu_torch.ops import adam

    kw = dict(lr=1e-3, milestones=[1], steps_per_epoch=4)
    eager_ps, graph_ps = _cell_params("amass", card), _cell_params("amass",
                                                                   card)
    eager, graph_opt = make_optimizer(eager_ps, **kw), make_optimizer(
        graph_ps, **kw)
    gen = torch.Generator(card).manual_seed(3)
    grads = [[torch.randn(p.shape, device=card, generator=gen)
              for p in eager_ps] for _ in range(9)]
    for p, q, g in zip(eager_ps, graph_ps, grads[0]):
        p.grad, q.grad = g.clone(), g.clone()
    eager.step()
    graph_opt.step()  # the state exists before the capture
    graph = torch.cuda.CUDAGraph()
    start = adam.device_launches()
    with torch.cuda.graph(graph):
        graph_opt.update()
    assert adam.device_launches() == start
    for i in range(1, 9):
        for p, q, g in zip(eager_ps, graph_ps, grads[i]):
            p.grad = g.clone()
            q.grad.copy_(g)
        eager.step()
        graph.replay()
        graph_opt.advance()
    assert adam.device_launches() - start == 2 * 8
    assert graph_opt.lr == eager.lr < 1e-3
    for p, q in zip(eager_ps, graph_ps):
        assert torch.equal(p, q)
        for key in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(eager.adam.state[p][key],
                               graph_opt.adam.state[q][key])


@pytest.mark.card
def test_flagship_step_graph_takes_one_adam_launch(card, monkeypatch):
    """A flagship training epoch on the card never calls
    ``torch.optim.Adam.step`` and launches the kernel once a step; its
    captured step graph holds about 2N + 20 fewer nodes (N = 52 tensors)
    than the same step through torch's capturable Adam."""
    import numpy as np

    from motionmixerconv_tpu_torch import profiling
    from motionmixerconv_tpu_torch.cli._runner import build_conv_mixer
    from motionmixerconv_tpu_torch.data import WindowedCorpus
    from motionmixerconv_tpu_torch.data.constants import H36M_DIM_USED_XYZ
    from motionmixerconv_tpu_torch.ops import adam
    from motionmixerconv_tpu_torch.train import Trainer
    from types import SimpleNamespace

    args = SimpleNamespace(num_blocks=4, hidden_dim=50, activation="mish",
                           regularization=0.1, r_se=8,
                           encoder_n_harmonic_functions=64,
                           encoder_omega0=0.1, fused_encoder=True)
    frames = np.random.RandomState(5).randn(2000, 96).astype(np.float32) * 300
    bs, steps = 50, 6
    corpus = WindowedCorpus(frames, np.arange(steps * bs) * 3, 35)
    on_card = torch.from_numpy(frames).to(card)

    def nodes(route):
        model = build_conv_mixer(args, 66, 66, 10, 25,
                                 generator=torch.Generator().manual_seed(0))
        opt = route(make_optimizer(model.to(card).parameters(), lr=1e-3))
        trainer = Trainer(model, opt, loss_type="mpjpe",
                          dim_used=H36M_DIM_USED_XYZ, input_n=10,
                          output_n=25, input_scale=1e-3)
        profiling.reset()
        trainer.train_epoch(corpus, on_card, bs, seed=0)
        return profiling.graph_nodes()["train"]["nodes"], len(opt.params)

    real_step = torch.optim.Adam.step
    monkeypatch.setattr(torch.optim.Adam, "step", lambda *a: pytest.fail(
        "a training step on the card called torch.optim.Adam.step"))
    before = adam.device_launches()
    with_kernel, n = nodes(lambda opt: opt)
    assert adam.device_launches() - before == steps
    monkeypatch.setattr(torch.optim.Adam, "step", real_step)
    with_torch, _ = nodes(_torch_route)
    print(f"flagship step graph: {with_kernel} nodes with the kernel, "
          f"{with_torch} through torch's Adam, {n} tensors")
    assert n == 52
    assert 2 * n + 10 <= with_torch - with_kernel <= 2 * n + 40


CONV_BLOCK_MC_CASES = [  # (N, C, T, E, taps, activation)
    (50, 8, 10, 192, (5, 5), "mish"),   # the autoregressive training step
    (50, 8, 10, 192, (9, 29), "mish"),  # the conv study's widest kernel
    (50, 8, 10, 192, (1, 1), "mish"),
    (50, 4, 10, 192, (9, 9), "gelu"),   # the autoregressive study's
    (50, 24, 10, 192, (5, 5), "mish"),  # the most channels whose tiles fit
    (7, 3, 10, 37, (3, 7), "gelu"),     # a slice past the plane's edge
    (3, 2, 17, 5, (5, 3), "mish"),      # two bands of rows, a narrow plane
]


@pytest.mark.card
@pytest.mark.parametrize("n,c,t,e,k,act", CONV_BLOCK_MC_CASES)
def test_conv_block_mc_kernels_against_float64_and_cudnn(card, n, c, t, e, k,
                                                         act):
    """The multi-channel ConvBlock's kernels (a, act'(z), dx, dw, db)
    against float64, within 1e-5 of each output's largest magnitude
    (float32 sums of C kh kw terms, and of the batch's positions for dw and
    db, in another order), as near as cuDNN's float32 route with TF32 off
    (within 1e-5 too); three launches bit for bit; no plain version
    called."""
    import torch.nn.functional as F

    from motionmixerconv_tpu_torch.ops import conv_block_mc

    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(9)
    x, g = (torch.randn(n, c, t, e, generator=gen).to(card) for _ in range(2))
    w = (torch.randn(c, c, *k, generator=gen) / (c * k[0] * k[1]) ** 0.5
         ).to(card)
    b = (torch.randn(c, generator=gen) * 0.1).to(card)
    plain = conv_block_mc.PLAIN_CALLS.value
    got = []
    for _ in range(3):
        a, da = conv_block_mc.conv_block_mc_fwd(x, w, b, act, with_grad=True)
        got.append([a, da, *conv_block_mc.conv_block_mc_bwd(x, da, g, w, b,
                                                             act)])
    assert conv_block_mc.PLAIN_CALLS.value == plain
    for other in got[1:]:
        assert all(torch.equal(u, v) for u, v in zip(got[0], other))
    d = [v.double().requires_grad_() for v in (x, w, b)]
    z = F.conv2d(d[0], d[1], d[2], padding="same")
    z_leaf = z.detach().requires_grad_()
    a64 = conv_block_mc.get_activation(act)(z_leaf)
    da64, = torch.autograd.grad(a64.sum(), z_leaf)
    want = [a64.detach(), da64, *conv_block_mc.conv_block_mc_bwd_plain(
        d[0].detach(), g.double(), d[1].detach(), d[2].detach(), act)]
    cudnn = [conv_block_mc.conv_block_mc_plain(x, w, b, act), None,
             *conv_block_mc.conv_block_mc_bwd_plain(x, g, w, b, act)]
    for name, u, v, lib in zip(("a", "da", "dx", "dw", "db"), got[0], want,
                               cudnn):
        scale = float(v.abs().max())
        assert u.shape == v.shape and u.dtype == torch.float32
        assert float((u.double() - v).abs().max()) <= 1e-5 * scale, name
        if lib is not None:
            assert float((lib.double() - v).abs().max()) <= 1e-5 * scale


@pytest.mark.card
def test_conv_block_mc_counts_launches_and_replays_in_a_graph(card):
    """An eight-channel (5,5) ConvBlock on the card runs the forward kernel
    and the two backward kernels and nothing else (no cuDNN convolution, no
    elementwise chain); the device counters see every eager call and every
    replay of a captured forward and backward, whose result is the eager
    one bit for bit; the wrapper's tiles fit as the library counts them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from motionmixerconv_tpu_torch.models import ConvBlock
    from motionmixerconv_tpu_torch.ops import _build, conv_block_mc

    lib = _build.load_library()
    p = conv_block_mc.plan(8, 10, 192, 5, 5)
    for smem, backward in ((p.smem_fwd, 0), (p.smem_bwd, 1)):
        assert lib.mmc_conv_block_mc_smem_bytes(8, 10, 192, 5, 5, p.bt, p.be,
                                                backward) == smem
    block = ConvBlock(8, (5, 5), activation="mish").to(card)
    gen = torch.Generator().manual_seed(10)
    x, g = (torch.randn(50, 8, 10, 192, generator=gen).to(card)
            for _ in range(2))
    xs = x.clone().requires_grad_()
    params = [block.conv.weight, block.conv.bias]

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
        assert len(names) == 3 and all("conv_block_mc_" in n
                                       for n in names), names
        start = conv_block_mc.device_launches()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            captured = step()
        now = conv_block_mc.device_launches()
        assert (now[0] - start[0], now[1] - start[1]) == (0, 0)
        for _ in range(5):
            graph.replay()
        now = conv_block_mc.device_launches()
        assert (now[0] - start[0], now[1] - start[1]) == (5, 5)
    assert all(torch.equal(u, v) for u, v in zip(captured, eager))


@pytest.mark.card
def test_a_closed_loop_step_through_the_kernels_matches_the_modules(
        card, monkeypatch):
    """One closed-loop training step of the autoregressive ConvMixer (8
    channels, (5,5), BatchNorm, 5 chained forwards) through the kernels
    against the same step through cuDNN's modules (TF32 off): the loss
    within 1e-5 relative, each parameter's gradient within 1e-4 of the
    larger of its norm and the median leaf's, as the benchmark's
    ``leaf_gap`` takes it (float32 sums in other orders, through five
    chained rollouts and BatchNorm), leaving out, as the benchmark does,
    leaves whose gradient is under a thousandth of the median leaf's
    (``encoder.channelUpscaling.bias`` reaches the loss only through
    LayerNorms over the width it shifts uniformly: its gradient is
    rounding); 40 backward calls of the kernels."""
    import copy
    from types import SimpleNamespace

    import numpy as np

    from motionmixerconv_tpu_torch.cli._runner import build_conv_mixer
    from motionmixerconv_tpu_torch.data.constants import H36M_DIM_USED_XYZ
    from motionmixerconv_tpu_torch.ops import conv_block_mc
    from motionmixerconv_tpu_torch.train import AutoregressiveTrainer

    torch.backends.cudnn.allow_tf32 = False
    args = SimpleNamespace(num_blocks=4, hidden_dim=192, conv_nChan=8,
                           conv1_kernel_shape=(5, 5), activation="mish",
                           regularization=-1.0, r_se=8,
                           encoder_n_harmonic_functions=0,
                           encoder_omega0=0.0, fused_encoder=False)
    model = build_conv_mixer(args, 66, 66, 10, 5,
                             generator=torch.Generator().manual_seed(11))
    frames = torch.from_numpy(np.random.RandomState(11).randn(
        3000, 96).astype(np.float32) * 300).to(card)
    starts = torch.arange(50, device=card) * 40
    w = torch.ones(50, device=card)

    def step():
        m = copy.deepcopy(model).to(card)
        trainer = AutoregressiveTrainer(
            m, make_optimizer(m.parameters(), lr=1e-3), loss_type="mpjpe",
            dim_used=H36M_DIM_USED_XYZ, input_n=10, output_n=25,
            input_n_model=10, output_n_model=5, step_window=5)
        loss = trainer._train_loss(frames, starts, w, teacher_forcing=False)
        names, leaves = zip(*m.named_parameters())
        grads = torch.autograd.grad(loss, leaves)
        return float(loss.detach()), dict(zip(names, grads))

    before = conv_block_mc.device_launches()
    loss, grads = step()
    calls = conv_block_mc.device_launches()[1] - before[1]
    monkeypatch.setattr(conv_block_mc, "takes", lambda x, weight: False)
    loss_m, grads_m = step()
    norms = {k: float(v.norm()) for k, v in grads_m.items()}
    median = float(np.median(list(norms.values())))
    gaps = {k: float((grads[k] - v).norm()) / max(norms[k], median)
            for k, v in grads_m.items() if norms[k] >= 1e-3 * median}
    worst = max(gaps, key=gaps.get)
    print(f"closed-loop step: loss {loss} against {loss_m}, worst leaf "
          f"{worst} {gaps[worst]:.3e}, {calls} backward calls")
    assert calls == 40
    assert abs(loss - loss_m) <= 1e-5 * abs(loss_m)
    assert gaps[worst] <= 1e-4, worst

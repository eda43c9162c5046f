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

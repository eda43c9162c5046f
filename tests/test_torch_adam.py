"""The Adam kernel's wrapper on the CPU (``ops/adam.py``): its plain version
against ``torch.optim.Adam``, its checks, the optimizer's routing, the
state it keeps in torch's format through both checkpoint kinds, and the
benchmark's reader of its launches. The kernel itself runs only on the
card (``tests/test_torch_card.py``).

The card's route is taken here on CPU tensors by declaring the CPU
capturable (``train/optim.py`` ``_capturable``, and torch's list of
devices a capturable Adam may use): ``update`` then creates torch's
capturable state and calls ``adam_update``, which serves CPU tensors by
its plain version."""

import sys

import pytest
import torch
import torch.optim.adam as torch_adam

from motionmixerconv_tpu_torch import profiling
from motionmixerconv_tpu_torch.models import MlpMixer
from motionmixerconv_tpu_torch.ops import adam
from motionmixerconv_tpu_torch.train import make_optimizer, optim
from motionmixerconv_tpu_torch.train.state import (restore_checkpoint,
                                                   save_checkpoint,
                                                   save_jax_checkpoint)

SHAPES = [(7, 5), (3,), (1,), (130,), (2, 4, 3)]
NO_GRAD = 2      # the parameter that never gets a gradient
STEPS = 24       # across the milestone at step 10
SCHEDULE = dict(lr=1e-2, milestones=[1], gamma=0.5, steps_per_epoch=10)
EPS32 = torch.finfo(torch.float32).eps


@pytest.fixture
def allow_cpu_capturable(monkeypatch):
    """torch's capturable Adam on CPU tensors (it checks a device list)."""
    listed = torch_adam._get_capturable_supported_devices
    monkeypatch.setattr(torch_adam, "_get_capturable_supported_devices",
                        lambda *a, **k: [*listed(*a, **k), "cpu"])


@pytest.fixture
def card_route(allow_cpu_capturable, monkeypatch):
    """``Optimizer`` takes the card's route on the CPU."""
    monkeypatch.setattr(optim, "_capturable", lambda device: True)


def _params(seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.nn.Parameter(torch.randn(s, generator=g)) for s in SHAPES]


def _grads(ps, i):
    """Step ``i``'s gradients, the same whatever the parameters hold (so two
    optimizers see one sequence); none for ``NO_GRAD``."""
    for j, p in enumerate(ps):
        ramp = torch.arange(p.numel(), dtype=torch.float32).reshape(p.shape)
        p.grad = None if j == NO_GRAD else torch.sin(ramp * 0.37 + i * 1.3 + j)


def _run(opt, ps, steps=STEPS, start=0, step=None):
    for i in range(start, start + steps):
        _grads(ps, i)
        (step or opt.step)()
        if step is not None:
            opt.advance()
    return [p.detach().clone() for p in ps]


def _torch_run(wd, capturable, ps):
    """The same schedule through ``torch.optim.Adam`` (multi-tensor)."""
    opt = make_optimizer(ps, weight_decay=wd, **SCHEDULE)
    if capturable:  # rebuilt as the card builds it, with a device lr
        opt.capturable = True
        opt._lr_t = torch.tensor(opt.lr)
        opt.adam = torch.optim.Adam(ps, lr=opt._lr_t, weight_decay=wd,
                                    capturable=True, foreach=True)
    else:
        for group in opt.adam.param_groups:
            group["foreach"] = True
    return _run(opt, ps, step=opt.adam.step), opt


@pytest.mark.parametrize("wd", [0.0, 1e-5])
@pytest.mark.parametrize("capturable", [True, False],
                         ids=["capturable", "foreach"])
def test_plain_version_follows_torch_adam(wd, capturable,
                                          allow_cpu_capturable):
    """``adam_update_plain`` over 24 steps, across a milestone, with a
    parameter that never has a gradient: bit for bit torch's capturable
    multi-tensor Adam (the kernel's formula); against torch's plain
    multi-tensor Adam, whose bias corrections are Python floats, the same
    moments and parameters within a few float32 ulps of their largest."""
    ps, ref_ps = _params(), _params()
    want, ref = _torch_run(wd, capturable, ref_ps)
    lr = torch.tensor(SCHEDULE["lr"])
    state = {}
    calls = adam.PLAIN_CALLS.value
    for i in range(STEPS):
        if i == SCHEDULE["milestones"][0] * SCHEDULE["steps_per_epoch"]:
            lr.fill_(SCHEDULE["lr"] * SCHEDULE["gamma"])
        _grads(ps, i)
        live = [p for p in ps if p.grad is not None]
        for p in live:
            state.setdefault(p, (torch.zeros(()), torch.zeros_like(p),
                                 torch.zeros_like(p)))
        adam.adam_update(live, [p.grad for p in live],
                         [state[p][1] for p in live],
                         [state[p][2] for p in live],
                         [state[p][0] for p in live], lr, 0.9, 0.999, 1e-8,
                         wd, None)
    assert adam.PLAIN_CALLS.value == calls + STEPS
    got = [p.detach() for p in ps]
    tol = 0.0 if capturable else 8 * EPS32
    for j, (a, b, q) in enumerate(zip(got, want, ref_ps)):
        atol = tol * float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=0, atol=atol)
        if j == NO_GRAD:
            assert q not in ref.adam.state and ps[j] not in state
            continue
        st = ref.adam.state[q]
        assert float(st["step"]) == float(state[ps[j]][0]) == STEPS
        for k, key in ((1, "exp_avg"), (2, "exp_avg_sq")):
            torch.testing.assert_close(state[ps[j]][k], st[key], rtol=0,
                                       atol=0)


@pytest.mark.parametrize("change,why", [
    (lambda p, g: (p.double(), g.double()), "not float32"),
    (lambda p, g: (p, g.to_sparse()), "sparse"),
    (lambda p, g: (p.t(), g.t()), "not contiguous"),
    (lambda p, g: (p, g[:2]), "a gradient of shape"),
    (lambda p, g: (p, g.to("meta")), "its gradient on meta"),
])
def test_refusal_names_what_the_kernel_does_not_take(change, why):
    p, g = torch.ones(3, 4), torch.ones(3, 4)
    assert adam.refusal(p, g) is None
    assert why in adam.refusal(*change(p, g))


def test_adam_update_checks_its_lists_and_device():
    """Lists of one length; empty lists do nothing; a device with no kernel
    (neither CPU nor CUDA) raises."""
    p = [torch.ones(3)]
    with pytest.raises(ValueError, match="one length"):
        adam.adam_update(p, p, p, [], [torch.zeros(())], 1e-3, 0.9, 0.999,
                         1e-8, 0.0, None)
    calls = adam.PLAIN_CALLS.value
    adam.adam_update([], [], [], [], [], 1e-3, 0.9, 0.999, 1e-8, 0.0, None)
    assert adam.PLAIN_CALLS.value == calls
    meta = [torch.ones(3, device="meta")]
    with pytest.raises(RuntimeError, match="no kernel for meta"):
        adam.adam_update(meta, meta, meta, meta,
                         [torch.zeros((), device="meta")], 1e-3, 0.9, 0.999,
                         1e-8, 0.0, None)


@pytest.mark.parametrize("bad,match", [
    ({"lr": 1e-3}, "lr must be one torch.float32"),
    ({"counter": None}, "counter must be one torch.int32"),
    ({"counter": torch.zeros(1)}, "counter must be one torch.int32"),
    ({"steps": [torch.zeros((), dtype=torch.float64)]}, "its step"),
    ({"exp_avgs": [torch.zeros(4)]}, "its exp_avg is not"),
])
def test_the_kernels_checks_refuse_before_a_launch(bad, match):
    """What ``adam_update`` checks on CUDA tensors before it loads the
    library, run here on CPU tensors."""
    args = {"params": [torch.ones(3)], "grads": [torch.ones(3)],
            "exp_avgs": [torch.zeros(3)], "exp_avg_sqs": [torch.zeros(3)],
            "steps": [torch.zeros(())], "lr": torch.tensor(1e-3),
            "counter": torch.zeros(1, dtype=torch.int32)}
    args.update(bad)
    err = ValueError if set(bad) <= {"lr", "counter"} else NotImplementedError
    with pytest.raises(err, match=match):
        adam._check(*args.values())


def test_cpu_optimizer_steps_torch_adam(monkeypatch):
    """On the CPU ``update`` is ``torch.optim.Adam.step``; the kernel's
    wrapper is never called."""
    monkeypatch.setattr(adam, "adam_update", lambda *a, **k: pytest.fail(
        "the CPU's step called adam_update"))
    ps = _params()
    opt = make_optimizer(ps, **SCHEDULE)
    assert not opt.capturable and opt._counter is None
    seen = []
    real = torch.optim.Adam.step
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, *a: seen.append(1) or real(self, *a))
    _run(opt, ps, steps=3)
    assert len(seen) == 3


def test_card_route_calls_the_kernel_with_torchs_capturable_state(
        card_route, monkeypatch):
    """The card's route: one ``adam_update`` a step, never
    ``torch.optim.Adam.step``; the state torch's capturable Adam would
    create (a float32 0-dim step on the parameter's device, moments like the
    parameter), none for a parameter without a gradient; the trajectory
    torch's capturable Adam's bit for bit, across the milestone."""
    real_step = torch.optim.Adam.step
    monkeypatch.setattr(torch.optim.Adam, "step", lambda *a: pytest.fail(
        "the card's route called torch.optim.Adam.step"))
    ps = _params()
    opt = make_optimizer(ps, **SCHEDULE)
    assert opt.capturable and opt.adam.param_groups[0]["capturable"]
    assert opt._counter.dtype == torch.int32
    calls = adam.PLAIN_CALLS.value
    got = _run(opt, ps)
    assert adam.PLAIN_CALLS.value == calls + STEPS
    assert ps[NO_GRAD] not in opt.adam.state
    for j, p in enumerate(ps):
        if j == NO_GRAD:
            continue
        st = opt.adam.state[p]
        assert set(st) == {"step", "exp_avg", "exp_avg_sq"}
        assert st["step"].shape == () and st["step"].dtype == torch.float32
        assert float(st["step"]) == STEPS
        assert st["exp_avg"].shape == p.shape
    monkeypatch.setattr(torch.optim.Adam, "step", real_step)
    want, _ = _torch_run(1e-5, True, _params())
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_card_route_refuses_a_parameter_the_kernel_does_not_take(
        card_route, monkeypatch):
    """The optimizer checks nothing itself: ``adam_update``'s check, which
    runs on CUDA tensors (run here on the CPU ones of the card's route),
    refuses the tensor, naming its index and shape."""
    real = adam.adam_update

    def checked(*args):  # lists, lr, beta1, beta2, eps, decay, counter
        adam._check(*args[:6], args[10])
        real(*args)

    monkeypatch.setattr(adam, "adam_update", checked)
    ps =[torch.nn.Parameter(torch.ones(3)),
          torch.nn.Parameter(torch.ones(2, dtype=torch.float64))]
    opt = make_optimizer(ps, lr=1e-3)
    for p in ps:
        p.grad = torch.ones_like(p)
    with pytest.raises(NotImplementedError,
                       match=r"tensor 1 of shape \(2,\): .*not float32"):
        opt.update()


def _small_mixer(seed):
    return MlpMixer(num_classes=6, num_blocks=1, hidden_dim=8,
                    tokens_mlp_dim=4, channels_mlp_dim=8, seq_len=3,
                    pred_len=2, activation="gelu", regularization=0.0,
                    input_size=6, r_se=2, use_se=True,
                    generator=torch.Generator().manual_seed(seed))


def _mixer_steps(model, opt, lo, hi):
    for i in range(lo, hi):
        g = torch.Generator().manual_seed(100 + i)
        x = torch.randn(4, 3, 6, generator=g)
        opt.zero_grad()
        model(x).square().mean().backward()
        opt.step()


@pytest.mark.parametrize("kind", ["train_state.pt", "model.ckpt"])
def test_card_routes_state_round_trips_through_checkpoints(kind, card_route,
                                                           tmp_path):
    """A state the card's route made, written as a ``train_state.pt`` or a
    JAX ``.ckpt`` and read into a fresh optimizer on the same route: the
    state keys torch's Adam writes, the moments and count restored, and the
    next steps those of the unbroken run (a milestone passed)."""
    model = _small_mixer(1)
    opt = make_optimizer(model.parameters(), lr=1e-2, milestones=[1],
                         steps_per_epoch=3)
    _mixer_steps(model, opt, 0, 4)
    path = str(tmp_path / kind)
    if kind.endswith(".pt"):
        save_checkpoint(path, model, opt, 1)
    else:
        save_jax_checkpoint(path, model, opt, 1)
    clone = _small_mixer(2)
    opt2 = make_optimizer(clone.parameters(), lr=1e-2, milestones=[1],
                          steps_per_epoch=3)
    assert restore_checkpoint(path, clone, opt2) == 1
    assert (opt2.steps, opt2.lr) == (opt.steps, opt.lr) and opt.lr < 1e-2
    assert opt2.generation == 1
    sd, sd2 = opt.state_dict(), opt2.state_dict()
    assert sorted(sd["adam"]["state"]) == sorted(sd2["adam"]["state"])
    for i, st in sd["adam"]["state"].items():
        st2 = sd2["adam"]["state"][i]
        assert set(st) == set(st2) == {"step", "exp_avg", "exp_avg_sq"}
        assert st2["step"].dtype == torch.float32 and st2["step"].shape == ()
        for key in st:
            torch.testing.assert_close(st2[key], st[key], rtol=0, atol=0)
    _mixer_steps(model, opt, 4, 6)
    _mixer_steps(clone, opt2, 4, 6)
    for a, b in zip(model.parameters(), clone.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bench_reader_reads_launches_a_step(monkeypatch):
    """The benchmark's reader ``adam_launches_per_step.train``: the kernel's
    device launches over the process's train steps, untraced and traced;
    None without a card, before the wrapper ever launched, with no launch
    or no step, and where the program has no such module (the parent's)."""
    from bench_h100 import harness

    read = harness.metric_module("adam_launches_per_step.train").read
    assert read(None) is None  # no card here
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(adam, "device_launches", lambda: 1503)
    snap = {"untraced": {"train.step": {"count": 1500}},
            "traced": {"train.step": {"count": 3}}}
    monkeypatch.setattr(profiling, "snapshot", lambda: snap)
    monkeypatch.setattr(adam.LAUNCHES, "value", 0)
    assert read(None) is None
    monkeypatch.setattr(adam.LAUNCHES, "value", 4)
    assert read(None) == 1.0
    monkeypatch.setattr(adam, "device_launches", lambda: 0)
    assert read(None) is None
    snap["untraced"], snap["traced"] = {}, {}
    monkeypatch.setattr(adam, "device_launches", lambda: 1503)
    assert read(None) is None
    monkeypatch.setitem(sys.modules, "motionmixerconv_tpu_torch.ops.adam",
                        None)
    monkeypatch.delattr(sys.modules["motionmixerconv_tpu_torch.ops"], "adam")
    assert read(None) is None

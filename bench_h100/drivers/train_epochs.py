"""Whole training epochs back to back, as the training CLIs' per-epoch path
runs them (``cli/_runner._train_and_evaluate``): ``train_epoch`` (or
``train_epoch_ar``), ``validate``, ``evaluate_grouped``, one host read
each, no checkpoint.

Set-up writes the seeded corpus as the dataset's CSV files under TMPDIR,
reads it through the port's ``H36MDataset`` (forward kinematics, windows,
the device), builds the model from the seed, and drives the trainer
through its first six steps with the window's own call, one-batch epochs
of distinct windows: the step graph's three eager warm-up calls, its
capture, and two replays. Then the first validation and grouped test run,
each capturing its graph and replaying it, so that nothing is captured in
the window. The reference follows the six steps and that test.

The window runs epochs until ``seconds`` have passed, finishing the epoch
that is running then, and counts every training window of every epoch.
Once it has closed, one more step through the same call, from the
program's state after the window, is followed by the reference from that
state: the learning rate the schedule has reached and Adam's step count.
"""

from __future__ import annotations

import math
from contextlib import nullcontext
import os
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from .. import corpus
from ..checks import global_gap, leaf_gap, rel_gap
from ..reference import convmixer, h36m as ref_h36m, train as ref_train
from ..tracing import Phases, Trace

# the step graph's eager warm-up calls (3), its capture, two replays
CHECK_STEPS = 6


def model_cfg(config) -> dict:
    """The reference's model description from a configuration file."""
    return {
        "num_blocks": config["num_blocks"], "dimPosIn": config["pose_dim"],
        "dimPosEmb": config["hidden_dim"], "dimPosOut": config["pose_dim"],
        "in_nTP": config["input_n_model"], "out_nTP": config["output_n_model"],
        "conv_nChan": config["conv_nChan"],
        "conv1_kernel_shape": tuple(config["conv1_kernel_shape"]),
        "activation": config["activation"],
        "regularization": config["regularization"], "r_se": config["r_se"],
        "n_harmonic_functions": config["encoder_n_harmonic_functions"],
        "omega0": config["encoder_omega0"],
    }


def build_program_model(config, params, device):
    """The port's ConvMixer as its training CLI builds it, holding
    ``params`` (the reference layout)."""
    from motionmixerconv_tpu_torch.cli._runner import build_conv_mixer

    args = SimpleNamespace(
        num_blocks=config["num_blocks"], hidden_dim=config["hidden_dim"],
        conv_nChan=config["conv_nChan"],
        conv1_kernel_shape=tuple(config["conv1_kernel_shape"]),
        activation=config["activation"],
        regularization=config["regularization"], r_se=config["r_se"],
        encoder_n_harmonic_functions=config["encoder_n_harmonic_functions"],
        encoder_omega0=config["encoder_omega0"],
        fused_encoder=config["fused_encoder"])
    model = build_conv_mixer(args, config["pose_dim"], config["pose_dim"],
                             config["input_n_model"], config["output_n_model"])
    model.load_state_dict({k: v.detach().clone() for k, v in params.items()},
                          strict=True)
    return model.to(device)


def reference_task(config, traffic) -> ref_train.Task:
    kind = traffic["trainer"]
    return ref_train.Task(
        model_cfg(config), "direct" if kind == "direct" else "closed_loop",
        config["input_n"], config["output_n"], config["input_scale"],
        config.get("step_window"))


def _seed(seed: int, *tags) -> int:
    return int(np.random.default_rng([int(seed), *tags]).integers(2 ** 31))


def setup(ctx):
    from motionmixerconv_tpu_torch.data import H36MDataset
    from motionmixerconv_tpu_torch.data.windows import WindowedCorpus
    from motionmixerconv_tpu_torch.train import (AutoregressiveTrainer,
                                                 Trainer, make_optimizer)

    config, traffic, seed, device = ctx.config, ctx.traffic, ctx.seed, ctx.device
    actions = tuple(config["actions"])
    seq_len = config["input_n"] + config["output_n"]
    skip, bs = config["skip_rate"], config["batch_size"]
    phases = Phases()
    raw = {s: corpus.split_sequences(seed, s, config["corpus_frames"], actions)
           for s in (0, 1, 2)}
    phases.mark("corpus")
    data_dir = corpus.write_csv(os.path.join(ctx.tmp, "h36m"),
                                raw[0] + raw[1] + raw[2])
    phases.mark("csv")

    def split(s, acts=actions):
        return H36MDataset(data_dir, config["input_n"], config["output_n"],
                           skip, actions=list(acts), split=s, mode="xyz")

    dataset, vald = split(0), split(1)
    tests = [split(2, [a]) for a in actions]
    frames, vframes = dataset.frames_on(device), vald.frames_on(device)
    test_frames = torch.as_tensor(
        np.concatenate([t.frames for t in tests])).to(device)
    offs = np.cumsum([0] + [t.frames.shape[0] for t in tests[:-1]])
    test_starts = np.concatenate([t.window_starts + o
                                  for t, o in zip(tests, offs)])
    test_gids = np.concatenate([np.full(len(t), g, np.int64)
                                for g, t in enumerate(tests)])
    phases.mark("program dataset")

    # the reference's own corpus and windows, from the same raw sequences
    ref_frames, ref_starts = ref_h36m.xyz_corpus(
        [r[3] for r in raw[0]], seq_len, skip)
    # the first steps' batches, and the one after the window
    pick = np.random.default_rng([int(seed), 1]).permutation(
        len(ref_starts))[: (CHECK_STEPS + 1) * bs]
    check_starts = ref_starts[pick].reshape(CHECK_STEPS + 1, bs)
    phases.mark("reference corpus")

    mcfg = model_cfg(config)
    params0 = convmixer.init_params(mcfg, _seed(seed, 2), device)
    model = build_program_model(config, params0, device)
    opt = make_optimizer(
        model.parameters(), lr=config["lr"], weight_decay=config["weight_decay"],
        use_scheduler=True, milestones=config["milestones"],
        gamma=config["gamma"], steps_per_epoch=max(1, -(-len(dataset) // bs)))
    common = dict(loss_type="mpjpe", dim_used=dataset.dim_used,
                  input_scale=config["input_scale"])
    autoreg = traffic["trainer"] == "closed_loop"
    if autoreg:
        trainer = AutoregressiveTrainer(
            model, opt, input_n=config["input_n"], output_n=config["output_n"],
            input_n_model=config["input_n_model"],
            output_n_model=config["output_n_model"],
            step_window=config["step_window"], **common)
        test_kind = "ar"
    else:
        trainer = Trainer(model, opt, input_n=config["input_n"],
                          output_n=config["output_n"], **common)
        test_kind = "h36m_xyz"
    phases.mark("model")

    def one_batch(k):
        part = WindowedCorpus(frames=dataset.frames,
                              window_starts=check_starts[k], seq_len=seq_len)
        if autoreg:
            return trainer.train_epoch_ar(part, frames, bs, seed=k,
                                          teacher_forcing=False)
        return trainer.train_epoch(part, frames, bs, seed=k,
                                   order=np.arange(bs))

    def snapshot():
        return {n: p.detach().clone() for n, p in model.named_parameters()}

    dropout_seed = _seed(seed, 3)
    torch.manual_seed(dropout_seed)
    losses, opt1 = [], None
    for k in range(CHECK_STEPS):
        losses.append(one_batch(k))
        if k == 0:
            opt1 = first_gradient(opt.adam, model)
    params_k = snapshot()
    phases.mark("check steps and the step graph's capture")
    trainer.validate(vald, vframes, bs)
    n_groups = len(tests)
    m1, _, n = trainer.evaluate_grouped(
        test_frames, test_starts, test_gids, n_groups,
        config["batch_size_test"], test_kind)
    phases.mark("evaluation captures")
    eval_flops, train_flops = count_flops(config, traffic)
    phases.mark("flops")
    if ctx.trace:
        Trace.warm()
        phases.mark("profiler warm-up")
    phases.report()
    return SimpleNamespace(
        ctx=ctx, trainer=trainer, model=model, opt=opt, autoreg=autoreg,
        one_batch=one_batch, steps_done=CHECK_STEPS,
        dataset=dataset, frames=frames, vald=vald, vframes=vframes,
        test_frames=test_frames, test_starts=test_starts,
        test_gids=test_gids, n_groups=n_groups, test_kind=test_kind,
        program={"losses": losses, "opt1": opt1, "params": params_k,
                 "test": m1 / np.maximum(n, 1.0)},
        check={"raw_test": [(raw[2][i][3], raw[2][i + 1][3])
                            for i in range(0, len(raw[2]), 2)],
               "ref_frames": ref_frames, "n_train": len(ref_starts),
               "starts": check_starts, "params0": params0,
               "dropout_seed": dropout_seed},
        flops={"train": train_flops, "eval": eval_flops})


def first_gradient(adam, model) -> dict:
    """Each parameter's gradient as Adam took it in its first step (plus
    the coupled L2 term), worked out from its first moment; zero where
    Adam holds no moment, having taken no step."""
    beta1 = adam.param_groups[0]["betas"][0]
    out = {}
    for name, p in model.named_parameters():
        m = adam.state.get(p, {}).get("exp_avg")
        out[name] = (m.detach() / (1 - beta1) if m is not None
                     else torch.zeros_like(p.detach()))
    return out


def count_flops(config, traffic):
    """Model FLOPs per sample of evaluation and of a training step, counted
    from shapes on the reference (matmuls and convolutions, on the meta
    device): (eval forward(s), forward and backward)."""
    from torch.utils.flop_counter import FlopCounterMode

    task = reference_task(config, traffic)
    b = 2
    params = convmixer.init_params(task.cfg, 0, "cpu")
    params = {k: v.to("meta") for k, v in params.items()}
    seq = torch.zeros((b, config["input_n"] + config["output_n"],
                       config["pose_dim"]), device="meta")
    w = torch.ones(b, device="meta")
    names = convmixer.leaves(params)
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            task.per_sample(params, seq, train=False)
    eval_flops = fc.get_total_flops() / b
    for k in names:
        params[k].requires_grad_(True)
    with FlopCounterMode(display=False) as fc:
        loss = task.loss(params, seq, w)
        torch.autograd.grad(loss, [params[k] for k in names])
    return eval_flops, fc.get_total_flops() / b


def window(state, seconds: float, trace: bool):
    ctx, trainer = state.ctx, state.trainer
    config = ctx.config
    bs = config["batch_size"]
    b1_before = _b1_launches(state)
    epochs = failed = steps = 0
    per_epoch = []  # (epoch s, eval s) of each epoch
    summary = None
    t0 = time.perf_counter()
    while True:
        tr = Trace() if trace and epochs == 1 else None
        t_epoch = time.perf_counter()
        with (tr or nullcontext()):
            with (tr.span("train") if tr else nullcontext()):
                loss = _train_epoch(state, _seed(ctx.seed, 4, epochs))
            t_eval = time.perf_counter()
            with (tr.span("eval") if tr else nullcontext()):
                trainer.validate(state.vald, state.vframes, bs)
                trainer.evaluate_grouped(
                    state.test_frames, state.test_starts, state.test_gids,
                    state.n_groups, config["batch_size_test"], state.test_kind)
        t_end = time.perf_counter()
        per_epoch.append((t_end - t_epoch, t_end - t_eval))
        n_steps = -(-len(state.dataset) // bs)
        steps += n_steps
        if not math.isfinite(loss):
            failed += n_steps
        if tr:
            summary = tr.summary
        epochs += 1
        if t_end - t0 >= seconds and (not trace or epochs > 1):
            break
    window_s = time.perf_counter() - t0
    state.steps_done += steps
    samples = epochs * len(state.dataset)
    print("epochs: " + " ".join(f"{e:.3f}/{v:.3f}" for e, v in per_epoch)
          + " s (whole/evaluation)", file=sys.stderr)
    # host-clock layer metrics leave the traced epoch out
    kept = [e for i, e in enumerate(per_epoch) if not (trace and i == 1)]
    counters = {
        "epochs": len(kept), "window_s": sum(e for e, _ in kept),
        "eval_s": sum(v for _, v in kept),
        "b1_launches": _sub(_b1_launches(state), b1_before),
        "train_flops_per_sample": state.flops["train"],
        "eval_flops_per_sample": state.flops["eval"],
        "n_train": len(state.dataset),
        "n_eval": len(state.vald) + len(state.test_starts),
        "steps_per_epoch": -(-len(state.dataset) // bs),
    }
    return {"attempted": steps, "failed": failed,
            "e2e": {"train_samples_per_s": samples / window_s},
            "counters": counters, "trace": summary}


def _train_epoch(state, seed):
    ds, frames, bs = state.dataset, state.frames, state.ctx.config["batch_size"]
    try:
        if state.autoreg:
            return state.trainer.train_epoch_ar(ds, frames, bs, seed=seed,
                                                teacher_forcing=False)
        return state.trainer.train_epoch(ds, frames, bs, seed=seed)
    except FloatingPointError:
        return float("nan")


def _b1_launches(state):
    if not (state.ctx.device.type == "cuda" and state.ctx.config["fused_encoder"]):
        return None
    from motionmixerconv_tpu_torch.ops.harmonic import device_launches

    return device_launches()


def _sub(a, b):
    return None if a is None else [x - y for x, y in zip(a, b)]


def late_step(state) -> dict:
    """One more step through the window's call, on a batch of its own,
    from the program's state after the window: that state (parameters and
    buffers, Adam's moments, the dropout generator), the step's loss and
    the parameters after it."""
    model, adam, device = state.model, state.opt.adam, state.ctx.device
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    moments = [{}, {}]
    for name, p in model.named_parameters():
        st = adam.state.get(p, {})
        for i, key in enumerate(("exp_avg", "exp_avg_sq")):
            moments[i][name] = (st[key].detach().clone() if key in st
                                else torch.zeros_like(p.detach()))
    rng = _rng_state(device)
    loss = state.one_batch(CHECK_STEPS)
    after = {n: p.detach().clone() for n, p in model.named_parameters()}
    return {"start": start, "moments": moments, "rng": rng, "loss": loss,
            "after": after, "steps": state.steps_done}


def _rng_state(device):
    return (torch.cuda.get_rng_state(device) if device.type == "cuda"
            else torch.get_rng_state())


def _set_rng_state(device, rng) -> None:
    if device.type == "cuda":
        torch.cuda.set_rng_state(rng, device)
    else:
        torch.set_rng_state(rng)


def reference_run(state, late: dict, tf32: bool = False,
                  half_batch: bool = False):
    """The reference's six steps from the same weights, windows and dropout
    seed, its test of the model they give, and its step after the window
    from the program's state there (``late``: the one stage it cannot
    follow by itself), in the program's result layout. ``tf32`` computes
    it with TF32 allowed (the control); ``half_batch`` gives the second
    half of every batch, in training and in the test, weight 0, the mean
    taken over the rest (a planted fault)."""
    ctx, chk = state.ctx, state.check
    device, config = ctx.device, ctx.config
    task = reference_task(config, ctx.traffic)
    seq_len = config["input_n"] + config["output_n"]
    dim_used = torch.as_tensor(ref_h36m.DIM_USED_XYZ, device=device)
    frames = torch.as_tensor(chk["ref_frames"], device=device)
    bs = config["batch_size"]
    w = _half(torch.ones(bs, device=device), bs, half_batch)
    batches = [(ref_train.windows(frames, torch.as_tensor(s, device=device),
                                  seq_len, dim_used), w)
               for s in chk["starts"]]
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        torch.manual_seed(chk["dropout_seed"])
        ref = ref_train.follow(task, chk["params0"], batches[:CHECK_STEPS],
                               config["lr"], config["weight_decay"])
        test = reference_test(state, task, ref["params"], half_batch)
        p_late = {k: v.to(device) for k, v in late["start"].items()}
        for k in p_late:
            if ".se2." in k:  # the module's alias: one tensor
                p_late[k] = p_late[k.replace(".se2.", ".se.")]
        lr = ref_train.lr_at(config["lr"], config["milestones"],
                             config["gamma"], -(-chk["n_train"] // bs),
                             late["steps"])
        _set_rng_state(device, late["rng"])
        after = ref_train.follow(
            task, p_late, batches[CHECK_STEPS:], lr, config["weight_decay"],
            start=(*late["moments"], late["steps"]))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    return {"losses": ref["losses"], "opt1": ref["opt1"],
            "params": ref["params"], "grad1": ref["grad1"], "test": test,
            "late": {"start": p_late, "loss": after["losses"][0],
                     "after": after["params"], "grad": after["grad1"]}}


def _half(w: torch.Tensor, block: int, half: bool) -> torch.Tensor:
    """``w`` with the second half of every ``block`` rows at weight 0 when
    ``half``."""
    if half:
        w = w.clone()
        for lo in range(0, len(w), block):
            w[lo + block // 2: lo + block] = 0.0
    return w


@torch.no_grad()
def reference_test(state, task, params, half_batch: bool) -> np.ndarray:
    """Each action's mean test metric (the grouped test's first metric
    over its windows) of ``params``, in blocks of the test's batch."""
    config, device = state.ctx.config, state.ctx.device
    seq_len = config["input_n"] + config["output_n"]
    frames, starts, groups = ref_h36m.test_corpus(
        state.check["raw_test"], config["input_n"])
    frames = torch.as_tensor(frames, device=device)
    dim_used = torch.as_tensor(ref_h36m.DIM_USED_XYZ, device=device)
    ignore = torch.as_tensor(ref_h36m.IGNORE_EVAL, device=device)
    equal = torch.as_tensor(ref_h36m.EQUAL_EVAL, device=device)
    block = config["batch_size_test"]
    per = []
    for lo in range(0, len(starts), block):
        idx = torch.as_tensor(starts[lo: lo + block], device=device)
        full = ref_train.windows(frames, idx, seq_len,
                                 torch.arange(frames.shape[1], device=device))
        per.append(task.test_per_sample(params, full, dim_used, ignore,
                                        equal).double())
    per = torch.cat(per)
    w = _half(torch.ones_like(per), block, half_batch)
    g = torch.as_tensor(groups, device=device)
    n_groups = int(groups.max()) + 1
    sums = torch.zeros(n_groups, dtype=per.dtype, device=device)
    cnt = torch.zeros_like(sums)
    sums.index_add_(0, g, per * w)
    cnt.index_add_(0, g, w)
    return (sums / cnt.clamp(min=1.0)).cpu().numpy()


def free_program(state) -> None:
    """Drop the program's trainer, model and corpus, so the reference runs
    in the memory they held."""
    for name in ("trainer", "model", "opt", "one_batch", "frames", "vframes",
                 "test_frames"):
        setattr(state, name, None)
    if state.ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def check(state):
    """The program's first steps, its test and its step after the window
    against the reference's."""
    late = late_step(state)
    free_program(state)
    return numbers(state.program, late, reference_run(state, late),
                   state.check["params0"])


def control_readings(state) -> dict:
    """The compared numbers of the program, of the control (the reference
    with TF32 allowed, in the program's place) and of a planted fault (half
    of each batch left out), each against the reference."""
    late = late_step(state)
    free_program(state)
    ref = reference_run(state, late)
    p0 = state.check["params0"]
    return {"program": numbers(state.program, late, ref, p0),
            "control": numbers(*as_program(reference_run(state, late,
                                                         tf32=True)),
                               ref, p0),
            "half_batch": numbers(*as_program(reference_run(
                state, late, half_batch=True)), ref, p0)}


def as_program(r):
    """A reference run in the program's place: (its first steps and test,
    its step after the window)."""
    return ({"losses": r["losses"], "opt1": r["opt1"], "params": r["params"],
             "test": r["test"]},
            {"loss": r["late"]["loss"], "after": r["late"]["after"]})


def numbers(prog, late, ref, params0):
    """The numbers a cell's limits may compare. The first six steps: the
    worst step's loss gap; the worst leaf's and the median leaf's gap in
    the first gradient as Adam takes it; the worst and the median leaf's
    gap in the change over the steps. The test of the model they give: the
    worst action's gap in the mean test metric. The step after the window:
    its loss gap; the worst and the median leaf's gap in its change, and
    the gap in the norm of the change of all leaves together. Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out of the leaf numbers:
    their gradient is rounding (``encoder.channelUpscaling.bias`` reaches
    the loss only through LayerNorms over the width it shifts uniformly;
    an SE unit dead for the whole batch has none), so their reading is
    noise. The worst leaves and the leaves left out go to standard
    error."""
    names = convmixer.leaves(params0)
    moved = _moved(names, ref["grad1"])
    grad, grad_leaf, grad_med = leaf_gap(
        {k: prog["opt1"][k] for k in moved}, {k: ref["opt1"][k] for k in moved})
    change, change_leaf, change_med = leaf_gap(
        {k: prog["params"][k] - params0[k] for k in moved},
        {k: ref["params"][k] - params0[k] for k in moved})
    r_late, start = ref["late"], ref["late"]["start"]
    moved_late = _moved(names, r_late["grad"])
    late_prog = {k: late["after"][k] - start[k] for k in moved_late}
    late_ref = {k: r_late["after"][k] - start[k] for k in moved_late}
    late_change, late_leaf, late_med = leaf_gap(late_prog, late_ref)
    left = sorted(set(names) - set(moved))
    print(f"worst leaves: grad_gap {grad_leaf}, change_gap {change_leaf}, "
          f"late_change_gap {late_leaf}; left out: {left}", file=sys.stderr)
    test = [rel_gap(a, b) for a, b in zip(prog["test"], ref["test"])]
    return {"loss_gap": max(rel_gap(a, b) for a, b in zip(prog["losses"],
                                                          ref["losses"])),
            "grad_gap": grad, "grad_median_gap": grad_med,
            "change_gap": change, "change_median_gap": change_med,
            "test_gap": max(test) if len(test) == len(ref["test"]) else None,
            "late_loss_gap": rel_gap(late["loss"], r_late["loss"]),
            "late_change_gap": late_change,
            "late_change_median_gap": late_med,
            "late_change_global_gap": global_gap(late_prog, late_ref)}


def _moved(names, ref_grad):
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    g = {k: float(ref_grad[k].norm()) for k in names}
    med = float(np.median(list(g.values())))
    return [k for k in names if g[k] >= 1e-3 * med]

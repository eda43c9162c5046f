"""Whole AMASS MotionMixer training epochs, as ``cli/_runner.run_amass``
runs them: the three ``AMASSDataset`` splits, ``build_mlp_mixer``,
``_model_and_optimizer``, the ``Trainer`` with the MPJPE loss x 1000 on
unscaled meters, then per epoch ``train_epoch``, ``validate`` and the
``amass22`` test in batches of 200, one host read each, no checkpoint.

Set-up writes the seeded corpus (``corpus_amass.py``) as npz archives
under the run's temporary directory and reads it through the port's
``AMASSDataset`` (the npz walk, forward kinematics, windows, the device);
the reference reads the same archives with its own loader. The first six
steps, the test after them, the window, and the step after the window are
``train_epochs.py``'s: its generic parts are imported from there.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import numpy as np
import torch

from .. import corpus_amass
from ..reference import amass as ref_amass, mlpmixer, train as ref_train
from ..tracing import Phases, Trace
from . import train_epochs as te
from .train_epochs import CHECK_STEPS, _seed

# the MlpMixer has no harmonic encoder: the window's B1 counter reads none
WINDOW_CONFIG = {"fused_encoder": False}


def runner_args(config, seed: int) -> SimpleNamespace:
    """The flags ``run_amass`` reads, from a configuration file."""
    keys = ("num_blocks", "hidden_dim", "tokens_mlp_dim", "channels_mlp_dim",
            "activation", "regularization", "r_se", "pose_dim", "input_n",
            "output_n", "skip_rate", "batch_size", "lr", "milestones",
            "gamma")
    return SimpleNamespace(**{k: config[k] for k in keys}, seed=seed,
                           use_scheduler=True, clip_grad=None)


def _data_spans() -> dict:
    """The program's ``data.read`` and ``data.fk`` totals, ns ({} where it
    keeps no such spans)."""
    from motionmixerconv_tpu_torch import profiling

    snap = profiling.snapshot()["untraced"]
    return {k: snap[k]["total_ns"] for k in ("data.read", "data.fk")
            if k in snap}


def setup(ctx):
    from motionmixerconv_tpu_torch.cli._runner import (_model_and_optimizer,
                                                       build_mlp_mixer)
    from motionmixerconv_tpu_torch.data import AMASSDataset
    from motionmixerconv_tpu_torch.data.constants import AMASS_DIM_USED
    from motionmixerconv_tpu_torch.data.windows import WindowedCorpus
    from motionmixerconv_tpu_torch.train import Trainer

    config, seed, device = ctx.config, ctx.seed, ctx.device
    in_n, out_n = config["input_n"], config["output_n"]
    seq_len, skip, bs = in_n + out_n, config["skip_rate"], config["batch_size"]
    phases = Phases()
    data_dir = corpus_amass.write(os.path.join(ctx.tmp, "amass"), seed,
                                  config["corpus"], config["corpus_frames"])
    phases.mark("corpus written")
    spans0 = _data_spans()
    dataset, vald, test = (AMASSDataset(data_dir, in_n, out_n, skip, split=s)
                           for s in range(3))
    spans = {k: (v - spans0.get(k, 0)) / 1e9
             for k, v in _data_spans().items()}
    phases.mark("program dataset" + (
        f" (npz read {spans['data.read']:.3f} s, FK {spans['data.fk']:.3f} s)"
        if len(spans) == 2 else ""))
    frames, vframes = dataset.frames_on(device), vald.frames_on(device)
    test_frames = test.frames_on(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    phases.mark("frames to the device")

    # the reference's own corpora and windows, read from the same archives
    # (its FK on the host, as the program's, so that the device's memory
    # peak is the program's)
    ref_frames, ref_starts = ref_amass.corpus(data_dir, 0, seq_len, skip,
                                              "cpu")
    ref_test = ref_amass.corpus(data_dir, 2, seq_len, skip, "cpu")
    # the first steps' batches, and the one after the window
    pick = np.random.default_rng([int(seed), 1]).permutation(
        len(ref_starts))[: (CHECK_STEPS + 1) * bs]
    check_starts = ref_starts[pick].reshape(CHECK_STEPS + 1, bs)
    phases.mark("reference corpus")

    dropout_seed = _seed(seed, 3)
    params0 = mlpmixer.init_params(config, _seed(seed, 2), device)
    args = runner_args(config, dropout_seed)
    model = build_mlp_mixer(args, len(AMASS_DIM_USED), in_n, out_n,
                            generator=torch.Generator().manual_seed(
                                dropout_seed))
    model, opt = _model_and_optimizer(
        args, model, {k: v.detach().clone() for k, v in params0.items()},
        device, in_n, out_n, len(dataset))
    trainer = Trainer(model, opt, loss_type="mpjpe", dim_used=AMASS_DIM_USED,
                      input_n=in_n, output_n=out_n,
                      input_scale=config["input_scale"],
                      loss_scale=config["loss_scale"])
    phases.mark("model")

    def one_batch(k):
        part = WindowedCorpus(frames=dataset.frames,
                              window_starts=check_starts[k], seq_len=seq_len)
        return trainer.train_epoch(part, frames, bs, seed=k,
                                   order=np.arange(bs))

    torch.manual_seed(dropout_seed)  # the dropout stream, as the runner's
    losses, opt1 = [], None
    for k in range(CHECK_STEPS):
        losses.append(one_batch(k))
        if k == 0:
            opt1 = te.first_gradient(opt.adam, model)
    params_k = {n: p.detach().clone() for n, p in model.named_parameters()}
    phases.mark("check steps and the step graph's capture")
    test_gids = np.zeros(len(test), np.int64)
    trainer.validate(vald, vframes, bs)
    m1, _, n = trainer.evaluate_grouped(
        test_frames, test.window_starts, test_gids, 1,
        config["batch_size_test"], "amass22")
    phases.mark("evaluation captures")
    eval_flops, train_flops = count_flops(config)
    phases.mark("flops")
    if ctx.trace:
        Trace.warm()
        phases.mark("profiler warm-up")
    phases.report()
    return SimpleNamespace(
        ctx=SimpleNamespace(**{**vars(ctx),
                               "config": {**config, **WINDOW_CONFIG}}),
        trainer=trainer, model=model, opt=opt, autoreg=False,
        one_batch=one_batch, steps_done=CHECK_STEPS,
        dataset=dataset, frames=frames, vald=vald, vframes=vframes,
        test_frames=test_frames, test_starts=test.window_starts,
        test_gids=test_gids, n_groups=1, test_kind="amass22",
        program={"losses": losses, "opt1": opt1, "params": params_k,
                 "test": m1 / np.maximum(n, 1.0)},
        check={"ref_frames": ref_frames, "n_train": len(ref_starts),
               "test": ref_test, "starts": check_starts, "params0": params0,
               "dropout_seed": dropout_seed},
        flops={"train": train_flops, "eval": eval_flops})


def count_flops(config):
    """Model FLOPs per sample of evaluation and of a training step, counted
    from shapes on the reference (matmuls, on the meta device): (forward,
    forward and backward)."""
    from torch.utils.flop_counter import FlopCounterMode

    task = mlpmixer.Task(config, config["input_n"], config["output_n"])
    b = 2
    params = {k: v.to("meta") for k, v in
              mlpmixer.init_params(config, 0, "cpu").items()}
    seq = torch.zeros((b, config["input_n"] + config["output_n"],
                       config["pose_dim"]), device="meta")
    with FlopCounterMode(display=False) as fc:
        with torch.no_grad():
            task.predict(params, seq, train=False)
    eval_flops = fc.get_total_flops() / b
    for v in params.values():
        v.requires_grad_(True)
    with FlopCounterMode(display=False) as fc:
        loss = task.loss(params, seq, torch.ones(b, device="meta"))
        torch.autograd.grad(loss, list(params.values()))
    return eval_flops, fc.get_total_flops() / b


def window(state, seconds: float, trace: bool):
    return te.window(state, seconds, trace)


def reference_run(state, late: dict, tf32: bool = False,
                  half_batch: bool = False):
    """``train_epochs.reference_run`` for the MlpMixer: the reference's six
    steps from the same weights, windows and dropout seed, its ``amass22``
    test of the model they give, and its step after the window from the
    program's state there. ``tf32`` computes it with TF32 allowed (the
    control); ``half_batch`` gives the second half of every batch, in
    training and in the test, weight 0 (a planted fault)."""
    ctx, chk = state.ctx, state.check
    device, config = ctx.device, ctx.config
    task = mlpmixer.Task(config, config["input_n"], config["output_n"],
                         config["loss_scale"])
    seq_len = config["input_n"] + config["output_n"]
    dim_used = torch.as_tensor(ref_amass.DIM_USED, device=device)
    frames = torch.as_tensor(chk["ref_frames"], device=device)
    bs = config["batch_size"]
    w = te._half(torch.ones(bs, device=device), bs, half_batch)
    batches = [(ref_train.windows(frames, torch.as_tensor(s, device=device),
                                  seq_len, dim_used), w)
               for s in chk["starts"]]
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        torch.manual_seed(chk["dropout_seed"])
        ref = mlpmixer.follow(task, chk["params0"], batches[:CHECK_STEPS],
                              config["lr"], config["weight_decay"])
        test = reference_test(state, task, ref["params"], half_batch)
        p_late = {k: v.to(device) for k, v in late["start"].items()}
        lr = mlpmixer.lr_at(config["lr"], config["milestones"],
                            config["gamma"], -(-chk["n_train"] // bs),
                            late["steps"])
        te._set_rng_state(device, late["rng"])
        after = mlpmixer.follow(
            task, p_late, batches[CHECK_STEPS:], lr, config["weight_decay"],
            start=(*late["moments"], late["steps"]))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    return {"losses": ref["losses"], "opt1": ref["opt1"],
            "params": ref["params"], "grad1": ref["grad1"], "test": test,
            "late": {"start": p_late, "loss": after["losses"][0],
                     "after": after["params"], "grad": after["grad1"]}}


@torch.no_grad()
def reference_test(state, task, params, half_batch: bool) -> np.ndarray:
    """The ``amass22`` test's mean over its windows (one group) of
    ``params``, in blocks of the test's batch."""
    config, device = state.ctx.config, state.ctx.device
    seq_len = config["input_n"] + config["output_n"]
    frames, starts = state.check["test"]
    frames = torch.as_tensor(frames, device=device)
    dim_used = torch.as_tensor(ref_amass.DIM_USED, device=device)
    every = torch.arange(frames.shape[1], device=device)
    block = config["batch_size_test"]
    per = []
    for lo in range(0, len(starts), block):
        idx = torch.as_tensor(starts[lo: lo + block], device=device)
        full = ref_train.windows(frames, idx, seq_len, every)
        pred = task.predict(params, full[:, :, dim_used], train=False)
        per.append(ref_amass.amass22(pred, full, task.input_n,
                                     task.output_n).double())
    per = torch.cat(per)
    w = te._half(torch.ones_like(per), block, half_batch)
    return np.array([float((per * w).sum() / w.sum().clamp(min=1.0))])


def check(state):
    """The program's first steps, its test and its step after the window
    against the reference's."""
    late = te.late_step(state)
    te.free_program(state)
    return te.numbers(state.program, late, reference_run(state, late),
                      state.check["params0"])


def control_readings(state) -> dict:
    """The compared numbers of the program, of the control (the reference
    with TF32 allowed, in the program's place) and of a planted fault (half
    of each batch left out), each against the reference."""
    late = te.late_step(state)
    te.free_program(state)
    ref = reference_run(state, late)
    p0 = state.check["params0"]
    return {"program": te.numbers(state.program, late, ref, p0),
            "control": te.numbers(*te.as_program(
                reference_run(state, late, tf32=True)), ref, p0),
            "half_batch": te.numbers(*te.as_program(reference_run(
                state, late, half_batch=True)), ref, p0)}

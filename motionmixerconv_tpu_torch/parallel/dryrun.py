"""Multi-rank dry run of the port's data-parallel paths, each held to a
single-device twin.

Counterpart of ``__graft_entry__.dryrun_multichip``:

    python -m motionmixerconv_tpu_torch.parallel.dryrun --nproc 2 \\
        --backend gloo --dev cpu         # the CPU
    python -m motionmixerconv_tpu_torch.parallel.dryrun --nproc 4 \\
        --backend nccl                   # one rank a card
    python -m motionmixerconv_tpu_torch.parallel.dryrun --nproc 2 \\
        --backend gloo --dev cuda:0      # two gloo ranks on one card

On every rank (``parallel.launch``), from one init and one batch stream:
[1] one train step, [2] a train epoch over a ragged corpus (3 * batch - 2
windows: the last batch's weight-0 padding lands on the last ranks), [3]
the grouped evaluation, [4] an autoregressive closed-loop epoch with
``clip_grad`` 1.0, [5] ``run_epochs_fused`` over 2 epochs, and an epoch
whose clip always bites (it must clip the reduced gradient). The chain runs
twice: with dropout off against the ``mesh=None`` trainer, and with the
flagship's dropout 0.1 against the same mesh code path at world 1 (the
masks do not depend on the number of ranks). Then an autoregressive model
with BatchNorm trains a teacher-forcing and a closed-loop epoch against
``mesh=None`` (the global batch's statistics), and a batch that the ranks
do not divide must raise. In the parent: [4'] ``Predictor(mesh=)``'s bulk
path on ``3 * nproc - 1`` rows against the plain forward, [6]
``Study.optimize(devices=)`` and [7] ``BatchingPredictor(devices=)``.
Every stanza prints its largest difference from its twin; a miss exits 1.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

from ..data.constants import H36M_DIM_USED_XYZ
from ..data.windows import WindowedCorpus
from ..models import ConvMixer
from ..train import AutoregressiveTrainer, Trainer, make_optimizer
from .mesh import DataMesh, launch, make_mesh

SEED = 0
# the JAX dryrun's flagship (__graft_entry__.py:8-20) and its 2-block,
# 8-harmonic autoregressive model; the BatchNorm model is the
# autoregressive CLI's (conv_nChan 8, (5, 5) kernels) cut to 2 blocks
FLAGSHIP = dict(
    num_blocks=4, dimPosIn=66, dimPosEmb=50, dimPosOut=66, in_nTP=10,
    out_nTP=25, conv_nChan=1, conv1_kernel_shape=(1, 3), conv1_stride=(1, 1),
    conv1_padding=(0, 1), mode_conv="twice", activation="mish",
    regularization=0.1, use_se=True, r_se=8, use_max_pooling=False,
    encoder_n_harmonic_functions=64, encoder_omega0=0.1)
AR_MODEL = dict(FLAGSHIP, num_blocks=2, out_nTP=5,
                encoder_n_harmonic_functions=8)
BN_MODEL = dict(FLAGSHIP, num_blocks=2, dimPosEmb=192, out_nTP=5,
                conv_nChan=8, conv1_kernel_shape=(5, 5), conv1_padding=None,
                regularization=-1.0, encoder_n_harmonic_functions=0)
# the JAX dryrun's tolerances: losses relative, parameters absolute (Adam
# renormalizes near-zero gradients, so f32 reduction-order differences can
# move single elements by O(lr)), grouped sums relative, counts exact; the
# running statistics relative to each tensor's largest magnitude (a mean
# near 0 is a sum of cancelling terms): after one forward as the losses,
# after training as the parameters, whose drift they inherit
TOL = {"step": 1e-5, "epoch": 1e-5, "params": 1e-4, "grouped": 1e-4,
       "ar": 1e-5, "fused": 1e-4, "bn_ar": 1e-5, "bn_first": 1e-5,
       "bn_stats": 1e-4,
       "clip": 1e-4, "predict": 1e-5}
CLIP_ALWAYS = 1e-3  # below every step's gradient norm
FRAMES, SEQ = 128, 35


def _data(device, batch: int):
    rs = np.random.RandomState(SEED)
    frames_h = rs.randn(FRAMES, 96).astype(np.float32)
    n_windows = 3 * batch - 2  # not a multiple of the batch: padding
    corpus = WindowedCorpus(
        frames_h, (np.arange(n_windows) % (FRAMES - SEQ)).astype(np.int64),
        SEQ)
    gids = (np.arange(n_windows) % 3).astype(np.int64)
    return torch.from_numpy(frames_h).to(device), corpus, gids


def _trainer(cfg: dict, mesh: Optional[DataMesh], device, seed: int,
             autoregressive: bool = False, clip_grad: Optional[float] = None):
    torch.manual_seed(seed)  # the dropout masks' generator, alike on ranks
    model = ConvMixer(**cfg, generator=torch.Generator().manual_seed(seed))
    model = model.to(device)
    if not autoregressive:
        return Trainer(model, make_optimizer(model.parameters(), lr=1e-3,
                                             steps_per_epoch=10,
                                             clip_grad=clip_grad),
                       loss_type="mpjpe", dim_used=H36M_DIM_USED_XYZ,
                       input_n=10, output_n=25, input_scale=1e-3, mesh=mesh)
    # clip_grad as the autoregressive CLI recommends for closed loop
    return AutoregressiveTrainer(
        model, make_optimizer(model.parameters(), lr=1e-4, steps_per_epoch=10,
                              clip_grad=1.0),
        loss_type="mpjpe", dim_used=H36M_DIM_USED_XYZ, input_n=10,
        output_n=25, input_n_model=10, output_n_model=5, step_window=5,
        mesh=mesh)


def _chain(cfg: dict, ar_cfg: dict, mesh, device, batch: int,
           scan: bool) -> dict:
    """Stanzas 1-5 of one trainer chain; the results on the host."""
    frames, corpus, gids = _data(device, batch)
    tr = _trainer(cfg, mesh, device, SEED)
    starts = torch.arange(batch, device=device) % (FRAMES - SEQ)
    out = {"step": float(tr.train_step(frames, starts,
                                       torch.ones(batch, device=device)))}
    out["epoch"] = tr.train_epoch(corpus, frames, batch, seed=0, scan=scan)
    out["params"] = {k: v.detach().cpu().clone()
                     for k, v in tr.model.state_dict().items()}
    out["grouped"] = tr.evaluate_grouped(frames, corpus.window_starts, gids, 3,
                                         batch, "h36m_xyz", scan=scan)
    fused = tr.run_epochs_fused(corpus, frames, batch, [1, 2], corpus, frames,
                                frames, corpus.window_starts, gids, 3,
                                "h36m_xyz", batch, scan=scan)
    out["fused"] = np.concatenate([fused["train"], fused["val"],
                                   fused["m1"].ravel()])
    out["writer"] = tr.is_writer
    ar = _trainer(ar_cfg, mesh, device, SEED + 1, autoregressive=True)
    out["ar"] = ar.train_epoch_ar(corpus, frames, batch, seed=0,
                                  teacher_forcing=False, scan=scan)
    # a clip that always bites: it must see the reduced gradient's norm
    clipped = _trainer(cfg, mesh, device, SEED + 3, clip_grad=CLIP_ALWAYS)
    clipped.train_epoch(corpus, frames, batch, seed=0, scan=scan)
    out["clip"] = torch.cat([p.detach().reshape(-1).cpu()
                             for p in clipped.model.parameters()])
    return out


def _bn_chain(bn_cfg: dict, mesh, device, batch: int, scan: bool) -> dict:
    """The BatchNorm autoregressive model: a teacher-forcing and a
    closed-loop epoch and a validation; losses and running stats."""
    frames, corpus, _ = _data(device, batch)
    tr = _trainer(bn_cfg, mesh, device, SEED + 2, autoregressive=True)
    # one train-mode forward of the first global batch: its statistics
    # alone, before training moves the parameters
    s, _, _ = tr._shard(torch.arange(batch, device=device) % (FRAMES - SEQ),
                        torch.ones(batch, device=device))
    tr.model.train()
    with torch.no_grad():
        tr.model(tr._sequence(frames, s)[1][:, :tr.input_n_model])
    out = {"bn_first": {k: v.detach().cpu().clone() for k, v in
                        tr.model.state_dict().items() if "running" in k}}
    out["bn_ar"] = np.array([
        tr.train_epoch_ar(corpus, frames, batch, seed=0, teacher_forcing=True,
                          scan=scan),
        tr.train_epoch_ar(corpus, frames, batch, seed=1,
                          teacher_forcing=False, scan=scan),
        tr.evaluate_ar(corpus, frames, batch, "val")])
    sd = {k: v.detach().cpu().clone() for k, v in tr.model.state_dict().items()}
    out["bn_stats"] = {k: v for k, v in sd.items() if "running" in k}
    out["state_dict"] = sd
    return out


def _ragged(cfg: dict, mesh, device, batch: int) -> dict:
    """One ragged global batch (its last two rows weight 0): this rank's
    part of the trainer's loss and the rank's own weighted mean, the
    reduction a mean of per-rank means would take."""
    frames, _, _ = _data(device, batch)
    tr = _trainer(dict(cfg, regularization=0.0), mesh, device, SEED)
    starts = torch.arange(batch, device=device) % (FRAMES - SEQ)
    w = torch.ones(batch, device=device)
    w[-2:] = 0.0
    tr.model.eval()
    with torch.no_grad():
        s, ww, total = tr._shard(starts, w)
        return {"part": float(tr._train_loss(frames, s, ww, total=total)),
                "own_mean": float(tr._train_loss(frames, s, ww)),
                "global": float(tr._train_loss(frames, starts, w))}


def rank_stanzas(mesh: DataMesh, cfg: dict, ar_cfg: dict,
                 bn_cfg: dict) -> dict:
    """Every stanza of the dry run on this rank; the twins run on rank 0.
    On gloo the steps run eagerly (no collective can be captured), and so
    do the twins', so that both sides take the same kernels."""
    dev = mesh.device
    if dev.type == "cpu":
        torch.set_num_threads(1)
    scan = mesh.backend != "gloo"
    batch = 4 * mesh.size
    one = DataMesh(None, 0, 1, [dev])
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend}
    for tag, reg, twin in (("off", 0.0, None),
                           ("dropout", cfg["regularization"], one)):
        run = dict(cfg, regularization=reg)
        ar_run = dict(ar_cfg, regularization=reg)
        out[tag] = {"mesh": _chain(run, ar_run, mesh, dev, batch, scan)}
        if mesh.rank == 0:
            out[tag]["twin"] = _chain(run, ar_run, twin, dev, batch, scan)
    out["bn"] = {"mesh": _bn_chain(bn_cfg, mesh, dev, batch, scan)}
    if mesh.rank == 0:
        out["bn"]["twin"] = _bn_chain(bn_cfg, None, dev, batch, scan)
    out["ragged"] = _ragged(cfg, mesh, dev, batch)
    frames, corpus, _ = _data(dev, batch)
    tr = _trainer(dict(cfg, regularization=0.0), mesh, dev, SEED)
    try:
        tr.train_epoch(corpus, frames, batch + 1, seed=0, scan=scan)
        out["indivisible"] = None
    except ValueError as e:
        out["indivisible"] = str(e)
    return out


def _diff(a, b, rtol: float = 0.0, atol: float = 0.0) -> float:
    """max |a - b| after asserting allclose(a, b, rtol, atol)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)
    return float(np.max(np.abs(a - b))) if a.size else 0.0


def check(results: list, say=print) -> dict:
    """Hold every rank's stanzas to rank 0's twins at ``TOL``; every rank
    must report the same reduced numbers and end with the same
    parameters. Returns {stanza: max-abs-diff}; raises AssertionError on a
    miss."""
    r0 = results[0]
    n = r0["size"]
    diffs = {}
    for tag, twin_name in (("off", "mesh=None"), ("dropout", "world 1")):
        m, t = r0[tag]["mesh"], r0[tag]["twin"]
        d = {"step": _diff(m["step"], t["step"], rtol=TOL["step"]),
             "epoch": _diff(m["epoch"], t["epoch"], rtol=TOL["epoch"]),
             "params": max(_diff(m["params"][k], t["params"][k],
                                 atol=TOL["params"]) for k in m["params"]),
             "grouped": max(_diff(m["grouped"][i], t["grouped"][i],
                                  rtol=TOL["grouped"]) for i in (0, 1)),
             "ar": _diff(m["ar"], t["ar"], rtol=TOL["ar"]),
             "fused": _diff(m["fused"], t["fused"], rtol=TOL["fused"]),
             "clip": _diff(m["clip"], t["clip"], atol=TOL["clip"])}
        np.testing.assert_array_equal(m["grouped"][2], t["grouped"][2])
        for r in results[1:]:  # the same reduced numbers on every rank
            o = r[tag]["mesh"]
            for k in ("step", "epoch", "ar", "fused", "clip"):
                np.testing.assert_array_equal(o[k], m[k], err_msg=k)
            for k, v in o["params"].items():
                torch.testing.assert_close(v, m["params"][k], rtol=0, atol=0)
        assert m["writer"] and not any(r[tag]["mesh"]["writer"]
                                       for r in results[1:])
        say(f"dryrun({n} ranks, {r0['backend']}) "
            f"{'dropout off' if tag == 'off' else 'dropout on'} against the "
            f"{twin_name} twin: max-abs-diff step {d['step']:.2e}, epoch "
            f"{d['epoch']:.2e}, params {d['params']:.2e}, grouped sums "
            f"{d['grouped']:.2e} (counts exact), AR epoch {d['ar']:.2e}, "
            f"fused 2 epochs {d['fused']:.2e}, always-clipped epoch's "
            f"params {d['clip']:.2e}")
        diffs.update({f"{tag} {k}": v for k, v in d.items()})
    m, t = r0["bn"]["mesh"], r0["bn"]["twin"]
    d_loss = _diff(m["bn_ar"], t["bn_ar"], rtol=TOL["bn_ar"])
    d_stats = {key: max(_diff(m[key][k], t[key][k], atol=TOL[key] * float(
        t[key][k].abs().max())) for k in m[key])
        for key in ("bn_first", "bn_stats")}
    for r in results[1:]:
        for key in ("bn_first", "bn_stats"):
            for k, v in r["bn"]["mesh"][key].items():
                torch.testing.assert_close(v, m[key][k], rtol=0, atol=0)
    say(f"dryrun({n} ranks) BatchNorm autoregressive model against "
        f"mesh=None: running stats after one forward max-abs-diff "
        f"{d_stats['bn_first']:.2e}; losses (tf, closed loop, val) "
        f"{d_loss:.2e}, running stats after them {d_stats['bn_stats']:.2e}")
    diffs.update({"bn losses": d_loss, "bn first": d_stats["bn_first"],
                  "bn stats": d_stats["bn_stats"]})
    parts = [r["ragged"] for r in results]
    glob = parts[0]["global"]
    d = _diff(sum(p["part"] for p in parts), glob, rtol=TOL["step"])
    mean_of_means = float(np.mean([p["own_mean"] for p in parts]))
    assert abs(mean_of_means - glob) > TOL["step"] * abs(glob), (
        "the ragged batch does not tell the global mean from a mean of "
        "per-rank means")
    say(f"dryrun({n} ranks) ragged batch: ranks' parts sum to the global "
        f"weighted mean (diff {d:.2e}); a mean of per-rank means is off by "
        f"{abs(mean_of_means - glob):.2e}")
    diffs["ragged"] = d
    for r in results:
        msg = r["indivisible"]
        assert msg is not None and str(4 * n + 1) in msg and str(n) in msg, msg
    return diffs


def spread_predict(state_dict: dict, cfg: dict, devices: list,
                   rows: int, say=print) -> float:
    """[4'] ``Predictor(mesh=make_mesh(devices), fused_max_batch=0)`` on
    ``rows`` rows against the plain forward."""
    from ..serving import Predictor

    pred = Predictor(ConvMixer(**cfg), state_dict, device=devices[0],
                     mesh=make_mesh(devices), fused_max_batch=0)
    x = torch.from_numpy(np.random.RandomState(SEED + 4).randn(
        rows, cfg["in_nTP"], cfg["dimPosIn"]).astype(np.float32))
    with torch.no_grad():
        y = pred.predict(x)
        want = pred.model(x.to(pred.device))
    assert y.shape == want.shape and bool(torch.isfinite(y).all())
    d = _diff(y.cpu(), want.cpu(), atol=TOL["predict"])
    say(f"dryrun Predictor(mesh={len(devices)} devices) bulk batch {rows} "
        f"against the plain forward: max-abs-diff {d:.2e}")
    return d


def placed_paths(state_dict: dict, cfg: dict, devices: list,
                 say=print) -> None:
    """[6] ``Study.optimize(devices=)``: trial i runs on devices[i % n];
    [7] ``BatchingPredictor(devices=)``: one worker a device."""
    from ..serving import Predictor
    from ..serving_server import BatchingPredictor
    from ..sweep import RandomSampler, Study

    n = len(devices)
    x = np.random.RandomState(SEED + 6).randn(2, cfg["in_nTP"],
                                              cfg["dimPosIn"]).astype(np.float32)
    placed = []

    def objective(trial):
        lr = trial.suggest_float("lr", 1e-4, 1e-2, log=True)
        model = ConvMixer(**cfg).to(trial.device).eval()
        model.load_state_dict(state_dict)
        with torch.no_grad():
            out = model(torch.from_numpy(x).to(trial.device))
        placed.append(str(out.device))
        return float(out.mean()) + lr

    study = Study("dryrun", sampler=RandomSampler(seed=0))
    study.optimize(objective, n_trials=2 * n,
                   devices=[torch.device(d) for d in devices])
    assert len(study.trials) == 2 * n
    assert set(placed) == {str(torch.device(d)) for d in devices}, placed
    say(f"dryrun device-placed sweep: {2 * n} trials round-robin over "
        f"{n} devices")
    pred = Predictor(ConvMixer(**cfg), state_dict, device=devices[0],
                     fused_max_batch=0)
    batcher = BatchingPredictor(pred, max_batch=8, max_wait_ms=1.0,
                                devices=devices)
    try:
        ys = [batcher.predict(x, timeout=300.0) for _ in range(2 * n)]
        assert all(tuple(y.shape) == (2, cfg["out_nTP"], cfg["dimPosOut"])
                   for y in ys)
        served = batcher.stats()["device_batches"]
        assert sum(served.values()) == 2 * n, served
    finally:
        batcher.close()
    say(f"dryrun replicated serving: {2 * n} requests over {n} workers "
        f"({served})")


def run(nproc: int, backend: Optional[str] = None, dev: str = "cuda",
        cfg: dict = FLAGSHIP, ar_cfg: dict = AR_MODEL,
        bn_cfg: dict = BN_MODEL, say=print) -> dict:
    """The whole dry run; returns {"diffs", "results"} (rank 0's results
    first) or raises AssertionError."""
    results = launch(rank_stanzas, nproc, backend, dev,
                     args=(cfg, ar_cfg, bn_cfg))
    diffs = check(results, say)
    d = torch.device(dev)  # the ranks' devices, as launch placed them
    devices = ([f"cuda:{r}" for r in range(nproc)]
               if d.type == "cuda" and d.index is None else [dev] * nproc)
    trained = results[0]["off"]["mesh"]["params"]
    diffs["predict"] = spread_predict(trained, dict(cfg, regularization=0.0),
                                      devices, 3 * nproc - 1, say)
    placed_paths(trained, dict(cfg, regularization=0.0), devices, say)
    return {"diffs": diffs, "results": results}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nproc", type=int, default=2)
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="default: nccl on cards, gloo on the CPU")
    p.add_argument("--dev", default="cuda",
                   help="'cuda' (rank r on cuda:r), 'cuda:0' (every rank "
                        "there) or 'cpu'")
    args = p.parse_args(argv)
    if torch.device(args.dev).type == "cuda" and not torch.cuda.is_available():
        print("dryrun: torch sees no CUDA device; pass --dev cpu",
              file=sys.stderr)
        return 2
    try:
        run(args.nproc, args.backend, args.dev)
    except AssertionError as e:
        print(f"dryrun FAILED: {e}", file=sys.stderr)
        return 1
    print(f"dryrun({args.nproc} ranks) ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())

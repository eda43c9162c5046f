"""Production serving: dynamic micro-batching HTTP server around a Predictor.

Counterpart of ``motionmixerconv_tpu/serving_server.py``. Concurrent client
requests are coalesced by a batcher thread per device: requests queue up, a
worker drains up to ``max_batch`` rows (waiting at most ``max_wait_ms`` for
stragglers), pads them to a fixed bucket, runs ONE ``Predictor.predict``
(the model's fused kernel at small batches, the plain forward above) and
scatters the rows back to the waiting clients.

Transport is a dependency-free ``ThreadingHTTPServer``:

- ``POST /predict``                 {"inputs": [[[...]...]]}  (B, T, D)
- ``POST /predict_autoregressive``  {"inputs": ..., "horizon": N}
- ``GET  /healthz``                 liveness + device info
- ``GET  /stats``                   requests/batches/mean batch size/latency

Run: ``python -m motionmixerconv_tpu_torch.serving_server --model_path m.pt``
(a ``train_state.pt``, or a JAX ``.ckpt`` with meta, rebuilds its model,
ConvMixer or MlpMixer, from the stored training args; a bare state_dict or
a ``.ckpt`` without meta takes the shape flags, with ``--arch mlp`` for an
MlpMixer).
"""

from __future__ import annotations

import contextlib
import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch


def to_numpy(out) -> np.ndarray:
    """A prediction (tensor on any device, or array) as a host array."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


@dataclass
class _Pending:
    x: np.ndarray                       # (b_i, T, D)
    event: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[Exception] = None
    # set by a timed-out client; workers drop abandoned items instead of
    # spending device calls on results nobody will read
    abandoned: bool = False


class BatchingPredictor:
    """Coalesces concurrent ``predict`` calls into single device calls.

    Thread-safe; ``predict`` blocks until a worker has served the request.
    ``max_batch`` bounds rows per call (the Predictor's fused-kernel window
    by default); ``max_wait_ms`` is the straggler window once at least one
    request is pending. Waves are zero-padded to power-of-two buckets
    (8, 16, ..., max_batch) so every call has one of a few shapes;
    ``warmup(input_shape)`` runs each bucket once up front (kernel build,
    allocator and cuBLAS warm-up happen before the first client).

    ``devices``: optional list of torch devices for replication — one worker
    per card, each with its own parameter replica
    (``Predictor.replicate_to``), all pulling waves from the shared queue.
    """

    def __init__(self, predictor, *, max_batch: int = 128,
                 max_wait_ms: float = 2.0, devices=None):
        self._predictor = predictor
        self.devices = list(devices) if devices else None
        if self.devices:
            self._workers = [(predictor.replicate_to(d), d)
                             for d in self.devices]
        else:
            self._workers = [(predictor, None)]
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1e3
        self.buckets = []
        b = 8
        while b < max_batch:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(max_batch)
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._parked: dict = {}  # thread-id -> held item (single worker)
        self._stats_lock = threading.Lock()
        self.n_requests = 0
        self.n_rows = 0
        self.n_batches = 0
        self.bucket_counts: dict = {}
        self.device_batches: dict = {}
        self.latency_sum = 0.0
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._loop, args=(p, d), daemon=True)
            for p, d in self._workers
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------- client API

    def predict(self, x: np.ndarray, timeout: Optional[float] = None) -> np.ndarray:
        """(b, T, D) -> (b, P, D); blocks until served (coalesced).
        ``timeout`` (seconds): raise TimeoutError instead of waiting forever."""
        t0 = time.perf_counter()
        item = _Pending(np.asarray(x, np.float32))
        self._queue.put(item)
        if not item.event.wait(timeout):
            item.abandoned = True  # workers drop it instead of serving it
            raise TimeoutError(
                f"predict not served within {timeout}s "
                f"(queue depth {self._queue.qsize()})")
        if item.error is not None:
            raise item.error
        with self._stats_lock:
            self.n_requests += 1
            self.n_rows += item.x.shape[0]
            self.latency_sum += time.perf_counter() - t0
        return item.result

    def stats(self) -> dict:
        with self._stats_lock:
            n = max(self.n_requests, 1)
            return {
                "requests": self.n_requests,
                "rows": self.n_rows,
                "batches": self.n_batches,
                "mean_batch_rows": self.n_rows / max(self.n_batches, 1),
                "bucket_counts": dict(self.bucket_counts),
                "device_batches": dict(self.device_batches),
                "mean_latency_ms": self.latency_sum / n * 1e3,
            }

    def close(self):
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2.0)
        # unblock clients still queued OR parked on a worker, even when the
        # worker never exits (stuck in a wedged device call)
        leftovers = []
        with self._stats_lock:
            leftovers.extend(self._parked.values())
            self._parked.clear()
        while True:
            try:
                leftovers.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for item in leftovers:
            item.error = RuntimeError("BatchingPredictor closed")
            item.event.set()

    def _bucketed(self, rows: int) -> int:
        for b in self.buckets:
            if rows <= b:
                return b
        return rows  # above max_batch (single oversize request): exact shape

    def warmup(self, input_shape) -> None:
        """Run every bucket once ((T, D) per-row shape) on every replica,
        concurrently."""

        def warm_one(predictor, device):
            with self._device_ctx(device):
                for b in self.buckets:
                    x = np.zeros((b,) + tuple(input_shape), np.float32)
                    to_numpy(predictor.predict(x))

        if len(self._workers) == 1:
            warm_one(*self._workers[0])
            return
        errs = []

        def guarded(p, d):
            try:
                warm_one(p, d)
            except Exception as e:  # re-raised below in the caller
                errs.append(e)

        ts = [threading.Thread(target=guarded, args=w, daemon=True)
              for w in self._workers]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if errs:
            raise errs[0]

    # ---------------------------------------------------------------- batcher

    @staticmethod
    def _device_ctx(device):
        if device is None or torch.device(device).type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.device(device)

    def _park(self, held):
        """Track a worker's held item so close() can unblock its client even
        if the worker never exits."""
        with self._stats_lock:
            if held is None:
                self._parked.pop(threading.get_ident(), None)
            else:
                self._parked[threading.get_ident()] = held

    def _drain(self, held):
        """Block for one request, then sweep stragglers up to max_batch.

        A swept request that would push the wave past max_batch does not
        join it: with replicas it goes back on the shared queue, a lone
        worker keeps it for its next wave (``held``). Abandoned items are
        dropped unserved. Returns ``(items, held)``.
        """
        if held is not None:
            first, held = held, None
            self._park(None)
            if first.abandoned:
                first = None
        else:
            first = None
        while first is None:
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                return [], None
            if first.abandoned:
                first = None
        items, rows = [first], first.x.shape[0]
        deadline = time.perf_counter() + self.max_wait
        while rows < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt.abandoned:
                continue
            if rows + nxt.x.shape[0] > self.max_batch:
                if len(self._workers) > 1:
                    self._queue.put(nxt)  # an idle replica steals it
                else:
                    held = nxt
                    self._park(held)
                break
            items.append(nxt)
            rows += nxt.x.shape[0]
        return items, held

    def _loop(self, predictor, device):
        held = None
        while not self._stop.is_set():
            items, held = self._drain(held)
            # a request can time out between the sweep and the device call
            items = [it for it in items if not it.abandoned]
            if not items:
                continue
            bucket = 0
            try:
                x = np.concatenate([it.x for it in items], axis=0)
                bucket = self._bucketed(x.shape[0])
                if bucket > x.shape[0]:
                    pad = np.zeros((bucket - x.shape[0],) + x.shape[1:],
                                   x.dtype)
                    x = np.concatenate([x, pad], axis=0)
                with self._device_ctx(device):
                    out = to_numpy(predictor.predict(x))
                off = 0
                for it in items:
                    it.result = out[off: off + it.x.shape[0]]
                    off += it.x.shape[0]
            except Exception as e:  # propagate to every waiter in the batch
                for it in items:
                    it.error = e
            finally:
                with self._stats_lock:
                    self.n_batches += 1
                    self.bucket_counts[bucket] = \
                        self.bucket_counts.get(bucket, 0) + 1
                    if device is not None:
                        k = str(device)
                        self.device_batches[k] = \
                            self.device_batches.get(k, 0) + 1
                for it in items:
                    it.event.set()
        if held is not None:  # drained but never served before shutdown
            self._park(None)
            held.error = RuntimeError("BatchingPredictor closed")
            held.event.set()


def make_handler(batcher: BatchingPredictor, predictor):
    """HTTP handler bound to a batcher (predict) + raw predictor (rollout)."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; stats live at /stats
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, {"status": "ok",
                                 "device": predictor.device_name,
                                 "n_devices": torch.cuda.device_count()})
            elif self.path == "/stats":
                self._send(200, batcher.stats())
            else:
                self._send(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length))
                x = np.asarray(req["inputs"], np.float32)
                if x.ndim != 3:
                    raise ValueError(f"inputs must be (B, T, D), got {x.shape}")
                if self.path == "/predict":
                    out = batcher.predict(x)
                elif self.path == "/predict_autoregressive":
                    out = to_numpy(predictor.predict_autoregressive(
                        x, horizon=int(req["horizon"]),
                        step_window=req.get("step_window")))
                else:
                    self._send(404, {"error": f"unknown path {self.path}"})
                    return
                self._send(200, {"outputs": out.tolist()})
            except Exception as e:  # the client gets the error as a 400
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


class PredictionServer:
    """HTTP wrapper: serve_forever in the caller's thread or background."""

    def __init__(self, predictor, host: str = "127.0.0.1", port: int = 8476,
                 *, max_batch: int = 128, max_wait_ms: float = 2.0,
                 warmup: bool = False, devices=None):
        self.batcher = BatchingPredictor(
            predictor, max_batch=max_batch, max_wait_ms=max_wait_ms,
            devices=devices)
        if warmup:
            from .serving import model_io

            in_n, _, dim = model_io(predictor.model)
            self.batcher.warmup((in_n, dim))
        self.httpd = ThreadingHTTPServer(
            (host, port), make_handler(self.batcher, predictor))
        self.port = self.httpd.server_address[1]

    def serve_forever(self):
        self.httpd.serve_forever()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()


def build_parser():
    import argparse

    ap = argparse.ArgumentParser(description="Serve a trained model over HTTP "
                                             "with dynamic micro-batching.")
    ap.add_argument("--model_path", required=True,
                    help=".pt: a trainer's train_state.pt or a reference "
                         "torch state_dict; any other name: a JAX .ckpt")
    ap.add_argument("--arch", choices=["auto", "conv", "mlp"], default="auto",
                    help="auto rebuilds the architecture from the stored "
                         "training args of a train_state.pt or a .ckpt, "
                         "falling back to the flags below (conv) for a "
                         "file without them; mlp builds an MlpMixer from "
                         "the flags")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8476)
    ap.add_argument("--max_batch", type=int, default=128)
    ap.add_argument("--max_wait_ms", type=float, default=2.0)
    ap.add_argument("--replicas", type=int, default=0,
                    help="replicate serving across cuda:0..N-1 (each with its "
                         "own parameter copy, pulling from the shared "
                         "request queue); 0 = the current CUDA device")
    # shape flags (reference CLI defaults: the flagship H36M ConvMixer;
    # train_mixer_amass.py's MlpMixer takes --arch mlp --pose_dim 54
    # --num_blocks 5 --hidden_dim 128 --activation gelu)
    ap.add_argument("--input_n", type=int, default=10)
    ap.add_argument("--output_n", type=int, default=25)
    ap.add_argument("--pose_dim", type=int, default=66)
    ap.add_argument("--num_blocks", type=int, default=4)
    ap.add_argument("--hidden_dim", type=int, default=50)
    ap.add_argument("--conv_nChan", type=int, default=1)
    ap.add_argument("--kernel_x", type=int, default=1)
    ap.add_argument("--kernel_y", type=int, default=3)
    ap.add_argument("--tokens_mlp_dim", type=int, default=20)
    ap.add_argument("--channels_mlp_dim", type=int, default=128)
    ap.add_argument("--activation", default="mish")
    ap.add_argument("--n_harmonic_functions", type=int, default=64)
    return ap


def model_from_args(args) -> "torch.nn.Module":
    """The model the serving CLI builds from its shape flags: an MlpMixer
    with ``--arch mlp`` (the AMASS trainer's regularization, SE r 8), a
    ConvMixer otherwise."""
    if args.arch == "mlp":
        from .models.mixer_mlp import MlpMixer

        return MlpMixer(
            num_classes=args.pose_dim, num_blocks=args.num_blocks,
            hidden_dim=args.hidden_dim, tokens_mlp_dim=args.tokens_mlp_dim,
            channels_mlp_dim=args.channels_mlp_dim, seq_len=args.input_n,
            pred_len=args.output_n, activation=args.activation,
            regularization=0.1, input_size=args.pose_dim, r_se=8,
            use_se=True)
    from .models.mixer_conv import ConvMixer

    return ConvMixer(
        num_blocks=args.num_blocks, dimPosIn=args.pose_dim,
        dimPosEmb=args.hidden_dim, dimPosOut=args.pose_dim,
        in_nTP=args.input_n, out_nTP=args.output_n,
        conv_nChan=args.conv_nChan,
        conv1_kernel_shape=(args.kernel_x, args.kernel_y),
        conv1_stride=(1, 1), conv1_padding=(0, 1), mode_conv="twice",
        activation=args.activation, regularization=0.1, use_se=True,
        r_se=8, encoder_n_harmonic_functions=args.n_harmonic_functions,
        encoder_omega0=0.1,
    )


def load_predictor(args, device):
    """The Predictor the serving CLI serves on ``device``: with ``--arch
    auto`` a ``train_state.pt`` or a ``.ckpt`` with meta rebuilds its model
    from the stored training args (JAX serving_server.py:439-447);
    otherwise, and for a file without them, the model comes from the shape
    flags."""
    from .serving import Predictor

    if args.arch == "auto":
        return Predictor.from_checkpoint(
            None, args.model_path, model_factory=lambda: model_from_args(args),
            device=device)
    return Predictor.from_checkpoint(model_from_args(args), args.model_path,
                                     device=device)


def main(argv: Optional[list] = None) -> None:
    """CLI: serve a checkpoint on the card. Model flags mirror the reference
    defaults."""
    args = build_parser().parse_args(argv)
    from .serving import resolve_device

    devices = None
    device = resolve_device("cuda")
    if args.replicas >= 1:
        n = torch.cuda.device_count()
        if args.replicas > n:
            raise SystemExit(
                f"--replicas {args.replicas} exceeds the {n} visible devices")
        devices = [torch.device(f"cuda:{i}") for i in range(args.replicas)]
        device = devices[0]
    predictor = load_predictor(args, device)
    print("warming up (every batch bucket"
          + (f" on {len(devices)} replicas" if devices else "") + ")...",
          flush=True)
    server = PredictionServer(predictor, args.host, args.port,
                              max_batch=args.max_batch,
                              max_wait_ms=args.max_wait_ms, warmup=True,
                              devices=devices)
    from .models.mixer_mlp import MlpMixer

    family = "mlp" if isinstance(predictor.model, MlpMixer) else "conv"
    print(f"serving {family} model on http://{args.host}:{server.port} "
          f"(device={predictor.device_name}, max_batch={args.max_batch}, "
          f"buckets={server.batcher.buckets}"
          + (f", replicas={len(devices)}" if devices else "") + ")",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.close()


if __name__ == "__main__":
    main()

"""HTTP serving daemon around an exported detector (``multibox-torch-serve``).

Own copy of the JAX package's ``serve.py``, pointed at this package's
``serving.load_exported`` and ``data/jpeg`` (PIL). A small,
dependency-free (stdlib ``http.server``) daemon that loads a
``multibox-torch-export`` directory and serves detections over HTTP, with
micro-batching:

* **Micro-batching**: concurrent requests are coalesced by a single device
  worker thread — up to the largest exported batch size, waiting at most
  ``--batch_window_ms`` for stragglers. One program call per group, and
  ``ExportedDetector.__call__``'s multi-size dispatch pads only the tail.
* **One device owner**: every PyTorch call happens on the worker thread;
  HTTP handler threads only decode JPEG bytes and wait on their slot's
  event.

Endpoints:
  GET  /healthz            → {"status": "ok", "batch_sizes": [...], ...}
  GET  /stats              → request/batch counters (batching observability)
  POST /detect             → body = one JPEG/PNG image; query params:
                             ``threshold`` (default cfg's), ``top`` (max
                             boxes returned)
  POST /detect_batch       → JSON {"images": [<base64>, ...]}
Responses are JSON with normalized [ymin, xmin, ymax, xmax] boxes.
Overload: beyond ``max_queue_depth`` outstanding requests the daemon sheds
load with 429 + a Retry-After hint instead of queueing into unbounded p99
(ServiceOverloaded).
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np


class ServiceOverloaded(RuntimeError):
    """Admission control: outstanding requests are at ``max_queue_depth``.

    Raised by ``submit_async`` BEFORE enqueueing, so saturation degrades
    flat (clients get an immediate 429 + Retry-After and can back off or
    be rerouted) instead of every request queueing into seconds of p99
    (the JAX package measured that on a TPU behind a relay; not measured
    on the GPU)."""


class _Pending:
    """One image awaiting the batcher: filled by the worker, waited on by
    the handler thread."""

    __slots__ = ("image", "event", "result", "error")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.event = threading.Event()
        self.result: Optional[Dict[str, np.ndarray]] = None
        self.error: Optional[BaseException] = None


class DetectorService:
    """Micro-batching wrapper: many callers, one device worker."""

    # The JAX package's default, kept for parity: there it was chosen on a
    # TPU behind a relay with ~30 ms a dispatch, to cover that overhead. On
    # the GPU the window is a reading only (chip_smoke.py's serve phase
    # prints 40 and 2 ms); a different default waits for a benchmark.
    DEFAULT_WINDOW_MS = 40.0

    # Admission cap on OUTSTANDING requests (queued + in the group being
    # executed): admitted-request p99 tracks depth / service rate, so pick
    # depth ≈ service_rate × target_p99. Two batches' worth is the JAX
    # package's default (chosen on a TPU); 0/None disables.
    DEFAULT_MAX_QUEUE_FACTOR = 2  # default depth = factor * max_batch

    def __init__(self, detector, max_batch: int = None,
                 batch_window_ms: float = DEFAULT_WINDOW_MS,
                 warmup: bool = True, max_queue_depth: Optional[int] = None):
        self.detector = detector
        sizes = sorted(detector.calls) or [detector.batch_size]
        self.max_batch = max_batch or max(sizes)
        self.batch_window_s = batch_window_ms / 1e3
        self.input_size = detector.input_size
        if max_queue_depth is None:
            max_queue_depth = self.DEFAULT_MAX_QUEUE_FACTOR * self.max_batch
        self.max_queue_depth = max_queue_depth  # 0 = unbounded
        self._outstanding = 0
        self._adm_lock = threading.Lock()
        self._q: queue.Queue = queue.Queue()
        self.stats = {"requests": 0, "device_batches": 0, "images": 0,
                      "rejected": 0}
        self._closed = False
        self._warmup = warmup
        self.ready = threading.Event()  # set once warmup compiles finish
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def close(self):
        self._closed = True
        self._q.put(None)
        self._worker.join(timeout=5)

    def submit_async(self, image: np.ndarray) -> _Pending:
        """Enqueue one preprocessed ``[S, S, 3]`` float32 image; the caller
        waits on the returned pending's event (``wait``). Submitting a
        whole request's images BEFORE waiting lets the batcher coalesce
        them into one device call.

        Raises ``ServiceOverloaded`` (HTTP 429 at the daemon surface) when
        ``max_queue_depth`` requests are already outstanding."""
        with self._adm_lock:
            if self.max_queue_depth and self._outstanding >= self.max_queue_depth:
                self.stats["rejected"] += 1
                raise ServiceOverloaded(
                    f"{self._outstanding} requests outstanding (cap "
                    f"max_queue_depth={self.max_queue_depth})"
                )
            self._outstanding += 1
        p = _Pending(image)
        self.stats["requests"] += 1
        self._q.put(p)
        return p

    @property
    def queue_depth(self) -> int:
        """Outstanding requests right now (queued + executing group)."""
        with self._adm_lock:
            return self._outstanding

    @staticmethod
    def wait(p: _Pending, timeout: float = 60.0):
        if not p.event.wait(timeout):
            raise TimeoutError("detector worker did not respond")
        if p.error is not None:
            raise p.error
        return p.result

    def submit(self, image: np.ndarray, timeout: float = 60.0):
        """Enqueue one image and block until its detections are ready."""
        return self.wait(self.submit_async(image), timeout)

    def _collect(self) -> List[_Pending]:
        """Block for the first request, then soak up stragglers for the
        batch window (or until the group fills)."""
        first = self._q.get()
        if first is None:
            return []
        group = [first]
        deadline = time.monotonic() + self.batch_window_s
        while len(group) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                item = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if item is None:
                break
            group.append(item)
        return group

    def _run(self):
        # Warmup on the worker thread (the single device owner): run every
        # exported batch-size program BEFORE serving traffic, so that the
        # first group of each size pays no first-call cost. Requests
        # submitted during warmup simply queue.
        if self._warmup and hasattr(self.detector, "warmup"):
            self.detector.warmup()
        self.ready.set()
        while not self._closed:
            group = self._collect()
            if not group:
                continue
            try:
                batch = np.stack([p.image for p in group])
                out = self.detector(batch)  # multi-size dispatch + padding
                self.stats["device_batches"] += 1
                self.stats["images"] += len(group)
                for i, p in enumerate(group):
                    p.result = {k: np.asarray(v[i]) for k, v in out.items()}
            except BaseException as e:  # surfaced to every waiting caller
                for p in group:
                    p.error = e
            finally:
                for p in group:
                    p.event.set()
                with self._adm_lock:
                    self._outstanding -= len(group)


def _decode_request_image(data: bytes, input_size: int) -> np.ndarray:
    """Image bytes → ``[S, S, 3]`` float32 in [-1, 1] (slim scaling), the
    exported program's input contract."""
    from multibox_tpu_torch.data import jpeg as jpeg_mod

    img = jpeg_mod.decode_jpeg(data, canvas=input_size)
    return (img.astype(np.float32) / 255.0 - 0.5) * 2.0


def _detections_json(result: Dict[str, np.ndarray], threshold: float,
                     top: int) -> Dict:
    n = int(result["num"])
    scores = np.asarray(result["scores"])[:n]
    keep = scores >= threshold
    boxes = np.asarray(result["boxes"])[:n][keep][:top]
    scores = scores[keep][:top]
    classes = np.asarray(result["classes"])[:n][keep][:top]
    return {
        "boxes": boxes.tolist(),
        "scores": scores.tolist(),
        "classes": classes.astype(int).tolist(),
    }


def make_server(export_dir: str, host: str = "127.0.0.1", port: int = 8000,
                max_batch: int = None,
                batch_window_ms: float = DetectorService.DEFAULT_WINDOW_MS,
                class_names: List[str] = None,
                max_queue_depth: Optional[int] = None,
                device=None) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server — tests drive it in-process
    via ``serve_forever`` on a thread. ``device=None`` serves on the CUDA
    device (raises without one), as every entry point."""
    from multibox_tpu_torch.serving import load_exported

    detector = load_exported(export_dir, device=device)
    service = DetectorService(
        detector, max_batch=max_batch, batch_window_ms=batch_window_ms,
        max_queue_depth=max_queue_depth,
    )
    default_threshold = float(
        getattr(detector.config, "detect_score_threshold", 0.01)
    )
    sizes = sorted(detector.calls)

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 so client connections are keep-alive by default: every
        # response carries Content-Length (see _send), which 1.1 requires
        # for persistent connections. Under HTTP/1.0 each request paid a
        # fresh TCP connect, and connect bursts at high concurrency
        # overflowed the accept backlog into resets (seen by the JAX
        # package at 32 clients).
        protocol_version = "HTTP/1.1"

        # quiet by default; --verbose flips this in main()
        def log_message(self, fmt, *args):
            pass

        def _send(self, code: int, payload: Dict, headers: Dict = None):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _params(self):
            q = parse_qs(urlparse(self.path).query)
            thr = float(q.get("threshold", [default_threshold])[0])
            top = int(q.get("top", [100])[0])
            return thr, top

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                self._send(200, {
                    # "warming" until the warmup finishes — load
                    # balancers should gate traffic on status == "ok"
                    "status": "ok" if service.ready.is_set() else "warming",
                    "batch_sizes": sizes,
                    "input_size": service.input_size,
                    "num_priors": int(detector.priors.shape[0]),
                })
            elif path == "/stats":
                self._send(200, {**service.stats,
                                 "queue_depth": service.queue_depth,
                                 "max_queue_depth": service.max_queue_depth})
            else:
                self._send(404, {"error": f"unknown path {path}"})

        def do_POST(self):
            path = urlparse(self.path).path
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            try:
                thr, top = self._params()
                if path == "/detect":
                    image = _decode_request_image(data, service.input_size)
                    result = service.submit(image)
                    payload = _detections_json(result, thr, top)
                    if class_names:
                        payload["class_names"] = [
                            class_names[c] if 0 <= c < len(class_names)
                            else str(c)
                            for c in payload["classes"]
                        ]
                    self._send(200, payload)
                elif path == "/detect_batch":
                    req = json.loads(data)
                    images = [
                        _decode_request_image(
                            base64.b64decode(b), service.input_size
                        )
                        for b in req["images"]
                    ]
                    # enqueue ALL, then wait: the batcher coalesces the
                    # whole request into as few device calls as possible
                    pendings = [service.submit_async(im) for im in images]
                    results = [service.wait(p) for p in pendings]
                    self._send(200, {
                        "results": [
                            _detections_json(r, thr, top) for r in results
                        ]
                    })
                else:
                    self._send(404, {"error": f"unknown path {path}"})
            except ServiceOverloaded as e:
                # admission control: shed load NOW with a backoff hint
                # sized to one drain of the queue (depth/max_batch
                # dispatches, each ~window + a step) rather than queue
                # into unbounded latency. Not a client error and not a
                # dead server: 429.
                retry_s = max(
                    1, round(service.max_queue_depth / service.max_batch
                             * (service.batch_window_s + 0.05))
                )
                self._send(429, {"error": str(e)},
                           headers={"Retry-After": str(retry_s)})
            except TimeoutError as e:
                # server-side condition (device worker overloaded/stalled),
                # not a bad request — clients/load balancers may retry
                self._send(503, {"error": f"{type(e).__name__}: {e}"})
            except Exception as e:  # a bad request must not kill the daemon
                self._send(400, {"error": f"{type(e).__name__}: {e}"})

    class Server(ThreadingHTTPServer):
        # The stdlib listen backlog is 5; a burst of N>5 simultaneous
        # connects (load spike, bench ramp) gets TCP RSTs before a handler
        # ever runs. Keep-alive makes connects rare, but the first burst
        # still has to land.
        request_queue_size = 128

    server = Server((host, port), Handler)
    server.service = service  # tests reach the batcher through this
    return server

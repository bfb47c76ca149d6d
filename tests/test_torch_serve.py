"""The port's HTTP daemon (``serve.py``, ``multibox-torch-serve``):
endpoints, micro-batching, admission control and error paths, as the JAX
package's tests/test_serve.py drives its daemon.

The real ThreadingHTTPServer runs in-process on a loopback port over a tiny
exported detector (MobileNetV2 0.5 at 75 px, 16 priors, programs at batch
sizes 1 and 4), on the CPU (``device="cpu"``).
"""

import base64
import json
import shutil
import threading
import urllib.request

import numpy as np
import pytest
import torch

from multibox_tpu_torch.cli import export as cli_export
from multibox_tpu_torch.config import Config
from multibox_tpu_torch.inference import build_model
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_served")
    rng = np.random.default_rng(0)
    priors = np.sort(rng.uniform(0.05, 0.95, (16, 2, 2)).astype(np.float32),
                     axis=1).reshape(16, 4)
    cfg = Config(input_size=75, num_priors=16, compute_dtype="float32", max_detections=5,
                 detect_score_threshold=0.0, backbone="mobilenet_v2", mobilenet_width=0.5)
    model = build_model(cfg, 16, device="cpu")
    variables = model.init_variables(torch.Generator().manual_seed(0))
    out_dir = str(root / "export")
    cli_export.export_detector(cfg, model, variables, priors, out_dir, [1, 4], "cpu")
    yield out_dir
    shutil.rmtree(root, ignore_errors=True)


@pytest.fixture(scope="module")
def server(export_dir):
    from multibox_tpu_torch.serve import make_server

    srv = make_server(export_dir, port=0, batch_window_ms=40.0, device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    yield srv, base
    srv.shutdown()
    srv.service.close()
    srv.server_close()


def _jpeg_bytes(seed=0, size=75):
    from multibox_tpu_torch.data.jpeg import encode_jpeg

    rng = np.random.default_rng(seed)
    return encode_jpeg(rng.integers(0, 255, (size, size, 3)).astype(np.uint8))


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


def _post(url, data, headers=None):
    req = urllib.request.Request(url, data=data, headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_healthz(server):
    srv, base = server
    status, body = _get(base + "/healthz")
    assert status == 200
    # daemon reports "warming" until the startup compiles finish, then "ok"
    # (load balancers gate traffic on it) — wait for warmup to observe "ok"
    assert body["status"] in ("ok", "warming")
    assert srv.service.ready.wait(120)
    status, body = _get(base + "/healthz")
    assert status == 200
    assert body["status"] == "ok"
    assert body["batch_sizes"] == [1, 4]
    assert body["input_size"] == 75


def test_detect_single_image(server):
    _, base = server
    status, body = _post(base + "/detect?threshold=0.0", _jpeg_bytes())
    assert status == 200
    assert len(body["boxes"]) == len(body["scores"]) == len(body["classes"])
    assert len(body["boxes"]) > 0
    for box in body["boxes"]:
        assert len(box) == 4 and all(0.0 <= v <= 1.0 for v in box)
    # threshold filters
    status, none = _post(base + "/detect?threshold=1.1", _jpeg_bytes())
    assert status == 200 and none["boxes"] == []


def test_detect_batch_coalesces(server):
    srv, base = server
    before = dict(srv.service.stats)
    payload = json.dumps(
        {"images": [base64.b64encode(_jpeg_bytes(i)).decode()
                    for i in range(4)]}
    ).encode()
    status, body = _post(base + "/detect_batch?threshold=0.0", payload)
    assert status == 200 and len(body["results"]) == 4
    after = dict(srv.service.stats)
    assert after["requests"] - before["requests"] == 4
    # 4 images through a batch-4 export inside one 40ms window: ONE
    # device batch, not four (this is the point of the micro-batcher)
    assert after["device_batches"] - before["device_batches"] == 1


def test_concurrent_requests_share_batches(server):
    srv, base = server
    before = dict(srv.service.stats)
    results = [None] * 4

    def one(i):
        results[i] = _post(base + "/detect?threshold=0.0", _jpeg_bytes(i))

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(r[0] == 200 for r in results)
    after = dict(srv.service.stats)
    assert after["requests"] - before["requests"] == 4
    # 4 concurrent singles coalesce into at most 2 device batches
    assert after["device_batches"] - before["device_batches"] <= 2
    status, stats = _get(base + "/stats")
    assert status == 200 and stats["images"] >= after["images"] - 1


def test_bad_request_does_not_kill_daemon(server):
    _, base = server
    status, body = _post(base + "/detect", b"not an image")
    assert status == 400 and "error" in body
    status, body = _post(base + "/detect_batch", b"{bad json")
    assert status == 400 and "error" in body
    status, _ = _get(base + "/healthz")
    assert status == 200


def test_unknown_path_404(server):
    _, base = server
    status, body = _post(base + "/nope", b"")
    assert status == 404


class _SlowStubDetector:
    """Stands in for an ExportedDetector: holds the worker busy for
    ``delay`` seconds per dispatch so admission control is observable."""

    batch_size = 4
    input_size = 8
    calls = [4]

    def __init__(self, delay=0.15):
        self.delay = delay

    def warmup(self):
        pass

    def __call__(self, batch):
        import time

        time.sleep(self.delay)
        n = len(batch)
        return {
            "num": np.ones((n,), np.int32),
            "scores": np.full((n, 5), 0.9, np.float32),
            "boxes": np.tile([0.1, 0.1, 0.6, 0.6], (n, 5, 1)).astype(np.float32),
            "classes": np.zeros((n, 5), np.int32),
        }


def test_service_admission_control_rejects_then_recovers():
    from multibox_tpu_torch.serve import DetectorService, ServiceOverloaded

    svc = DetectorService(_SlowStubDetector(delay=0.3), max_batch=4,
                          batch_window_ms=400.0, max_queue_depth=2)
    try:
        img = np.zeros((8, 8, 3), np.float32)
        p1 = svc.submit_async(img)
        p2 = svc.submit_async(img)
        # depth cap reached: the third caller is shed immediately
        with pytest.raises(ServiceOverloaded):
            svc.submit_async(img)
        assert svc.stats["rejected"] == 1
        assert svc.queue_depth == 2
        # the admitted requests complete normally...
        assert svc.wait(p1, timeout=10)["num"] == 1
        assert svc.wait(p2, timeout=10)["num"] == 1
        # ...and once drained, admission reopens
        assert svc.queue_depth == 0
        p3 = svc.submit_async(img)
        assert svc.wait(p3, timeout=10)["num"] == 1
        assert svc.stats["rejected"] == 1  # no spurious rejects
    finally:
        svc.close()


def test_service_default_depth_and_unbounded_optout():
    from multibox_tpu_torch.serve import DetectorService

    svc = DetectorService(_SlowStubDetector(), max_batch=4, warmup=False)
    try:
        assert svc.max_queue_depth == 4 * DetectorService.DEFAULT_MAX_QUEUE_FACTOR
    finally:
        svc.close()
    svc = DetectorService(_SlowStubDetector(delay=0.0), max_batch=4,
                          warmup=False, max_queue_depth=0)
    try:
        img = np.zeros((8, 8, 3), np.float32)
        # 0 = unbounded : far past any cap, no reject
        pendings = [svc.submit_async(img) for _ in range(64)]
        for p in pendings:
            svc.wait(p, timeout=10)
        assert svc.stats["rejected"] == 0
    finally:
        svc.close()


def test_http_429_with_retry_after_under_overload(server):
    srv, base = server
    assert srv.service.ready.wait(120)
    svc = srv.service
    old_depth = svc.max_queue_depth
    # deterministic fault injection: saturate admission so the next HTTP
    # request is shed (no timing races — the real saturation mechanics are
    # pinned by test_service_admission_control_rejects_then_recovers)
    svc.max_queue_depth = 1
    with svc._adm_lock:
        svc._outstanding += 1
    try:
        req = urllib.request.Request(base + "/detect", data=_jpeg_bytes())
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(req, timeout=30)
        err = exc_info.value
        assert err.code == 429
        assert int(err.headers["Retry-After"]) >= 1
        assert "max_queue_depth" in json.loads(err.read())["error"]
        status, stats = _get(base + "/stats")
        assert status == 200 and stats["rejected"] >= 1
        assert stats["max_queue_depth"] == 1
        # shedding load must not mark the daemon unhealthy
        status, body = _get(base + "/healthz")
        assert status == 200 and body["status"] == "ok"
    finally:
        with svc._adm_lock:
            svc._outstanding -= 1
        svc.max_queue_depth = old_depth
    # back under the cap: requests flow again
    status, body = _post(base + "/detect?threshold=0.0", _jpeg_bytes())
    assert status == 200 and len(body["boxes"]) > 0


def test_deterministic_vs_direct_call(server, export_dir):
    """The daemon must return exactly what the exported detector returns:
    exactly what its own worker computes for the decoded image, and, within
    rtol 1e-5, what a detector loaded apart computes on the test's thread
    (on the CPU the worker thread splits the convolutions' sums otherwise
    than this module's pinned single thread: measured 4e-6; on the card
    ``chip_smoke.py`` holds the two equal)."""
    srv, base = server
    from multibox_tpu_torch.serve import _decode_request_image
    from multibox_tpu_torch.serving import load_exported

    data = _jpeg_bytes(7)
    status, body = _post(base + "/detect?threshold=0.0", data)
    assert status == 200
    img = _decode_request_image(data, 75)
    worker = srv.service.submit(img)
    n = int(worker["num"])
    np.testing.assert_array_equal(np.asarray(body["scores"], np.float32), worker["scores"][:n])
    np.testing.assert_array_equal(np.asarray(body["boxes"], np.float32), worker["boxes"][:n])
    out = load_exported(export_dir, device="cpu")(img[None])
    assert int(out["num"][0]) == n
    np.testing.assert_allclose(np.asarray(body["scores"]), out["scores"][0, :n], rtol=1e-5)

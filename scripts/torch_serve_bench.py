"""Measure the multibox-torch-serve daemon: latency and throughput under
concurrency.

The port's copy of ``scripts/serve_bench.py``, with the same flags, JSON
lines and closing summary, plus ``--device``. It drives the REAL HTTP
surface (``multibox_tpu_torch.serve.make_server``, the in-process
ThreadingHTTPServer that ``multibox-torch-serve`` runs) against a
``multibox-torch-export`` directory and reports:

* p50/p90/p99 per-request latency and aggregate throughput at each
  concurrency level,
* the micro-batching win vs ``--max_batch 1`` (every request its own
  device call),
* a ``--batch_window_ms`` sweep (the daemon's 40 ms default came from the
  JAX package),
* admission control: with ``--max_queue_depths`` a bounded queue sheds
  load with 429s, counted per row (``shed_429``).

Usage:
  python scripts/torch_serve_bench.py --export_dir EXPORT_DIR \
      --concurrency 1 8 32 --requests 64 --windows 5 20 40 [--device cuda]

Prints one JSON object per (config, concurrency) line, then a summary.
"""

from __future__ import annotations

import argparse
import http.client
import json
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _encode_test_image(size: int, seed: int = 0) -> bytes:
    from multibox_tpu_torch.data.jpeg import encode_jpeg

    rng = np.random.default_rng(seed)
    img = np.full((size, size, 3), 30, np.uint8)
    y0, x0 = int(0.3 * size), int(0.25 * size)
    img[y0:y0 + size // 3, x0:x0 + size // 3] = [220, 180, 60]
    img += rng.integers(0, 8, img.shape).astype(np.uint8)
    return encode_jpeg(img)


def drive(port: int, payloads, concurrency: int, requests_per_client: int):
    """N client threads, each sending sequential POST /detect requests over
    a keep-alive connection. Returns (latencies_s, wall_s, errors).

    A failed request (non-200, reset, timeout) is COUNTED, not fatal: one
    crashed client thread would silently drop its whole latency sample and
    skew the percentiles of everything that follows."""
    lat = []
    errors = []
    shed = [0]  # 429s: intentional load shedding, not failures
    lock = threading.Lock()
    barrier = threading.Barrier(concurrency + 1)

    def client(tid: int):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        mine, mine_err, mine_shed = [], [], 0
        barrier.wait()
        for i in range(requests_per_client):
            body = payloads[(tid + i) % len(payloads)]
            t0 = time.monotonic()
            try:
                conn.request(
                    "POST", "/detect", body=body,
                    headers={"Content-Type": "application/octet-stream"},
                )
                resp = conn.getresponse()
                data = resp.read()
                if resp.status == 429:
                    # admission control: honor the hint (a real client
                    # backs off; sleeping also keeps the closed loop from
                    # hammering the reject path at line rate)
                    mine_shed += 1
                    time.sleep(float(resp.headers.get("Retry-After", 1)))
                    continue
                if resp.status != 200:
                    raise RuntimeError(f"HTTP {resp.status}: {data[:120]}")
                mine.append(time.monotonic() - t0)
            except Exception as e:  # count + fresh connection, keep going
                mine_err.append(f"{type(e).__name__}: {e}")
                conn.close()
                conn = http.client.HTTPConnection(
                    "127.0.0.1", port, timeout=120
                )
        conn.close()
        with lock:
            lat.extend(mine)
            errors.extend(mine_err)
            shed[0] += mine_shed

    threads = [
        threading.Thread(target=client, args=(t,)) for t in range(concurrency)
    ]
    for t in threads:
        t.start()
    barrier.wait()
    t0 = time.monotonic()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    return lat, wall, errors, shed[0]


def run_config(export_dir, label, max_batch, window_ms, concurrencies,
               requests, input_size, max_queue_depth=None, device=None):
    from multibox_tpu_torch.serve import make_server

    server = make_server(
        export_dir, port=0, max_batch=max_batch, batch_window_ms=window_ms,
        max_queue_depth=max_queue_depth, device=device,
    )
    port = server.server_address[1]
    st = threading.Thread(target=server.serve_forever, daemon=True)
    st.start()
    # distinct payloads, as the JAX package's script sends
    payloads = [_encode_test_image(input_size, seed=s) for s in range(8)]
    rows = []
    try:
        # the daemon warms every exported program at startup
        # (DetectorService warmup) — wait so measured latencies are
        # steady-state, then one client-path warmup pass
        server.service.ready.wait()
        drive(port, payloads, 2, 3)
        for conc in concurrencies:
            stats0 = dict(server.service.stats)
            lat, wall, errors, shed = drive(port, payloads, conc, requests)
            stats1 = dict(server.service.stats)
            n = len(lat)
            if n == 0:  # an all-error run must not crash the sweep
                print(json.dumps({"config": label, "concurrency": conc,
                                  "requests": 0, "errors": len(errors),
                                  "error_sample": errors[:3]}), flush=True)
                continue
            row = {
                "config": label,
                "max_batch": max_batch,
                "batch_window_ms": window_ms,
                "max_queue_depth": server.service.max_queue_depth,
                "concurrency": conc,
                "requests": n,
                "p50_ms": round(float(np.percentile(lat, 50)) * 1e3, 1),
                "p90_ms": round(float(np.percentile(lat, 90)) * 1e3, 1),
                "p99_ms": round(float(np.percentile(lat, 99)) * 1e3, 1),
                "throughput_rps": round(n / wall, 1),
                "errors": len(errors),
                "shed_429": shed,
                "device_batches": stats1["device_batches"]
                - stats0["device_batches"],
                "imgs_per_device_batch": round(
                    (stats1["images"] - stats0["images"])
                    / max(stats1["device_batches"] - stats0["device_batches"], 1),
                    2,
                ),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)
            if errors:
                print(json.dumps({"config": label, "concurrency": conc,
                                  "error_sample": errors[:3]}), flush=True)
    finally:
        server.shutdown()
        server.service.close()
        server.server_close()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--export_dir", required=True)
    ap.add_argument("--concurrency", type=int, nargs="+", default=[1, 8, 32])
    ap.add_argument("--requests", type=int, default=32,
                    help="requests per client")
    ap.add_argument("--windows", type=float, nargs="+", default=[5.0])
    ap.add_argument("--input_size", type=int, default=299)
    ap.add_argument("--max_queue_depths", type=int, nargs="+", default=[None],
                    help="admission-control arms per window: None = the "
                         "4*max_batch default, 0 = unbounded")
    ap.add_argument("--skip_unbatched", action="store_true",
                    help="skip the max_batch_1 control arm")
    ap.add_argument("--device", default=None,
                    help="torch device the export was traced on (default: the "
                         "CUDA device, an error without one)")
    args = ap.parse_args(argv)

    all_rows = []
    # Batched daemon at each window x admission depth, then no-batching.
    for w in args.windows:
        for depth in args.max_queue_depths:
            label = f"batched_w{w:g}" + (
                "" if depth is None else f"_q{depth}")
            all_rows += run_config(
                args.export_dir, label, None, w,
                args.concurrency, args.requests, args.input_size,
                max_queue_depth=depth, device=args.device,
            )
    if not args.skip_unbatched:
        all_rows += run_config(
            args.export_dir, "max_batch_1", 1, 0.0,
            args.concurrency, args.requests, args.input_size,
            device=args.device,
        )
    print(json.dumps({"summary": all_rows}, indent=1))
    return all_rows


if __name__ == "__main__":
    main()

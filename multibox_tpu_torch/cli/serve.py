"""multibox-torch-serve — HTTP detection daemon over a
multibox-torch-export directory.

Own counterpart of the JAX package's ``multibox-serve``: a stdlib-only HTTP
server with micro-batching, concurrent requests coalescing into one program
call per batch window. See ``multibox_tpu_torch/serve.py`` for the
endpoint contract. ``--device`` must be the device the export was traced
on (default CUDA, and an error without one).

  multibox-torch-serve --export_dir EXPORT [--port 8000] [--batch_window_ms 40] [--device cpu]
"""

from __future__ import annotations

import argparse

from multibox_tpu_torch.cli.common import add_device_arg, setup_logging


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--export_dir", required=True,
                        help="multibox-torch-export output directory")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--max_batch", type=int, default=None,
                        help="micro-batch cap (default: largest exported "
                             "batch size)")
    parser.add_argument("--batch_window_ms", type=float, default=40.0,
                        help="how long the batcher waits for stragglers")
    parser.add_argument("--max_queue_depth", type=int, default=None,
                        help="admission cap on outstanding requests; "
                             "beyond it requests get 429 + Retry-After "
                             "instead of unbounded queueing (default: "
                             "2 x max_batch; 0 disables)")
    parser.add_argument("--class_names", nargs="+", default=None,
                        help="display names for class ids in responses")
    parser.add_argument("--verbose", action="store_true",
                        help="log each HTTP request")
    add_device_arg(parser)
    args = parser.parse_args(argv)
    setup_logging()

    from multibox_tpu_torch.serve import make_server

    server = make_server(
        args.export_dir,
        host=args.host,
        port=args.port,
        max_batch=args.max_batch,
        batch_window_ms=args.batch_window_ms,
        class_names=args.class_names,
        max_queue_depth=args.max_queue_depth,
        device=args.device,
    )
    if args.verbose:
        # restore BaseHTTPRequestHandler's default stderr logging
        del server.RequestHandlerClass.log_message
    sizes = server.service and sorted(server.service.detector.calls)
    print(
        f"warming up: running the programs for batch sizes {sizes} ...",
        flush=True,
    )
    # The worker thread runs every exported program before serving
    # traffic (serving.ExportedDetector.warmup) — wait so the "serving"
    # line below means ready-for-traffic, not accepting-then-stalling.
    server.service.ready.wait()
    print(
        f"serving {args.export_dir} on http://{args.host}:{args.port} "
        f"(batch sizes {sizes}, window {args.batch_window_ms} ms)",
        flush=True,
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.service.close()
        server.server_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

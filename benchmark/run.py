"""The benchmark of ``multibox_tpu_torch`` on one H100: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints, as the last line of standard output,
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` a ``breakdown`` of the traced stretch, and
last ``checks``: each number the correctness check compared, beside its
limit; the same numbers are the last lines of standard error. Exits with
another code and prints no result when there is no CUDA device, fewer than
the cell needs, or when ``jax``, ``jaxlib``, ``flax`` or ``multibox_tpu``
is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every cache of the program inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".work", "benchmark", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".work", "benchmark", "torch_extensions")
sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "multibox_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, compared whole."""
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"),
                         T_START, log=lambda s: print(s, file=sys.stderr, flush=True))
    found = forbidden_modules()
    if found:
        print(f"loaded in the process that would print the result: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # the run failed: say why, print no result
        traceback.print_exc()
        code = 1
    sys.exit(code)

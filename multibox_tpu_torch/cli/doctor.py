"""multibox-torch-doctor — environment and deployment health checks.

The port's preflight, with the JAX package's ``multibox-doctor`` shape: one
``[ok]/[warn]/[fail]`` line a check, exit 0 iff nothing fails, ``--json``
for machine consumption (monitoring hooks, pre-flight gates in training
supervisors), ``--skip_device`` for the host checks alone.

Host checks: the python dependencies, the platform's configuration (the
torch build and ``CUDA_VISIBLE_DEVICES``), the kernels' build (``nvcc``
found, the build directory writable), the native layer (the tfrecord
reader builds and loads; whether libjpeg's headers are there for the
native JPEG decoder) and a tfrecord round trip.

The device check runs in a subprocess under a hard timeout: a wedged
driver or a card lost under a job can hang the first CUDA call instead of
raising, and a hung child is killed and reported as a ``fail``. The probe
runs a small product on the card against the CPU and one launch of the box
decode kernel (B3, the cheapest) against its plain version.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import List, Tuple

Check = Tuple[str, str, str]  # (status, name, detail); status ok|warn|fail

_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Child probe source. Integer-valued float32 operands keep the product
# exact on both devices; the decode kernel is bitwise its plain version.
_PROBE_SRC = """
import json, time
t0 = time.time()
import torch
from multibox_tpu_torch.ops import kernels
from multibox_tpu_torch.ops.kernels import box_kernel
dev = torch.device("cuda")
value = float((torch.arange(8.0, device=dev) * 2 + 1).sum())
g = torch.Generator().manual_seed(0)
a = torch.randint(-8, 9, (64, 96), generator=g).float()
b = torch.randint(-8, 9, (96, 32), generator=g).float()
matmul_equal = torch.equal((a.to(dev) @ b.to(dev)).cpu(), a @ b)
off = torch.rand(2, 256, 4, generator=g) - 0.5
pri = torch.rand(256, 4, generator=g)
kernels.reset_launch_counts()
got = box_kernel.decode_boxes_cuda(off.to(dev), pri.to(dev)).cpu()
decode_equal = torch.equal(got, box_kernel.decode_boxes_plain(off, pri[None]))
print(json.dumps({
    "value": value,
    "matmul_equal": bool(matmul_equal),
    "decode_equal": bool(decode_equal),
    "decode_launches": kernels.launch_counts()["box_decode"],
    "platform": "cuda",
    "device_kind": torch.cuda.get_device_name(0),
    "n_devices": torch.cuda.device_count(),
    "elapsed_s": round(time.time() - t0, 2),
}))
"""


def check_python_deps() -> Check:
    vers = []
    try:
        for name in ("torch", "numpy"):
            mod = __import__(name)
            vers.append(f"{name} {getattr(mod, '__version__', '?')}")
    except ImportError as e:
        return ("fail", "python-deps", f"import failed: {e}")
    return ("ok", "python-deps", ", ".join(vers))


def check_platform_config() -> Check:
    import torch

    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    detail = (f"torch {torch.__version__} built with CUDA {torch.version.cuda or '(none)'}; "
              f"CUDA_VISIBLE_DEVICES={'(unset)' if visible is None else repr(visible)}")
    if torch.version.cuda is None:
        return ("warn", "platform-config",
                detail + " — a CPU-only build of torch: the entry points need "
                "device='cpu' (--device cpu)")
    if visible is not None and visible.strip() in ("", "-1"):
        return ("warn", "platform-config", detail + " — hides every CUDA device")
    return ("ok", "platform-config", detail)


def check_kernel_build() -> Check:
    """``nvcc`` found and the kernels' build directory writable (the CUDA
    kernels are compiled at first use)."""
    import torch

    from multibox_tpu_torch.ops import kernels

    try:
        nvcc = kernels.find_nvcc()
    except RuntimeError as e:
        status = "fail" if torch.version.cuda else "warn"
        return (status, "kernel-build", str(e))
    out_dir = kernels.build_dir()
    probe = out_dir
    while not os.path.isdir(probe):  # the nearest directory that exists
        probe = os.path.dirname(probe)
    if not os.access(probe, os.W_OK):
        return ("fail", "kernel-build", f"{nvcc}; {probe} not writable ({out_dir})")
    built = [e for e in os.listdir(out_dir) if e.endswith(".so")] \
        if os.path.isdir(out_dir) else []
    return ("ok", "kernel-build", f"{nvcc}; {out_dir}: {len(built)} built libraries")


def check_native_layer() -> Check:
    """The tfrecord reader builds and loads (it is the default reader); the
    JPEG decoder's header is reported, and the decoder built where it is
    present."""
    try:
        from multibox_tpu_torch.data import _native
        from multibox_tpu_torch.data.tfrecord import masked_crc

        _native.reader_library()
        if _native.masked_crc(b"doctor") != masked_crc(b"doctor"):
            return ("fail", "native-layer", "the native CRC disagrees with the Python one")
        detail = f"tfrecord reader loaded ({_native.machine()})"
        if _native.jpeg_headers_present():
            _native.jpeg_library()
            detail += "; JPEG decoder loaded"
        else:
            detail += ("; jpeglib.h absent: decode_jpeg(backend='native') is unavailable "
                       "(PIL decodes by default)")
        return ("ok", "native-layer", detail)
    except Exception as e:  # report, never let a probe kill the doctor
        return ("fail", "native-layer", f"{type(e).__name__}: {e}")


def check_tfrecord_roundtrip() -> Check:
    """Serialize one Example, read it back with both readers, parse it."""
    import tempfile

    import numpy as np

    try:
        from multibox_tpu_torch.data.example_proto import (
            build_detection_example, parse_detection_example)
        from multibox_tpu_torch.data.tfrecord import TFRecordWriter, read_records

        boxes = np.array([[0.1, 0.2, 0.6, 0.8]], np.float32)
        ex = build_detection_example(
            image_bytes=b"\xff\xd8fakejpeg", image_id="doctor", boxes=boxes,
            labels=np.array([1], np.int64), height=4, width=4)
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "doctor.tfrecord")
            with TFRecordWriter(path) as w:
                w.write(ex)
            recs = list(read_records([path]))
            if recs != list(read_records([path], use_native=False)):
                return ("fail", "tfrecord-roundtrip", "the two readers disagree")
        parsed = parse_detection_example(recs[0])
        if parsed["image_id"] != "doctor" or len(parsed["boxes"]) != 1:
            return ("fail", "tfrecord-roundtrip", "parsed fields mismatch")
        return ("ok", "tfrecord-roundtrip", "write → read (native, Python) → parse agrees")
    except Exception as e:
        return ("fail", "tfrecord-roundtrip", f"{type(e).__name__}: {e}")


def check_device(timeout_s: float) -> Check:
    t0 = time.time()
    env = os.environ.copy()
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_PACKAGE_PARENT, env.get("PYTHONPATH")) if p)
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _PROBE_SRC],
            capture_output=True, text=True, timeout=timeout_s, env=env,
        )
    except subprocess.TimeoutExpired:
        return ("fail", "device",
                f"probe hung past {timeout_s:.0f}s and was killed — the CUDA "
                "device or its driver does not answer")
    if proc.returncode != 0:
        tail = (proc.stderr or "").strip().splitlines()
        return ("fail", "device",
                f"probe exited {proc.returncode}: {tail[-1] if tail else '?'}")
    try:
        info = json.loads(proc.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return ("fail", "device", f"unparseable probe output: {proc.stdout!r}")
    if info.get("value") != 64.0:  # sum(2v+1, v=0..7)
        return ("fail", "device", f"wrong arithmetic result: {info.get('value')}")
    if not info.get("matmul_equal"):
        return ("fail", "device", "wrong arithmetic result: the product on the card "
                                  "differs from the CPU's")
    if not info.get("decode_equal") or info.get("decode_launches") != 1:
        return ("fail", "device", "the box decode kernel differs from its plain version "
                                  f"(launches {info.get('decode_launches')})")
    detail = (f"{info['n_devices']}x {info['device_kind']} "
              f"({info['platform']}), product + decode kernel + readback "
              f"{info['elapsed_s']}s (wall {time.time() - t0:.1f}s)")
    status = "ok"
    if info["elapsed_s"] > 60:
        status, detail = "warn", detail + " — slow; a kernel build or a busy card?"
    return (status, "device", detail)


def run_checks(device_timeout_s: float, skip_device: bool) -> List[Check]:
    checks = [
        check_python_deps(),
        check_platform_config(),
        check_kernel_build(),
        check_native_layer(),
        check_tfrecord_roundtrip(),
    ]
    if not skip_device:
        checks.append(check_device(device_timeout_s))
    return checks


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--device_timeout", type=float, default=120.0,
                        help="hard budget (s) for the subprocess device "
                             "probe before declaring the device unreachable")
    parser.add_argument("--skip_device", action="store_true",
                        help="host-side checks only (never spawns a probe)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="one JSON object instead of per-check lines")
    args = parser.parse_args(argv)

    checks = run_checks(args.device_timeout, args.skip_device)
    ok = all(status != "fail" for status, _, _ in checks)
    if args.as_json:
        print(json.dumps({
            "ok": ok,
            "checks": [{"status": s, "name": n, "detail": d}
                       for s, n, d in checks],
        }))
    else:
        for status, name, detail in checks:
            print(f"[{status}] {name}: {detail}")
        print("doctor: all checks passed" if ok
              else "doctor: FAILURES above", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

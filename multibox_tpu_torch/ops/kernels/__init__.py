"""CUDA kernels for the detection hot paths (NVIDIA Hopper, ``sm_90a``).

Counterpart of the JAX package's ``ops/pallas``. The sources live in
``multibox_tpu_torch/csrc/*.cu``; each has a plain C interface (no PyTorch
or CUTLASS headers, so a build takes seconds). They are compiled with
``nvcc`` at first use — one ``nvcc -c`` per source, all started together,
then one link — into a single shared library that is loaded with
``ctypes``. Pointers come from ``tensor.data_ptr()`` and the stream from
``torch.cuda.current_stream()``.

Every wrapper module keeps, beside its kernel, the plain PyTorch version of
the same function. A wrapper uses the plain version only for a tensor that
lies on the CPU; for a CUDA tensor it launches the kernel or raises.

The build goes to ``.work/kernels/`` beside the package (override with
``MULTIBOX_TORCH_BUILD_DIR``). Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

import torch

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")

# source file → extra nvcc flags. nms.cu compares IoUs against a threshold
# and must round exactly like the plain version: no FMA contraction.
_SOURCES = {
    "box.cu": (),
    "nms.cu": ("-fmad=false",),
    "fused_matmul.cu": (),
}
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# Launch counts, one per kernel entry: a wrapper adds one exactly where it
# launches its kernel, so a run can show which kernels its path went through.
LAUNCHES: Dict[str, int] = {
    "nms": 0,
    "fused_matmul": 0,
    "box_decode": 0,
    "box_encode": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def resolve_use_pallas(flag: Optional[bool], tensor: torch.Tensor) -> bool:
    """Resolve a config ``use_pallas`` value (the field keeps the JAX
    package's name; here it means "use the hand-written CUDA kernels").
    ``None`` = auto: the kernel when ``tensor`` is on a CUDA device."""
    if flag is None:
        return tensor.is_cuda
    return bool(flag)


def build_dir() -> str:
    override = os.environ.get("MULTIBOX_TORCH_BUILD_DIR")
    if override:
        return override
    return os.path.join(os.path.dirname(os.path.dirname(_CSRC)), ".work", "kernels")


def find_nvcc() -> str:
    candidates = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root:
            candidates.append(os.path.join(root, "bin", "nvcc"))
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME, /usr/local/cuda): the "
        "CUDA kernels of multibox_tpu_torch are built from source at first use"
    )


def build_library(ptxas_verbose: bool = False):
    """Compile ``csrc/*.cu`` into one shared library; returns
    ``(path, compiler_output)``. Reuses a library already built from the
    same sources and flags. Raises if ``nvcc`` is missing or fails."""
    nvcc = find_nvcc()
    digest = hashlib.sha256()
    for name, extra in sorted(_SOURCES.items()):
        with open(os.path.join(_CSRC, name), "rb") as f:
            digest.update(f.read())
        digest.update(" ".join(_NVCC_FLAGS + tuple(extra)).encode())
    tag = digest.hexdigest()[:16]
    out_dir = build_dir()
    lib_path = os.path.join(out_dir, f"libmultibox_kernels_{tag}.so")
    if os.path.exists(lib_path) and not ptxas_verbose:
        return lib_path, ""
    os.makedirs(out_dir, exist_ok=True)

    # One nvcc per source, all started together.
    procs = []
    for name, extra in _SOURCES.items():
        obj = os.path.join(out_dir, f"{name[:-3]}_{tag}_{os.getpid()}.o")
        cmd = [nvcc, *_NVCC_FLAGS, *extra]
        if ptxas_verbose:
            cmd += ["-Xptxas", "-v"]
        cmd += ["-c", os.path.join(_CSRC, name), "-o", obj]
        procs.append((name, obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for name, obj, cmd, proc in procs:
        out, _ = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(
            f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(log))
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    link = [nvcc, "-shared", "-o", tmp] + [obj for _, obj, _, _ in procs]
    done = subprocess.run(link, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    log.append(f"$ {' '.join(link)}\n{done.stdout}")
    if done.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
    os.replace(tmp, lib_path)  # atomic: a concurrent build sees all or nothing
    for _, obj, _, _ in procs:
        os.remove(obj)
    return lib_path, "\n".join(log)


_lib = None
_lib_lock = threading.Lock()


def load_library():
    """Build (if needed) and load the kernel library; sets ``argtypes`` so
    pointers and the stream pass as 64-bit values."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path, _ = build_library()
        lib = ctypes.CDLL(path)
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        lib.mbx_error_string.argtypes = [i]
        lib.mbx_error_string.restype = ctypes.c_char_p
        # (a, priors, out, n, period, clip, stream)
        lib.mbx_box_decode.argtypes = [p, p, p, ll, ll, i, p]
        lib.mbx_box_encode.argtypes = [p, p, p, ll, ll, p]
        # (boxes, scores, sel_idx, sel_scores, B, P, K, iou_thr, score_thr, stream)
        lib.mbx_nms.argtypes = [p, p, p, p, i, i, i, f, f, p]
        # (x, w, b, out, M, K, N, relu, is_bf16, stream)
        lib.mbx_fused_matmul.argtypes = [p, p, p, p, i, i, i, i, i, p]
        for fn in (lib.mbx_box_decode, lib.mbx_box_encode, lib.mbx_nms,
                   lib.mbx_fused_matmul):
            fn.restype = i
        _lib = lib
        return lib


def check_launch(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error from its launch."""
    if err != 0:
        msg = load_library().mbx_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({err}: {msg})")


def current_stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)

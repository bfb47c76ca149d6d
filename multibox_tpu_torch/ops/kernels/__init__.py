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
``MULTIBOX_TORCH_BUILD_DIR``), under the lock of ``utils.build_lock``
so that of several processes starting together (the ranks of a
data-parallel run) one builds and the others load. Nothing here runs at
import time.

Inside a CUDA graph's capture (``multibox_tpu_torch.graphs``) the wrappers
launch as they do eagerly: the stream is the capture stream, the scratch
buffers are the graph's own (:func:`graph_scratch`), and the launches the
capture counts are set aside and added again at each replay
(:func:`launches_set_aside`, :func:`add_launches`).
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

import torch

from multibox_tpu_torch.utils.build_lock import build_lock

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc")

# source file → extra nvcc flags. nms.cu and match.cu compute IoUs that
# must round exactly like the plain version's (a threshold comparison, ties
# in an arg-max): no FMA contraction.
_SOURCES = {
    "box.cu": (),
    "nms.cu": ("-fmad=false",),
    "fused_matmul.cu": (),
    "match.cu": ("-fmad=false",),
}
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

# Launch counts, one per kernel entry: a wrapper adds one exactly where it
# launches its kernel, so a run can show which kernels its path went through.
# "fused_matmul_backward" counts the calls of that kernel's backward, which
# is plain matrix products (as in the JAX package), not a kernel of ours.
LAUNCHES: Dict[str, int] = {
    "nms": 0,
    "fused_matmul": 0,
    "fused_matmul_backward": 0,
    "box_decode": 0,
    "box_encode": 0,
    "match": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` to the launch counts: a CUDA graph's replay launches
    again what its capture counted."""
    for name, n in counts.items():
        LAUNCHES[name] += n


@contextlib.contextmanager
def launches_set_aside():
    """Within the block the launch counts start from 0; on leaving, the
    dict the block yields holds what it counted and the counts are back
    where they were. A graph's warm-up and capture run in such a block:
    neither is a launch of the step (the capture only records it)."""
    saved = dict(LAUNCHES)
    reset_launch_counts()
    seen: Dict[str, int] = {}
    try:
        yield seen
    finally:
        seen.update(LAUNCHES)
        LAUNCHES.update(saved)


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
    with build_lock(out_dir):
        if os.path.exists(lib_path) and not ptxas_verbose:
            return lib_path, ""  # built by another process meanwhile
        return lib_path, _compile(nvcc, out_dir, tag, lib_path, ptxas_verbose)


def _compile(nvcc: str, out_dir: str, tag: str, lib_path: str,
             ptxas_verbose: bool) -> str:
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
    return "\n".join(log)


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
        u = ctypes.c_uint
        # (a, priors, out, P, rows, grid_x, grid_y, clip, stream)
        lib.mbx_box_decode.argtypes = [p, p, p, i, ll, u, u, i, p]
        lib.mbx_box_encode.argtypes = [p, p, p, i, ll, u, u, p]
        # (boxes, scores, sel_idx, sel_scores, B, P, K, iou_thr, thr_mid,
        #  thr_tie_up, score_thr, window, window_max, cluster, bulk, stream)
        lib.mbx_nms.argtypes = [p, p, p, p, i, i, i, f, ctypes.c_double, i, f, i, i, i, i, p]
        # (x, w, b, out, workspace, M, K, N, relu, is_bf16, route, split,
        #  kslice, tile_n, blocks, stages, resident, stream)
        lib.mbx_fused_matmul.argtypes = [p, p, p, p, p] + [i] * 12 + [p]
        # (gt, num_gt, priors, out, B, G, P, cluster, images, tile, stream)
        lib.mbx_greedy_match.argtypes = [p, p, p, p] + [i] * 6 + [p]
        # (G, P, cluster, images, tile) -> shared bytes, 0 for a refused plan
        lib.mbx_greedy_match_smem.argtypes = [i] * 5
        lib.mbx_greedy_match_smem.restype = ll
        # (G, P, cluster, tile) -> clusters the card holds at once
        lib.mbx_greedy_match_clusters.argtypes = [i] * 4
        lib.mbx_greedy_match_clusters.restype = i
        for fn in (lib.mbx_box_decode, lib.mbx_box_encode, lib.mbx_nms,
                   lib.mbx_fused_matmul, lib.mbx_greedy_match):
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


# Kernels' scratch buffers, one per (device, stream, dtype), grown with
# torch.empty: stream order keeps two launches on one stream from using one
# buffer at the same time. The kernels allocate nothing themselves.
_SCRATCH: Dict[tuple, torch.Tensor] = {}
# While a CUDA graph is captured: the graph's own buffers (allocated in its
# memory pool and kept by the graph), so that no eager launch and no other
# graph ever frees or shares one that a graph's replay writes.
_GRAPH_SCRATCH: Optional[Dict[tuple, torch.Tensor]] = None


@contextlib.contextmanager
def graph_scratch():
    """Within the block (a graph's capture) :func:`scratch` hands out
    buffers of the dict it yields, which the graph keeps."""
    global _GRAPH_SCRATCH
    owned: Dict[tuple, torch.Tensor] = {}
    _GRAPH_SCRATCH = owned
    try:
        yield owned
    finally:
        _GRAPH_SCRATCH = None


def scratch(device: torch.device, stream: int, numel: int, dtype: torch.dtype) -> torch.Tensor:
    """A buffer of at least ``numel`` elements of ``dtype`` for a launch on
    ``stream``; its contents are undefined."""
    table = _SCRATCH if _GRAPH_SCRATCH is None else _GRAPH_SCRATCH
    key = (device, stream, dtype)
    buf = table.get(key)
    if buf is None or buf.numel() < numel:
        table.pop(key, None)  # free the smaller buffer first
        buf = torch.empty(numel, dtype=dtype, device=device)
        table[key] = buf
    return buf


def require(cond: bool, msg: str, *args) -> None:
    """Raise ValueError(msg) unless ``cond``; with ``args``, ``msg`` is a
    ``str.format`` template filled only when it raises (a wrapper's checks
    run on every launch)."""
    if not cond:
        raise ValueError(msg.format(*args) if args else msg)

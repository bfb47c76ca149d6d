"""Structure of the port: what it may import, where it may run, and how
its kernel wrappers behave when they cannot launch.
"""

import ast
import os
import pathlib

import numpy as np
import pytest

import torch

from multibox_tpu_torch import inference as tinf
from multibox_tpu_torch import priors as tpriors
from multibox_tpu_torch import quantize as tquantize
from multibox_tpu_torch import serve as tserve
from multibox_tpu_torch import serving as tserving
from multibox_tpu_torch.cli import detect as cli_detect
from multibox_tpu_torch.cli import evaluate as cli_evaluate
from multibox_tpu_torch.cli import export as cli_export
from multibox_tpu_torch.cli import priors as cli_priors
from multibox_tpu_torch.cli import serve as cli_serve
from multibox_tpu_torch.cli import train as cli_train
from multibox_tpu_torch.cli import visualize as cli_visualize
from multibox_tpu_torch.cli import visualize_inputs as cli_visualize_inputs
from multibox_tpu_torch.config import Config
from multibox_tpu_torch.device import resolve_device
from multibox_tpu_torch.models import convert
from multibox_tpu_torch.models.detector import MultiBoxDetector
from multibox_tpu_torch.ops import kernels
from multibox_tpu_torch.ops.kernels import box_kernel, fused_matmul, match_kernel, nms_kernel
from multibox_tpu_torch.parallel import init_data_parallel, make_mesh, shard_batch
from multibox_tpu_torch.train import create_train_state, make_train_step
from multibox_tpu_torch.train.loop import (
    evaluate_state,
    make_augmented_train_step,
    train,
    train_from_batches,
)
from multibox_tpu_torch.utils.checkpoint import CheckpointManager

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "multibox_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "multibox_tpu", "bench")


def port_sources():
    """The package, chip_smoke.py and the port's scripts (``scripts/torch_*.py``)."""
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    scripts = sorted((ROOT / "scripts").glob("torch_*.py"))
    assert len(files) > 15 and len(scripts) >= 5
    return files + scripts


def imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_no_module_builds_or_imports_gpu_tooling_at_import_time():
    """triton is absent on CPU-only machines, and nothing may compile when a
    module is merely imported (every module was imported to get here)."""
    for path in port_sources():
        tree = ast.parse(path.read_text())
        for node in tree.body:  # top level only
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = [a.name for a in node.names] + [getattr(node, "module", "") or ""]
                assert not any(n.split(".")[0] == "triton" for n in names), path
    assert kernels._lib is None  # nothing loaded a library on the way here


def test_importing_every_module_builds_and_loads_no_library():
    """A fresh interpreter imports every module of the port (the native
    layer, the CLIs among them): no kernel or native library is built or
    loaded, and neither triton nor JAX is imported."""
    import subprocess
    import sys

    modules = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts)
                     for p in PORT.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m.removesuffix('.__init__'))\n"
            "from multibox_tpu_torch.data import _native\n"
            "from multibox_tpu_torch.ops import kernels\n"
            "assert _native._libs == {} and kernels._lib is None\n"
            "assert 'triton' not in sys.modules and 'jax' not in sys.modules\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert len(modules) > 40


def needs_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this test describes a machine without a CUDA device")


SMALL = dict(input_size=75, num_priors=4, compute_dtype="float32")
PRIORS = np.array([[0.1, 0.1, 0.5, 0.5]] * 4, np.float32)


def CheckpointManager_restore():
    """Restore of a saved checkpoint with no device named."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, save_every=1)
        mgr.save(1, {"step": 1, "params": {}}, force=True)
        return mgr.restore(None)


def init_data_parallel_under_torchrun():
    """``init_data_parallel()`` in the environment torchrun gives a rank,
    with no backend named (NCCL)."""
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": "29555"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return init_data_parallel()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


@pytest.mark.parametrize(
    "call",
    [
        lambda: resolve_device(),
        lambda: tinf.build_model(Config(**SMALL), 4),
        lambda: tinf.make_detect_fn(Config(**SMALL), PRIORS),
        lambda: tinf.make_detect_body(Config(**SMALL), PRIORS),
        lambda: tinf.make_detect_loop_fns(Config(**SMALL), PRIORS),
        lambda: tinf.run_detect_loop(Config(**SMALL), {"params": {}}, [], PRIORS),
        lambda: convert.flax_to_torch({"params": {}}),
        lambda: resolve_device("cuda"),
        lambda: MultiBoxDetector(num_priors=4, input_size=75),
        lambda: MultiBoxDetector(num_priors=4, input_size=96, backbone="mobilenet_v2"),
        lambda: MultiBoxDetector(num_priors=354, input_size=75, head_type="ssd"),
        lambda: create_train_state(Config(**SMALL), MultiBoxDetector(
            num_priors=4, input_size=75, device="cpu"), 0, 4),
        lambda: make_train_step(Config(**SMALL), None, PRIORS),
        lambda: make_augmented_train_step(Config(**SMALL), None, PRIORS),
        lambda: train(Config(**SMALL), [], PRIORS, "unused_logdir"),
        lambda: CheckpointManager_restore(),
        lambda: train_from_batches(Config(**SMALL), [], PRIORS, "unused_logdir"),
        lambda: evaluate_state(Config(**SMALL), None, PRIORS, []),
        lambda: tpriors.generate_priors_kmeans(PRIORS, 2),
        lambda: cli_detect.run_detection(Config(**SMALL), [], PRIORS, "unused_logdir"),
        lambda: cli_priors.main(["--output", "unused.pkl", "--mode", "multiscale"]),
        lambda: cli_train.main(["--tfrecords", "unused", "--priors", "unused",
                                "--logdir", "unused_logdir"]),
        lambda: cli_detect.main(["--tfrecords", "unused", "--priors", "unused",
                                 "--checkpoint_path", "unused", "--output", "unused.pkl"]),
        lambda: cli_evaluate.main(["--tfrecords", "unused", "--detections", "unused.pkl"]),
        lambda: tinf.build_model(Config(**SMALL), 4, folded=True, quantize="int8"),
        lambda: tinf.make_detect_body(Config(**SMALL, quantize="int8"), PRIORS),
        lambda: tquantize.prepare_quantized_variables(
            Config(**SMALL), {"params": {}}, [np.zeros((1, 75, 75, 3), np.uint8)]),
        lambda: cli_export.export_detector(Config(**SMALL), None, {}, PRIORS, "unused", [1],
                                           None),
        lambda: cli_export.main(["--checkpoint_path", "unused", "--priors", "unused",
                                 "--output_dir", "unused"]),
        lambda: tserving.load_exported("unused"),
        lambda: tserve.make_server("unused"),
        lambda: cli_serve.main(["--export_dir", "unused"]),
        lambda: cli_visualize.main(["--tfrecords", "unused", "--priors", "unused.pkl",
                                    "--checkpoint_path", "unused", "--output_dir", "unused"]),
        lambda: cli_visualize_inputs.main(["--tfrecords", "unused", "--output_dir", "unused"]),
        init_data_parallel_under_torchrun,
        lambda: make_mesh(),
        lambda: shard_batch({"images": np.zeros((1, 2), np.uint8)}),
    ],
    ids=["resolve_device", "build_model", "make_detect_fn", "make_detect_body",
         "make_detect_loop_fns", "run_detect_loop", "flax_to_torch", "explicit_cuda",
         "detector", "detector_mobilenet", "detector_ssd", "create_train_state", "make_train_step",
         "make_augmented_train_step", "train", "checkpoint_restore", "train_from_batches",
         "evaluate_state", "generate_priors_kmeans", "run_detection", "cli_priors",
         "cli_train", "cli_detect", "cli_evaluate", "build_model_int8", "make_detect_body_int8",
         "prepare_quantized_variables", "export_detector", "cli_export", "load_exported",
         "make_server", "cli_serve", "cli_visualize", "cli_visualize_inputs",
         "init_data_parallel", "make_mesh", "shard_batch"],
)
def test_entry_points_raise_without_cuda_when_device_is_unset(call):
    needs_no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def test_device_helper_turns_tf32_off_and_takes_an_explicit_cpu():
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_build_helper_raises_when_nvcc_is_missing(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed at the default location")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build_library()


def test_kernel_sources_are_in_the_package_and_plain_c():
    names = sorted(p.name for p in (PORT / "csrc").glob("*.cu"))
    assert names == sorted(kernels._SOURCES)
    for name in names:
        text = (PORT / "csrc" / name).read_text()
        assert 'extern "C"' in text
        assert "torch/" not in text and "cutlass" not in text and "ATen" not in text
    assert "-fmad=false" in kernels._SOURCES["nms.cu"]
    assert "-fmad=false" in kernels._SOURCES["match.cu"]
    assert "arch=compute_90a,code=sm_90a" in kernels._NVCC_FLAGS


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize(
    "call",
    [
        lambda: nms_kernel.nms_select(torch.zeros(2, 5, 4), torch.zeros(2, 6), 3),
        lambda: nms_kernel.nms_select(torch.zeros(5, 4), torch.zeros(5), 3),
        lambda: nms_kernel.nms_select(torch.zeros(2, 5, 4), torch.zeros(2, 5), -1),
        lambda: fused_matmul.fused_matmul_bias_relu(
            torch.zeros(3, 4), torch.zeros(5, 2), torch.zeros(2)),
        lambda: fused_matmul.fused_matmul_bias_relu(
            torch.zeros(3, 4), torch.zeros(4, 2), torch.zeros(3)),
        lambda: fused_matmul.fused_matmul_bias_relu(
            torch.zeros(3, 4), torch.zeros(4, 2, device="meta"), torch.zeros(2)),
        # the box kernel's float4 accesses: its checks (run before every
        # launch on the card) refuse a tensor off the 16-byte boundary
        lambda: box_kernel._check(torch.zeros(33)[1:].view(2, 4, 4), torch.zeros(4, 4),
                                  "decode_boxes_cuda"),
        lambda: box_kernel._check(torch.zeros(2, 4, 4), torch.zeros(17)[1:].view(4, 4),
                                  "encode_boxes_cuda"),
    ],
    ids=["nms_shape", "nms_rank", "nms_k", "matmul_inner", "matmul_bias", "matmul_device",
         "box_misaligned", "box_priors_misaligned"],
)
def test_wrappers_refuse_what_they_do_not_take(call):
    with pytest.raises(ValueError):
        call()


def _function(module, name):
    tree = ast.parse(pathlib.Path(module.__file__).read_text())
    return next(n for n in ast.walk(tree)
                if isinstance(n, ast.FunctionDef) and n.name == name)


@pytest.mark.parametrize(
    "module,name",
    [(nms_kernel, "nms_select_op"), (fused_matmul, "fused_matmul_op"),
     (box_kernel, "decode_boxes_cuda"), (box_kernel, "encode_boxes_cuda"),
     (match_kernel, "greedy_match_cuda")],
    ids=["nms", "fused_matmul", "box_decode", "box_encode", "match"],
)
def test_wrappers_have_no_fallback_and_count_their_launches(module, name):
    """No ``try`` around the launch, the plain version only behind an
    ``is_cuda`` test, one count beside the launch. For B1, B2's forward and
    B3a the launch is inside the custom operator's implementation (so that
    an exported program counts its launches when it runs)."""
    fn = _function(module, name)
    assert not any(isinstance(n, ast.Try) for n in ast.walk(fn))
    src = ast.unparse(fn)
    assert "is_cuda" in src and "K.check_launch" in src
    assert src.count("K.LAUNCHES[") == 1
    # the product is the kernel's own: no library matmul on the kernel path
    assert not any(isinstance(n, ast.MatMult) for n in ast.walk(fn))
    for word in ("matmul", "addmm", "linear", "compile", "einsum", "mm("):
        assert word not in src.replace("fused_matmul", "").replace("mbx_fused_", "")


def test_launch_counts_do_not_move_on_the_cpu():
    kernels.reset_launch_counts()
    nms_kernel.nms_select(torch.rand(2, 8, 4), torch.rand(2, 8), 3)
    fused_matmul.fused_matmul_bias_relu(torch.rand(3, 4), torch.rand(4, 2), torch.zeros(2))
    box_kernel.decode_boxes_cuda(torch.rand(2, 8, 4), torch.rand(8, 4))
    box_kernel.encode_boxes_cuda(torch.rand(2, 8, 4), torch.rand(8, 4))
    match_kernel.greedy_match_cuda(torch.rand(2, 3, 4), torch.tensor([3, 1]), torch.rand(8, 4))
    x = torch.rand(3, 4, requires_grad=True)
    fused_matmul.fused_matmul_bias_relu(x, torch.rand(4, 2), torch.zeros(2)).sum().backward()
    assert kernels.launch_counts() == {
        "nms": 0, "fused_matmul": 0, "fused_matmul_backward": 0, "box_decode": 0,
        "box_encode": 0, "match": 0}
    assert kernels.resolve_use_pallas(None, torch.zeros(1)) is False
    assert kernels.resolve_use_pallas(True, torch.zeros(1)) is True


def test_kernel_operators_are_registered_with_their_output_shapes():
    """B1, B2's forward and B3a are ``multibox_torch::`` operators (so that
    ``torch.export`` records one call each); traced on fake tensors, their
    registered shapes and types come out without a launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    for op in ("nms_select", "fused_matmul_bias_relu", "decode_boxes"):
        assert hasattr(torch.ops.multibox_torch, op)
    with FakeTensorMode():
        idx, sc = torch.ops.multibox_torch.nms_select(
            torch.empty(3, 18936, 4), torch.empty(3, 18936), 100, 0.5, float("-inf"))
        y = torch.ops.multibox_torch.fused_matmul_bias_relu(
            torch.empty(32, 6144, dtype=torch.bfloat16), torch.empty(6144, 1024, dtype=torch.bfloat16),
            torch.empty(1024), True)
        boxes = torch.ops.multibox_torch.decode_boxes(torch.empty(2, 9, 4), torch.empty(9, 4), True)
    assert (idx.shape, idx.dtype, sc.shape, sc.dtype) == ((3, 100), torch.int32, (3, 100),
                                                          torch.float32)
    assert (y.shape, y.dtype) == ((32, 1024), torch.bfloat16)
    assert boxes.shape == (2, 9, 4)
    assert kernels.launch_counts()["nms"] == 0


def test_config_is_the_same_surface_as_the_jax_package(tmp_path):
    """Own copy, same fields and defaults, same YAML in and out."""
    import dataclasses

    from multibox_tpu import config as jconfig
    from multibox_tpu_torch import config as tconfig

    assert dataclasses.asdict(tconfig.Config()) == dataclasses.asdict(jconfig.Config())
    assert tconfig._KEY_ALIASES == jconfig._KEY_ALIASES
    for path in sorted((ROOT / "configs").glob("*.yaml")):
        assert dataclasses.asdict(tconfig.parse_config_file(str(path))) == \
            dataclasses.asdict(jconfig.parse_config_file(str(path)))
    out = tmp_path / "cfg.yaml"
    cfg = tconfig.parse_config_dict({"NUM_PRIORS": 64, "use_pallas": True, "bogus": 1})
    tconfig.save_config(cfg, str(out))
    # YAML has no tuples: sequence fields come back as lists, in both packages
    back = dataclasses.asdict(tconfig.parse_config_file(str(out)))
    want = {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(cfg).items()}
    assert back == want and cfg.num_priors == 64 and cfg.use_pallas is True


def test_priors_io_and_grid_generator_match_the_jax_package(tmp_path):
    from multibox_tpu import priors as jpriors
    from multibox_tpu_torch import priors as tpriors

    want = jpriors.generate_priors_multiscale([4, 2], aspect_ratios=(1.0, 2.0))
    got = tpriors.generate_priors_multiscale([4, 2], aspect_ratios=(1.0, 2.0))
    np.testing.assert_array_equal(got, want)
    path = tmp_path / "priors.pkl"
    tpriors.save_priors(got, str(path))
    np.testing.assert_array_equal(jpriors.load_priors(str(path)), got)
    np.testing.assert_array_equal(tpriors.load_priors(str(path)), got)
    tpriors.save_priors(np.zeros((3, 5)), str(path))
    with pytest.raises(ValueError, match=r"priors must be \[P, 4\]"):
        tpriors.load_priors(str(path))


@pytest.mark.cuda
def test_kernels_match_their_plain_versions_on_the_card():
    """Needs a CUDA device and ``nvcc`` (``python -m pytest -m cuda``);
    ``chip_smoke.py`` holds the same comparison at the full shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA kernel has no interpret mode")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    boxes = t(np.sort(rng.uniform(0, 1, (3, 200, 2, 2)), axis=2).reshape(3, 200, 4)).to(dev)
    scores = t(rng.uniform(0, 1, (3, 200))).to(dev)
    idx, sc = nms_kernel.nms_select(boxes, scores, 50, 0.5, 0.1)
    want_idx, want_sc = nms_kernel.nms_batched_plain(boxes, scores, 50, 0.5, 0.1)
    assert torch.equal(idx, want_idx) and torch.equal(sc, want_sc)
    # the sorted scan's edges: signed zeros, NaN and infinities, all equal,
    # P = 1, K >= P, P off the chunk, a dense cluster
    zeros = t(rng.choice(np.array([0.0, -0.0, 0.25, -0.25]), (3, 200))).to(dev)
    odd = scores.clone()
    odd[:, ::5], odd[:, 1::7], odd[:, 2::11] = float("nan"), float("inf"), float("-inf")
    cluster = (boxes[:, :1] + 0.01 * t(rng.normal(0, 1, (3, 200, 4))).to(dev)).clamp(0, 1)
    ninf = float("-inf")
    for b, s, k, thr in ((boxes, zeros, 50, ninf), (boxes, zeros, 50, 0.0),
                         (boxes, odd, 50, ninf), (boxes, odd, 50, 0.5),
                         (boxes, torch.full_like(scores, 0.5), 50, 0.0),
                         (boxes[:, :1].contiguous(), scores[:, :1].contiguous(), 5, ninf),
                         (boxes, scores, 200, ninf), (boxes, scores, 300, ninf),
                         (boxes[:, :33].contiguous(), scores[:, :33].contiguous(), 40, 0.0),
                         (cluster, scores, 50, 0.0)):
        idx, sc = nms_kernel.nms_select(b, s, k, 0.5, thr)
        want_idx, want_sc = nms_kernel.nms_batched_plain(b, s, k, 0.5, thr)
        assert torch.equal(idx, want_idx) and torch.equal(sc, want_sc)
    # a kept list that does not fit beside a window is refused, and so are
    # boxes off a 16-byte boundary (one float4 a box)
    with pytest.raises(ValueError, match="kept list"):
        nms_kernel.nms_select(torch.zeros(1, 20000, 4, device=dev),
                              torch.zeros(1, 20000, device=dev), 20000)
    with pytest.raises(ValueError, match="16-byte"):
        nms_kernel.nms_select(torch.zeros(4001, device=dev)[1:].view(1, 1000, 4),
                              torch.zeros(1, 1000, device=dev), 10)
    # window by window past 1,024 boxes: a kept list of P boxes (the window
    # used up again and again), equal scores (the index digits decide),
    # scores near 0.5, P = 40,000, and scores off a 16-byte boundary (the
    # bulk copies' ragged ends)
    for P, k, kind in ((9468, 9468, "uniform"), (18936, 100, "uniform"),
                       (40000, 200, "uniform"), (9468, 200, "equal"),
                       (40000, 200, "concentrated"), (9470, 100, "offset")):
        plan = nms_kernel.nms_plan(2, P, k, nms_kernel.sm_count(dev))
        assert nms_kernel.nms_fits(P, k) and plan.window > 0 and plan.staged
        b = t(np.sort(rng.uniform(0, 1, (2, P, 2, 2)), axis=2).reshape(2, P, 4)).to(dev)
        s = t(np.full((2, P), 0.5) if kind == "equal" else
              0.5 + rng.normal(0, 1e-3, (2, P)) if kind == "concentrated" else
              rng.uniform(0, 1, (2, P))).to(dev)
        if kind == "offset":
            s = torch.cat([torch.zeros(1, device=dev), s.flatten()])[1:].view(2, P)
            assert s.data_ptr() % 16
        idx, sc = nms_kernel.nms_select(b, s, k, 0.5, 0.05)
        want_idx, want_sc = nms_kernel.nms_batched_plain(b, s, k, 0.5, 0.05)
        assert torch.equal(idx, want_idx) and torch.equal(sc, want_sc)
    # the refill: K large and suppression heavy, so the scan uses up its
    # window and goes on below the floor with the same kept list
    centre = np.sort(rng.uniform(0.3, 0.7, (2, 1, 2, 2)), axis=2).reshape(2, 1, 4)
    b = t(np.clip(centre + rng.normal(0, 0.05, (2, 9468, 4)), 0, 1)).to(dev)
    s = t(rng.uniform(0, 1, (2, 9468))).to(dev)
    idx, sc = nms_kernel.nms_select(b, s, 3000, 0.3, 0.0)
    want_idx, want_sc = nms_kernel.nms_batched_plain(b, s, 3000, 0.3, 0.0)
    assert torch.equal(idx, want_idx) and torch.equal(sc, want_sc)
    _, _, work = nms_kernel.sorted_scan_emulation(b.cpu().numpy(), s.cpu().numpy(), 3000,
                                                  0.3, 0.0)
    assert work.windows.min() >= 2
    # scores read from global memory at every pass, past what a block stages:
    # 64 images of 50,000 boxes (one block each), and a kept list at nms_fits'
    # limit beside a cluster's slices (small boxes: K fills window after window)
    for B, P, k, side in ((64, 50000, 100, (0.02, 0.6)), (1, 40000, 11968, (0.002, 0.02))):
        plan = nms_kernel.nms_plan(B, P, k, nms_kernel.sm_count(dev))
        assert nms_kernel.nms_fits(P, k) and plan.window > 0 and not plan.staged
        lo = rng.uniform(0, 1 - side[1], (B, P, 2))
        b = t(np.concatenate([lo, lo + rng.uniform(*side, (B, P, 2))], -1)).to(dev)
        s = t(rng.uniform(0, 1, (B, P))).to(dev)
        idx, sc = nms_kernel.nms_select(b, s, k, 0.5, 0.0)
        want_idx, want_sc = nms_kernel.nms_batched_plain(b, s, k, 0.5, 0.0)
        assert torch.equal(idx, want_idx) and torch.equal(sc, want_sc)
    x, w, b = (t(rng.normal(0, 1, s)).to(dev) for s in ((33, 130), (130, 70), (70,)))
    torch.testing.assert_close(
        fused_matmul.fused_matmul_bias_relu(x, w, b, True),
        fused_matmul.fused_matmul_plain(x, w, b, True), rtol=1e-4, atol=1e-4)
    # one small case per route of the matmul, each launched twice: bit-equal
    for M, Kd, N, dtype, route in ((8, 256, 200, torch.float32, "skinny"),
                                   (600, 512, 100, torch.float32, "f32_tile"),
                                   (300, 64, 48, torch.bfloat16, "wgmma_bf16"),
                                   (256, 1024, 192, torch.bfloat16, "wgmma_bf16"),
                                   (65, 17, 129, torch.bfloat16, "general")):
        plan = fused_matmul._plan(M, Kd, N, dtype)
        assert plan.route == route
        xr = t(np.maximum(rng.normal(0, 1, (M, Kd)), 0)).to(dev, dtype)
        wr = t(rng.normal(0, 1, (Kd, N)) / np.sqrt(Kd)).to(dev, dtype)
        br = t(rng.normal(0, 0.1, N)).to(dev)
        got = fused_matmul.fused_matmul_bias_relu(xr, wr, br, True)
        assert torch.equal(got, fused_matmul.fused_matmul_bias_relu(xr, wr, br, True))
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), fused_matmul.fused_matmul_plain(
            xr, wr, br, True).float(), rtol=tol, atol=tol)
    off, pri = t(rng.normal(0, 0.3, (3, 77, 4))).to(dev), t(rng.uniform(0, 1, (77, 4))).to(dev)
    assert torch.equal(box_kernel.decode_boxes_cuda(off, pri),
                       box_kernel.decode_boxes_plain(off, pri[None]))
    assert torch.equal(box_kernel.encode_boxes_cuda(off, pri),
                       box_kernel.encode_boxes_plain(off, pri[None]))
    with pytest.raises(ValueError, match="16-byte"):
        box_kernel.decode_boxes_cuda(torch.zeros(33, device=dev)[1:].view(2, 4, 4), pri[:4])
    gt = t(np.sort(rng.uniform(0, 1, (5, 16, 2, 2)), axis=2).reshape(5, 16, 4)).to(dev)
    n = torch.tensor([16, 3, 0, 9, 40], dtype=torch.int32, device=dev)
    assert torch.equal(match_kernel.greedy_match_cuda(gt, n, boxes[0]),
                       match_kernel.greedy_match_plain(gt, n, boxes[0]))
    # G = 64: two rows a lane in the rounds warp, P = 512
    gt = t(np.sort(rng.uniform(0, 1, (3, 64, 2, 2)), axis=2).reshape(3, 64, 4)).to(dev)
    pri = t(np.sort(rng.uniform(0, 1, (512, 2, 2)), axis=1).reshape(512, 4)).to(dev)
    n = torch.tensor([64, 10, 0], dtype=torch.int32, device=dev)
    assert torch.equal(match_kernel.greedy_match_cuda(gt, n, pri),
                       match_kernel.greedy_match_plain(gt, n, pri))
    xg, wg, bg = (a.clone().requires_grad_(True) for a in (x, w, b))
    grads = torch.autograd.grad(fused_matmul.fused_matmul_bias_relu(xg, wg, bg).sum(),
                                (xg, wg, bg))
    want = torch.autograd.grad(fused_matmul.fused_matmul_plain(xg, wg, bg).sum(),
                               (xg, wg, bg))
    for got, ref in zip(grads, want):
        torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="float32 only"):
        nms_kernel.nms_select(boxes.double(), scores.double(), 5)

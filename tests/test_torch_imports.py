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
from multibox_tpu_torch.config import Config
from multibox_tpu_torch.device import resolve_device
from multibox_tpu_torch.models import convert
from multibox_tpu_torch.ops import kernels
from multibox_tpu_torch.ops.kernels import box_kernel, fused_matmul, nms_kernel

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "multibox_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "multibox_tpu")


def port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    return files


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


def needs_no_cuda():
    if torch.cuda.is_available():
        pytest.skip("this test describes a machine without a CUDA device")


SMALL = dict(input_size=75, num_priors=4, compute_dtype="float32")
PRIORS = np.array([[0.1, 0.1, 0.5, 0.5]] * 4, np.float32)


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
    ],
    ids=["resolve_device", "build_model", "make_detect_fn", "make_detect_body",
         "make_detect_loop_fns", "run_detect_loop", "flax_to_torch", "explicit_cuda"],
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
    ],
    ids=["nms_shape", "nms_rank", "nms_k", "matmul_inner", "matmul_bias", "matmul_device"],
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
    [(nms_kernel, "nms_select"), (fused_matmul, "fused_matmul_bias_relu"),
     (box_kernel, "decode_boxes_cuda"), (box_kernel, "encode_boxes_cuda")],
    ids=["nms", "fused_matmul", "box_decode", "box_encode"],
)
def test_wrappers_have_no_fallback_and_count_their_launches(module, name):
    """No ``try`` around the launch, the plain version only behind an
    ``is_cuda`` test, one count beside the launch."""
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
    assert kernels.launch_counts() == {
        "nms": 0, "fused_matmul": 0, "box_decode": 0, "box_encode": 0}
    assert kernels.resolve_use_pallas(None, torch.zeros(1)) is False
    assert kernels.resolve_use_pallas(True, torch.zeros(1)) is True


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
    x, w, b = (t(rng.normal(0, 1, s)).to(dev) for s in ((33, 130), (130, 70), (70,)))
    torch.testing.assert_close(
        fused_matmul.fused_matmul_bias_relu(x, w, b, True),
        fused_matmul.fused_matmul_plain(x, w, b, True), rtol=1e-4, atol=1e-4)
    off, pri = t(rng.normal(0, 0.3, (3, 77, 4))).to(dev), t(rng.uniform(0, 1, (77, 4))).to(dev)
    assert torch.equal(box_kernel.decode_boxes_cuda(off, pri),
                       box_kernel.decode_boxes_plain(off, pri[None]))
    assert torch.equal(box_kernel.encode_boxes_cuda(off, pri),
                       box_kernel.encode_boxes_plain(off, pri[None]))
    with pytest.raises(ValueError, match="float32 only"):
        nms_kernel.nms_select(boxes.double(), scores.double(), 5)

"""The port's user tools on the CPU: ``multibox-torch-doctor`` (the cases of
``tests/test_doctor.py``: a hung probe killed, a crash, wrong arithmetic,
garbage, a slow probe, ``--json``, the exit code; the device probe swapped
for stand-in subprocesses), ``multibox-torch-visualize`` and
``multibox-torch-visualize-inputs`` (their PNGs with ``--device cpu``).

``visualize_inputs`` is held to the JAX package's CLI through what each
hands to ``draw_boxes``: the augmented ground-truth boxes (rtol 1e-6 /
atol 1e-6, ``tests/test_torch_train_loop.py``'s bound for augmented boxes)
and the matched priors (exact). The two packages draw their augmentation
from different generators, so the port replays the JAX draws of each
batch's key, as that file does.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax

from multibox_tpu.cli import visualize_inputs as jvis_inputs
from multibox_tpu.config import parse_config_file as jparse_config
from multibox_tpu_torch.cli import doctor
from multibox_tpu_torch.cli import visualize as tvis
from multibox_tpu_torch.cli import visualize_inputs as tvis_inputs
from multibox_tpu_torch.config import parse_config_file
from multibox_tpu_torch.data import _native
from multibox_tpu_torch.data import augment as taug
from multibox_tpu_torch.data.example_proto import build_detection_example
from multibox_tpu_torch.data.jpeg import encode_jpeg
from multibox_tpu_torch.data.tfrecord import TFRecordWriter
from multibox_tpu_torch.inference import build_model
from multibox_tpu_torch.ops import kernels
from multibox_tpu_torch.priors import save_priors
from multibox_tpu_torch.train import create_train_state
from multibox_tpu_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_train_loop import jax_augment_draws
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


# ---------------------------------------------------------------- doctor

def fake_probe(**over):
    payload = {"value": 64.0, "matmul_equal": True, "decode_equal": True,
               "decode_launches": 1, "platform": "cuda", "device_kind": "fake",
               "n_devices": 1, "elapsed_s": 0.5}
    payload.update(over)
    return f"print({json.dumps(json.dumps(payload))})"


def test_device_probe_hang_is_killed_and_failed(monkeypatch):
    monkeypatch.setattr(doctor, "_PROBE_SRC", "import time; time.sleep(60)")
    status, name, detail = doctor.check_device(timeout_s=1.0)
    assert (status, name) == ("fail", "device")
    assert "hung" in detail and "killed" in detail


def test_device_probe_crash_reports_stderr_tail(monkeypatch):
    monkeypatch.setattr(doctor, "_PROBE_SRC",
                        "import sys; print('boom: no device', file=sys.stderr); sys.exit(3)")
    status, name, detail = doctor.check_device(timeout_s=30.0)
    assert (status, name) == ("fail", "device")
    assert "exited 3" in detail and "boom: no device" in detail


@pytest.mark.parametrize("over,words", [
    ({"value": 0.0}, "wrong arithmetic"),
    ({"matmul_equal": False}, "differs from the CPU"),
    ({"decode_equal": False}, "decode kernel differs"),
    ({"decode_launches": 0}, "decode kernel differs"),
], ids=["sum", "matmul", "decode", "no_launch"])
def test_device_probe_wrong_results_fail(monkeypatch, over, words):
    monkeypatch.setattr(doctor, "_PROBE_SRC", fake_probe(**over))
    status, _, detail = doctor.check_device(timeout_s=30.0)
    assert status == "fail" and words in detail


def test_device_probe_garbage_output_fails(monkeypatch):
    monkeypatch.setattr(doctor, "_PROBE_SRC", "print('not json')")
    status, _, detail = doctor.check_device(timeout_s=30.0)
    assert status == "fail" and "unparseable" in detail


def test_device_probe_ok_and_slow_warn(monkeypatch):
    monkeypatch.setattr(doctor, "_PROBE_SRC", fake_probe(n_devices=8))
    status, _, detail = doctor.check_device(timeout_s=30.0)
    assert status == "ok" and "8x fake" in detail
    monkeypatch.setattr(doctor, "_PROBE_SRC", fake_probe(elapsed_s=61.0))
    status, _, detail = doctor.check_device(timeout_s=30.0)
    assert status == "warn" and "slow" in detail


def test_device_probe_fails_without_a_cuda_device():
    """The real probe, on a machine without a card: a fail, not a hang or
    an exception in the doctor."""
    if torch.cuda.is_available():
        pytest.skip("this test describes a machine without a CUDA device")
    status, name, detail = doctor.check_device(timeout_s=120.0)
    assert (status, name) == ("fail", "device") and "probe exited" in detail


def test_host_checks():
    assert doctor.check_python_deps()[:2] == ("ok", "python-deps")
    assert doctor.check_tfrecord_roundtrip()[:2] == ("ok", "tfrecord-roundtrip")
    status, name, detail = doctor.check_native_layer()
    assert (status, name) == ("ok", "native-layer") and "tfrecord reader loaded" in detail
    assert ("JPEG decoder loaded" in detail) == _native.jpeg_headers_present()


def test_native_layer_reports_an_absent_header_and_fails_a_broken_build(monkeypatch):
    monkeypatch.setattr(_native, "jpeg_headers_present", lambda: False)
    status, _, detail = doctor.check_native_layer()
    assert status == "ok" and "jpeglib.h absent" in detail

    def broken(name):
        raise RuntimeError(f"g++ failed on {name}.cc")

    monkeypatch.setattr(_native, "_libs", {})
    monkeypatch.setattr(_native, "build", broken)
    status, _, detail = doctor.check_native_layer()
    assert status == "fail" and "g++ failed" in detail


def test_kernel_build_check(monkeypatch, tmp_path):
    def no_nvcc():
        raise RuntimeError("nvcc not found (test)")

    monkeypatch.setattr(kernels, "find_nvcc", no_nvcc)
    monkeypatch.setattr(torch.version, "cuda", None)
    assert doctor.check_kernel_build()[0] == "warn"  # a CPU build of torch needs none
    monkeypatch.setattr(torch.version, "cuda", "12.8")
    status, name, detail = doctor.check_kernel_build()
    assert (status, name) == ("fail", "kernel-build") and "nvcc not found" in detail
    monkeypatch.setattr(kernels, "find_nvcc", lambda: "/usr/local/cuda/bin/nvcc")
    monkeypatch.setenv("MULTIBOX_TORCH_BUILD_DIR", str(tmp_path / "a" / "b"))
    status, _, detail = doctor.check_kernel_build()
    assert status == "ok" and "0 built libraries" in detail
    os.chmod(tmp_path, 0o500)
    try:
        if not os.access(tmp_path, os.W_OK):  # root writes anywhere
            assert doctor.check_kernel_build()[0] == "fail"
    finally:
        os.chmod(tmp_path, 0o700)


def test_platform_config(monkeypatch):
    monkeypatch.setattr(torch.version, "cuda", None)
    status, _, detail = doctor.check_platform_config()
    assert status == "warn" and "CPU-only" in detail
    monkeypatch.setattr(torch.version, "cuda", "12.8")
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    assert doctor.check_platform_config()[0] == "ok"
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    status, _, detail = doctor.check_platform_config()
    assert status == "warn" and "hides every CUDA device" in detail


def test_main_json_skip_device(capsys):
    rc = doctor.main(["--skip_device", "--json"])
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"ok", "checks"}
    names = [c["name"] for c in out["checks"]]
    assert names == ["python-deps", "platform-config", "kernel-build", "native-layer",
                     "tfrecord-roundtrip"]
    assert all(c["status"] != "fail" for c in out["checks"])
    assert rc == 0 and out["ok"] is True


def test_main_exit_code_reflects_failure(monkeypatch, capsys):
    monkeypatch.setattr(doctor, "_PROBE_SRC", "import sys; sys.exit(1)")
    rc = doctor.main(["--device_timeout", "30", "--json"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 1 and out["ok"] is False
    assert {c["name"]: c["status"] for c in out["checks"]}["device"] == "fail"


def test_main_human_output_lines(capsys):
    rc = doctor.main(["--skip_device"])
    captured = capsys.readouterr()
    assert rc == 0
    for line in captured.out.strip().splitlines():
        assert line.startswith(("[ok]", "[warn]", "[fail]"))
    assert "all checks passed" in captured.err


def test_console_scripts_registered():
    import tomllib

    with open(os.path.join(os.path.dirname(os.path.dirname(__file__)), "pyproject.toml"),
              "rb") as f:
        project = tomllib.load(f)
    scripts = project["project"]["scripts"]
    for name, module in (("dataset", "dataset"), ("visualize", "visualize"),
                         ("visualize-inputs", "visualize_inputs"), ("doctor", "doctor")):
        assert scripts[f"multibox-torch-{name}"] == f"multibox_tpu_torch.cli.{module}:main"
    data = project["tool"]["setuptools"]["package-data"]["multibox_tpu_torch"]
    assert "native/*.cc" in data and "csrc/*.cu" in data


# ------------------------------------------------------------- visualize

@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Five JPEG records at 80 px with 1-3 boxes, priors, and a MobileNetV2
    0.5 config at 75 px (a small checkpoint)."""
    root = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(0)
    records = str(root / "val.tfrecord")
    with TFRecordWriter(records) as w:
        for i in range(5):
            img = np.full((80, 80, 3), 30, np.uint8)
            boxes = []
            for _ in range(int(rng.integers(1, 4))):
                y0, x0 = rng.uniform(0.05, 0.5, 2)
                y1, x1 = y0 + rng.uniform(0.2, 0.45), x0 + rng.uniform(0.2, 0.45)
                img[int(y0 * 80):int(y1 * 80), int(x0 * 80):int(x1 * 80)] = rng.integers(
                    120, 256, 3)
                boxes.append([y0, x0, y1, x1])
            w.write(build_detection_example(encode_jpeg(img), f"img-{i}", np.array(boxes),
                                            labels=[1] * len(boxes), height=80, width=80))
    config = str(root / "config.yaml")
    with open(config, "w") as f:
        yaml.safe_dump({"INPUT_SIZE": 75, "BATCH_SIZE": 2, "MAX_NUM_BBOXES": 4,
                        "NUM_PRIORS": 12, "backbone": "mobilenet_v2", "mobilenet_width": 0.5,
                        "compute_dtype": "float32", "detect_score_threshold": 0.0,
                        "max_detections": 4}, f)
    priors = np.sort(rng.uniform(0.05, 0.95, (12, 2, 2)).astype(np.float32), axis=1)
    save_priors(priors.reshape(12, 4), str(root / "priors.pkl"))
    yield {"root": root, "records": records, "config": config,
           "priors": str(root / "priors.pkl")}
    for path in root.rglob("*.pt"):
        path.unlink()


@pytest.fixture(scope="module")
def logdir(workdir):
    """A checkpoint of a fresh state at step 1."""
    cfg = parse_config_file(workdir["config"])
    model = build_model(cfg, 12, device="cpu")
    path = str(workdir["root"] / "logdir")
    CheckpointManager(path).save(1, create_train_state(cfg, model, 0, 12, device="cpu"),
                                 force=True)
    return path


def test_visualize_writes_its_pngs_on_the_cpu(workdir, logdir, monkeypatch, capsys):
    drawn = []
    monkeypatch.setattr(tvis, "draw_boxes",
                        lambda ax, boxes, color, labels=None: drawn.append((color, boxes)))
    out = workdir["root"] / "pred"
    assert tvis.main(["--tfrecords", workdir["records"], "--priors", workdir["priors"],
                      "--checkpoint_path", logdir, "--output_dir", str(out),
                      "--config", workdir["config"], "--max_images", "4",
                      "--score_threshold", "0.0", "--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == [f"pred_{i:04d}.png" for i in range(4)]
    assert "wrote 4 visualizations" in capsys.readouterr().out
    assert [c for c, _ in drawn] == ["lime", "red"] * 4
    for _, boxes in drawn[1::2]:  # predictions: at most max_detections each
        assert 0 < len(boxes) <= 4


def test_visualize_inputs_draws_what_the_jax_cli_draws(workdir, monkeypatch):
    seed, batches = 3, 2
    jcfg = jparse_config(workdir["config"])
    calls = []

    def replayed(gen, batch, cfg):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), len(calls))
        calls.append(batch)
        return jax_augment_draws(key, batch, jcfg)

    monkeypatch.setattr(taug, "draw_augment_params", replayed)
    drawn = {}
    for name, module in (("jax", jvis_inputs), ("torch", tvis_inputs)):
        drawn[name] = []
        monkeypatch.setattr(module, "draw_boxes", lambda ax, boxes, color, labels=None,
                            out=drawn[name]: out.append((color, np.asarray(boxes))))
        out = workdir["root"] / f"inputs_{name}"
        args = ["--tfrecords", workdir["records"], "--output_dir", str(out),
                "--num_batches", str(batches), "--priors", workdir["priors"],
                "--seed", str(seed), "--config", workdir["config"]]
        assert module.main(args + (["--device", "cpu"] if name == "torch" else [])) == 0
        assert sorted(os.listdir(out)) == [f"input_{i:04d}.png" for i in range(4)]
    assert calls == [2, 2]
    got, want = drawn["torch"], drawn["jax"]
    assert [c for c, _ in got] == [c for c, _ in want]
    assert "red" in [c for c, _ in want]
    for (color, g), (_, w) in zip(got, want):
        assert g.shape == w.shape
        if color == "lime":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, w)

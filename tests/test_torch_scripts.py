"""The port's copies of the JAX package's scripts, on the CPU:
``scripts/torch_synth_multiclass.py`` writes shards byte-identical to
``scripts/synth_multiclass.py``'s for the same seed and counts;
``scripts/torch_train_batch_sweep.py --device cpu`` prints the JAX script's
keys (plus ``peak_memory_bytes``) for one tiny arm; and
``scripts/torch_serve_bench.py --device cpu`` drives the port's HTTP daemon
over a tiny export and prints the JAX script's rows and summary, 429s
counted under a bounded queue.
"""

import importlib.util
import json
import pathlib
import shutil

import numpy as np
import pytest
import torch

from multibox_tpu_torch.cli import export as cli_export
from multibox_tpu_torch.config import Config
from multibox_tpu_torch.inference import build_model
from multibox_tpu_torch.serve import DetectorService
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parent.parent


def script(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("extra", [[], ["--num_classes", "80", "--label_base", "1"]],
                         ids=["three_classes", "coco_ids"])
def test_synth_multiclass_shards_are_byte_identical(tmp_path, extra, capsys):
    args = ["--train", "6", "--val", "2", "--canvas", "48", "--seed", "5", *extra]
    for name, out in (("synth_multiclass", "jax"), ("torch_synth_multiclass", "torch")):
        assert script(name).main(["--output_dir", str(tmp_path / out), *args]) == 0
    for shard in ("train.tfrecord", "val.tfrecord"):
        want = (tmp_path / "jax" / shard).read_bytes()
        assert len(want) > 6 * 48 * 48 * 3 // 4
        assert (tmp_path / "torch" / shard).read_bytes() == want
    assert capsys.readouterr().out.count("wrote 6 train + 2 val") == 2


def test_batch_sweep_prints_the_jax_scripts_keys_and_peak_memory(tmp_path, capsys):
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text("INPUT_SIZE: 75\nNUM_PRIORS: 16\nMAX_NUM_BBOXES: 4\nnum_classes: 3\n"
                   "backbone: mobilenet_v2\nmobilenet_width: 0.5\ncompute_dtype: float32\n")
    sweep = script("torch_train_batch_sweep")
    assert sweep.main(["--device", "cpu", "--arms", "b32", "--iters", "1",
                       "--config", str(cfg)]) == 0
    (row,) = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert set(row) == {"arm", "batch", "ms_per_step", "img_s", "tflops", "mfu",
                        "peak_memory_bytes"}
    assert row["arm"] == "b32" and row["batch"] == 32
    assert row["ms_per_step"] > 0 and row["img_s"] == pytest.approx(32e3 / row["ms_per_step"])
    assert row["tflops"] > 0
    # a CPU run names no device metric
    assert row["mfu"] is None and row["peak_memory_bytes"] is None


def test_batch_sweep_prints_an_arms_error_and_goes_on(monkeypatch, capsys):
    sweep = script("torch_train_batch_sweep")

    def fail(name, iters, base, device):
        raise RuntimeError(f"{name} failed")

    monkeypatch.setattr(sweep, "bench_arm", fail)
    assert sweep.main(["--device", "cpu", "--arms", "b32", "b128"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert rows == [{"arm": "b32", "error": "RuntimeError: b32 failed"},
                    {"arm": "b128", "error": "RuntimeError: b128 failed"}]


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    """MobileNetV2 0.5 at 75 px, 16 priors, programs at batch sizes 1 and 4."""
    root = tmp_path_factory.mktemp("torch_serve_bench")
    rng = np.random.default_rng(0)
    priors = np.sort(rng.uniform(0.05, 0.95, (16, 2, 2)).astype(np.float32),
                     axis=1).reshape(16, 4)
    cfg = Config(input_size=75, num_priors=16, compute_dtype="float32", max_detections=5,
                 backbone="mobilenet_v2", mobilenet_width=0.5)
    model = build_model(cfg, 16, device="cpu")
    variables = model.init_variables(torch.Generator().manual_seed(0))
    out = str(root / "export")
    cli_export.export_detector(cfg, model, variables, priors, out, [1, 4], "cpu")
    yield out
    shutil.rmtree(root, ignore_errors=True)


ROW_KEYS = {"config", "max_batch", "batch_window_ms", "max_queue_depth", "concurrency",
            "requests", "p50_ms", "p90_ms", "p99_ms", "throughput_rps", "errors", "shed_429",
            "device_batches", "imgs_per_device_batch"}


def test_serve_bench_prints_the_jax_scripts_rows_and_summary(export_dir, capsys):
    bench = script("torch_serve_bench")
    rows = bench.main(["--export_dir", export_dir, "--device", "cpu", "--concurrency", "1",
                       "2", "--requests", "2", "--windows", "2", "--input_size", "75"])
    out = capsys.readouterr().out
    summary = json.loads(out[out.index('{\n "summary"'):])["summary"]
    assert summary == rows
    assert [(r["config"], r["concurrency"]) for r in rows] == [
        ("batched_w2", 1), ("batched_w2", 2), ("max_batch_1", 1), ("max_batch_1", 2)]
    for r in rows:
        assert set(r) == ROW_KEYS
        assert r["errors"] == 0 and r["shed_429"] == 0
        assert r["requests"] == 2 * r["concurrency"]
        assert 0 < r["p50_ms"] <= r["p90_ms"] <= r["p99_ms"] and r["throughput_rps"] > 0
    default_depth = DetectorService.DEFAULT_MAX_QUEUE_FACTOR * 4  # the largest program's
    assert rows[0]["max_batch"] is None and rows[0]["max_queue_depth"] == default_depth
    assert rows[2]["max_batch"] == 1 and rows[2]["imgs_per_device_batch"] == 1.0


def test_serve_bench_counts_429s_under_a_bounded_queue(export_dir, capsys):
    """Three clients against a queue of one: the daemon sheds, the client
    counts each 429 (and backs off by the Retry-After hint) and no error."""
    bench = script("torch_serve_bench")
    (row,) = bench.main(["--export_dir", export_dir, "--device", "cpu", "--concurrency",
                         "3", "--requests", "1", "--windows", "500", "--input_size", "75",
                         "--max_queue_depths", "1", "--skip_unbatched"])
    assert row["config"] == "batched_w500_q1" and row["max_queue_depth"] == 1
    assert row["errors"] == 0 and row["shed_429"] >= 1
    assert row["requests"] + row["shed_429"] == 3

"""The port's command-line path on a tiny tfrecord fixture (75 px, 16
priors, batch 4, the JAX package's tests/test_cli_end_to_end.py fixture):
priors (k-means) → train (Hungarian matching, periodic eval, 6 steps then
resumed to 10) → detect → evaluate, on the CPU (``--device cpu``), and
against the JAX package's CLIs and detect loop.

Tolerances: detections of the same weights (converted with
``models.convert``) on the same records: indices and classes exact, boxes
and scores atol 1e-5 (tests/test_torch_detect.py's). Evaluations of one
detections file by both packages' evaluators: the same printed numbers.
The whole model's checkpoint is some 350 MB, so one is kept per logdir and
all are removed when the module ends.
"""

import os
import pathlib
import pickle

import numpy as np
import pytest
import yaml

import jax
import jax.numpy as jnp

from multibox_tpu import inference as jinf
from multibox_tpu.config import parse_config_file as jparse_config
from multibox_tpu.data.pipeline import DetectionDataset as JDetectionDataset
from multibox_tpu_torch.config import parse_config_file
from multibox_tpu_torch.data.example_proto import build_detection_example
from multibox_tpu_torch.data.jpeg import encode_jpeg
from multibox_tpu_torch.data.tfrecord import TFRecordWriter
from multibox_tpu_torch.inference import build_model
from multibox_tpu_torch.models import convert
from multibox_tpu_torch.ops import matching as tmatching
from multibox_tpu_torch.priors import load_priors
from multibox_tpu_torch.train.state import create_train_state
from multibox_tpu_torch.utils.checkpoint import CheckpointManager
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(0)
    # bright rectangles on a dark background, 1-2 an image
    tf_path = str(root / "train.tfrecord")
    with TFRecordWriter(tf_path) as w:
        for i in range(16):
            img = np.full((80, 80, 3), 30, np.uint8)
            boxes = []
            for _ in range(int(rng.integers(1, 3))):
                y0, x0 = rng.uniform(0.1, 0.5, 2)
                h, w_ = rng.uniform(0.2, 0.4, 2)
                y1, x1 = min(y0 + h, 0.95), min(x0 + w_, 0.95)
                img[int(y0 * 80):int(y1 * 80), int(x0 * 80):int(x1 * 80)] = [220, 180, 60]
                boxes.append([y0, x0, y1, x1])
            w.write(build_detection_example(encode_jpeg(img), f"img-{i}", np.array(boxes),
                                            labels=[1] * len(boxes), height=80, width=80))
    cfg_path = str(root / "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({
            "INPUT_SIZE": 75, "BATCH_SIZE": 4, "MAX_NUM_BBOXES": 4,
            "NUM_TRAIN_EXAMPLES": 16, "INITIAL_LEARNING_RATE": 0.003,
            "compute_dtype": "float32", "save_every_steps": 5, "log_every_steps": 2,
            "detect_score_threshold": 0.0, "max_detections": 8, "augment": True,
            "color_distort": False, "matching": "hungarian", "keep_checkpoints": 1,
        }, f)
    yield {"root": root, "tfrecord": tf_path, "config": cfg_path}
    for path in root.rglob("*.pt"):
        path.unlink()


@pytest.fixture(scope="module")
def priors_file(workdir):
    from multibox_tpu_torch.cli.priors import main

    out = str(workdir["root"] / "priors.pkl")
    assert main(["--tfrecords", workdir["tfrecord"], "--output", out, "--mode", "kmeans",
                 "--num_priors", "16", "--device", "cpu"]) == 0
    return out


def train_args(workdir, priors_file, logdir):
    return ["--tfrecords", workdir["tfrecord"], "--priors", priors_file,
            "--logdir", logdir, "--config", workdir["config"], "--no_mesh",
            "--device", "cpu"]


@pytest.fixture(scope="module")
def trained(workdir, priors_file):
    """6 steps, then a second invocation resumed to 10; eval every 5."""
    from multibox_tpu_torch.cli.train import main

    logdir = str(workdir["root"] / "logdir")
    args = train_args(workdir, priors_file, logdir) + [
        "--eval_tfrecords", workdir["tfrecord"], "--eval_every_steps", "5"]
    tmatching.reset_exit_tests()
    assert main(args + ["--max_number_of_steps", "6"]) == 0
    assert main(args + ["--max_number_of_steps", "10"]) == 0
    return {"logdir": logdir, "hungarian": dict(tmatching.EXIT_TESTS)}


@pytest.fixture(scope="module")
def detections_file(workdir, priors_file, trained):
    from multibox_tpu_torch.cli.detect import main

    out = str(workdir["root"] / "detections.pkl")
    assert main(["--tfrecords", workdir["tfrecord"], "--priors", priors_file,
                 "--checkpoint_path", trained["logdir"], "--output", out,
                 "--config", workdir["config"], "--device", "cpu"]) == 0
    return out


def read_metrics(logdir):
    import json

    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_priors_cli_kmeans_and_multiscale(workdir, priors_file):
    from multibox_tpu_torch.cli.priors import main

    priors = load_priors(priors_file)
    assert priors.shape == (16, 4) and (priors[:, 2:] >= priors[:, :2]).all()
    out = str(workdir["root"] / "priors_ms.pkl")
    assert main(["--output", out, "--mode", "multiscale", "--feature_map_sizes", "4", "2",
                 "--aspect_ratios", "1.0", "2.0", "--device", "cpu"]) == 0
    assert load_priors(out).shape == ((16 + 4) * 3, 4)


def test_train_cli_uses_hungarian_resumes_and_evaluates(workdir, trained):
    assert parse_config_file(workdir["config"]).matching == "hungarian"
    assert trained["hungarian"]["calls"] == 10  # one matching per step
    logged = read_metrics(trained["logdir"])
    steps = [r["step"] for r in logged if "loss" in r]
    assert steps == [2, 4, 6, 8, 10]  # the second invocation went on from 6
    assert all(np.isfinite(r["loss"]) for r in logged if "loss" in r)
    evals = [r for r in logged if "eval/AP@0.5" in r]
    assert [r["step"] for r in evals] == [5, 10]
    assert all(np.isfinite(v) for r in evals for v in r.values())
    assert evals[0]["eval/num_images"] == 16.0
    assert CheckpointManager(trained["logdir"]).all_steps() == [10]


def test_detect_and_eval_clis_and_the_jax_evaluator_agree(workdir, detections_file, capsys):
    from multibox_tpu.cli.evaluate import main as jeval
    from multibox_tpu_torch.cli.evaluate import main as teval

    results = pickle.load(open(detections_file, "rb"))
    assert {r["image_id"] for r in results} == {f"img-{i}" for i in range(16)}
    assert all(r["boxes"].shape[1] == 4 and (r["boxes"] >= 0).all()
               and (r["boxes"] <= 1).all() for r in results)
    capsys.readouterr()
    args = ["--tfrecords", workdir["tfrecord"], "--detections", detections_file,
            "--config", workdir["config"]]
    assert teval(args + ["--device", "cpu", "--by_size"]) == 0
    got = capsys.readouterr().out
    assert jeval(args + ["--by_size"]) == 0
    assert got == capsys.readouterr().out
    assert "AP@0.5:" in got and "mAP@[.5:.95]:" in got


def spread_variables(jvars, rng):
    """Random-init confidences all sit near 0.5, where a 1e-7 logit
    difference reorders NMS: move the head's biases apart (as
    tests/test_torch_detect.py does), and add the EMA collection."""
    tree = jax.tree_util.tree_map(np.array, jvars)
    head = tree["params"]["MultiBoxHead"]
    head["Confidences"]["bias"] = rng.normal(0, 1.0, head["Confidences"]["bias"].shape
                                             ).astype(np.float32)
    head["Locations"]["bias"] = rng.normal(0, 0.05, head["Locations"]["bias"].shape
                                           ).astype(np.float32)
    tree["ema"] = tree["params"]
    return tree


def test_detect_cli_matches_the_jax_detect_loop(workdir, priors_file, tmp_path, capsys):
    """The same weights: the JAX package's initial variables, converted
    with models.convert into a checkpoint of the port; the port's detect
    CLI against the JAX package's run_detect_loop on the same records, then
    both evaluators on the port's file."""
    from multibox_tpu.cli.evaluate import main as jeval
    from multibox_tpu_torch.cli.detect import main as tdetect
    from multibox_tpu_torch.cli.evaluate import main as teval

    jcfg = jparse_config(workdir["config"])
    cfg = parse_config_file(workdir["config"])
    priors = load_priors(priors_file)
    jmodel = jinf.build_model(jcfg, 16)
    x = jnp.zeros((1, 75, 75, 3), jnp.float32)
    jvars = spread_variables(jax.jit(jmodel.init)(jax.random.PRNGKey(0), x),
                             np.random.default_rng(1))
    want = jinf.run_detect_loop(
        jcfg, jvars, JDetectionDataset([workdir["tfrecord"]], batch_size=4, canvas_size=75,
                                       max_num_bboxes=4), jnp.asarray(priors))

    tvars = convert.flax_to_torch({k: jvars[k] for k in ("params", "batch_stats")},
                                  device="cpu")
    model = build_model(cfg, 16, device="cpu")
    state = create_train_state(cfg, model, 0, 16, device="cpu", variables=tvars)
    logdir = str(tmp_path / "converted")
    CheckpointManager(logdir).save(1, state, force=True)
    out = str(tmp_path / "detections.pkl")
    assert tdetect(["--tfrecords", workdir["tfrecord"], "--priors", priors_file,
                    "--checkpoint_path", logdir, "--output", out,
                    "--config", workdir["config"], "--device", "cpu"]) == 0
    os.remove(os.path.join(logdir, "ckpt_1.pt"))
    got = pickle.load(open(out, "rb"))
    assert [r["image_id"] for r in got] == [r["image_id"] for r in want]
    assert sum(len(r["scores"]) for r in got) > 16
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["classes"], np.asarray(w["classes"]))
        np.testing.assert_allclose(g["scores"], np.asarray(w["scores"]), atol=1e-5)
        np.testing.assert_allclose(g["boxes"], np.asarray(w["boxes"]), atol=1e-5)

    capsys.readouterr()
    args = ["--tfrecords", workdir["tfrecord"], "--detections", out,
            "--config", workdir["config"]]
    assert teval(args + ["--device", "cpu", "--per_class"]) == 0
    port_says = capsys.readouterr().out
    assert jeval(args + ["--per_class"]) == 0
    assert port_says == capsys.readouterr().out


def test_supervised_restart_chain(workdir, priors_file, tmp_path, monkeypatch):
    """--restart_every_steps 1 to step 2: two child processes of
    ``python -m multibox_tpu_torch.cli.train``, the second resuming from
    the first's checkpoint; ``--device`` passes through."""
    from multibox_tpu_torch.cli.train import main

    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # one intra-op thread a child
    logdir = str(tmp_path / "supervised")
    try:
        assert main(train_args(workdir, priors_file, logdir) + [
            "--restart_every_steps", "1", "--max_number_of_steps", "2"]) == 0
        assert CheckpointManager(logdir).all_steps() == [2]
        assert [r["step"] for r in read_metrics(logdir)] == [1, 2]
    finally:
        for path in pathlib.Path(logdir).glob("*.pt"):
            path.unlink()


def test_supervisor_passes_device_and_gives_up_without_progress(tmp_path):
    from multibox_tpu_torch.cli.train import _supervise

    calls = []
    rc = _supervise(["--logdir", str(tmp_path), "--device", "cpu", "--max_number_of_steps",
                     "9", "--restart_every_steps=3"], str(tmp_path), 9, 3,
                    run_child=lambda cmd: calls.append(cmd) or 1)
    assert rc == 1 and len(calls) == 3
    cmd = calls[0]
    assert cmd[1:3] == ["-m", "multibox_tpu_torch.cli.train"]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert cmd[-2:] == ["--max_number_of_steps", "3"]
    assert "--restart_every_steps=3" not in cmd and cmd.count("--restart_every_steps") == 1

"""The port's export and serving path (``cli/export.py``, ``serving.py``) on
the CPU, against its own live detect and against the JAX package's exported
program.

- The exported program is bitwise the live ``apply_and_postprocess`` at its
  batch size (the same operators on the same tensors; the kernels enter as
  the ``multibox_torch::*`` custom operators, whose CPU implementation is
  the plain version).
- Against the JAX package's ``jax.export`` program of the same (converted)
  weights: indices, classes and counts exact, boxes and scores atol 1e-5
  (tests/test_torch_detect.py's tolerance: float32 sums in another order).
- Dispatch (split, pad, multi-size), the empty batch, warmup's copies to the
  host, stale siblings, the primary program on a collision, the device
  check and ``config.json`` on small stand-ins or MobileNetV2 0.5.

Tiny models at 75 px with 16 priors: MobileNetV2 0.5, whose programs are a
few MB (an Inception program is some 90 MB, and the suite shares a small
disk); every artifact is written under ``tmp_path`` and removed.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from multibox_tpu import inference as jinf
from multibox_tpu.config import Config as JConfig
from multibox_tpu_torch import serving
from multibox_tpu_torch.cli import export as cli_export
from multibox_tpu_torch.config import Config, parse_config_file
from multibox_tpu_torch.data.example_proto import build_detection_example
from multibox_tpu_torch.data.tfrecord import TFRecordWriter
from multibox_tpu_torch.inference import apply_and_postprocess, build_model
from multibox_tpu_torch.models import convert
from multibox_tpu_torch.models.inception_v3 import fold_batch_norms
from multibox_tpu_torch.priors import save_priors
from multibox_tpu_torch.serving import ExportedDetector, load_exported
from multibox_tpu_torch.train.state import create_train_state
from multibox_tpu_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_quant import spread
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

SMALL = dict(input_size=75, num_priors=16, compute_dtype="float32", max_detections=5,
             detect_score_threshold=0.0, use_pallas=True, backbone="mobilenet_v2",
             mobilenet_width=0.5)


def make_priors(rng):
    return np.sort(rng.uniform(0.05, 0.95, (16, 2, 2)).astype(np.float32), axis=1).reshape(16, 4)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """MobileNetV2 0.5 with the MultiBox head (the JAX package's initial
    variables, head biases spread, converted), exported at batch sizes 1
    and 4."""
    root = tmp_path_factory.mktemp("torch_serving")
    rng = np.random.default_rng(0)
    jcfg = JConfig(**SMALL)
    jmodel = jinf.build_model(jcfg, 16)
    jvars = spread(dict(jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                             jnp.zeros((1, 75, 75, 3)))), rng)
    cfg = Config(**SMALL)
    tvars = convert.flax_to_torch(jvars, device="cpu")
    model = build_model(cfg, 16, device="cpu")
    priors = make_priors(rng)
    out = str(root / "export")
    paths = cli_export.export_detector(cfg, model, tvars, priors, out, [4, 1], "cpu")
    yield {"cfg": cfg, "jcfg": jcfg, "jvars": jvars, "tvars": tvars, "model": model,
           "priors": priors, "dir": out, "paths": paths}
    shutil.rmtree(root, ignore_errors=True)


def live(exported, x):
    with torch.no_grad():
        return apply_and_postprocess(exported["model"], exported["tvars"], torch.from_numpy(x),
                                     torch.from_numpy(exported["priors"]), exported["cfg"])


def test_export_writes_the_artifact(exported):
    names = sorted(os.listdir(exported["dir"]))
    assert names == ["config.json", "detect.graph.txt", "detect.pt2", "detect_b4.pt2",
                     "params.npz", "priors.pkl"]
    assert exported["paths"] == {1: os.path.join(exported["dir"], "detect.pt2"),
                                  4: os.path.join(exported["dir"], "detect_b4.pt2")}
    graph = open(os.path.join(exported["dir"], "detect.graph.txt")).read()
    for op in ("multibox_torch.nms_select", "multibox_torch.fused_matmul_bias_relu",
               "multibox_torch.decode_boxes"):
        assert op in graph
    with np.load(os.path.join(exported["dir"], "params.npz")) as z:
        assert sorted(z.files) == sorted(f"{c}/{k}" for c, d in exported["tvars"].items()
                                         for k in d)
        key = "params/MobileNetV2.Stem.Conv.weight"
        np.testing.assert_array_equal(z[key], exported["tvars"]["params"][key[7:]].numpy())


@pytest.mark.parametrize("size", [1, 4])
def test_exported_program_is_bitwise_the_live_detect(exported, size):
    det = load_exported(exported["dir"], device="cpu")
    assert sorted(det.calls) == [1, 4] and det.batch_size == 4 and det.input_size == 75
    x = np.random.default_rng(size).uniform(-1, 1, (size, 75, 75, 3)).astype(np.float32)
    got = det(x)
    want = live(exported, x)
    for key in ("boxes", "scores", "classes", "num"):
        assert got[key].dtype == want[key].numpy().dtype
        np.testing.assert_array_equal(got[key], want[key].numpy())
    assert int(want["num"].min()) > 0


def test_exported_program_matches_the_jax_exported_program(exported):
    from jax import export as jax_export

    jcfg, jvars = exported["jcfg"], exported["jvars"]
    jmodel = jinf.build_model(jcfg, 16)
    apply_vars = {"params": jvars["params"], "batch_stats": jvars["batch_stats"]}
    priors = jnp.asarray(exported["priors"])
    jprogram = jax_export.export(jax.jit(lambda im: jinf.apply_and_postprocess(
        jmodel, apply_vars, im, priors, jcfg)))(jax.ShapeDtypeStruct((4, 75, 75, 3), jnp.float32))
    call = jax_export.deserialize(jprogram.serialize()).call
    x = np.random.default_rng(7).uniform(-1, 1, (4, 75, 75, 3)).astype(np.float32)
    want = call(jnp.asarray(x))
    got = load_exported(exported["dir"], device="cpu")(x)
    np.testing.assert_array_equal(got["classes"], np.asarray(want["classes"]))
    np.testing.assert_array_equal(got["num"], np.asarray(want["num"]))
    np.testing.assert_allclose(got["scores"], np.asarray(want["scores"]), atol=1e-5)
    np.testing.assert_allclose(got["boxes"], np.asarray(want["boxes"]), atol=1e-5)


def test_multi_size_dispatch_matches_the_programs_called_on_the_chunks(exported):
    det = load_exported(exported["dir"], device="cpu")
    x = np.random.default_rng(3).uniform(-1, 1, (6, 75, 75, 3)).astype(np.float32)
    got = det(x)  # 4 + 1 + 1: no padding
    with torch.no_grad():
        parts = [det.calls[4](torch.from_numpy(x[:4])), det.calls[1](torch.from_numpy(x[4:5])),
                 det.calls[1](torch.from_numpy(x[5:]))]
    for key in got:
        np.testing.assert_array_equal(got[key], np.concatenate([p[key].numpy() for p in parts]))


class _Recorder:
    """A stand-in program: records the batch sizes it was called with and
    returns each row's first pixel as its ``scores``."""

    def __init__(self, size, log):
        self.size, self.log = size, log

    def __call__(self, x):
        assert x.shape[0] == self.size
        self.log.append(self.size)
        return {"scores": x[:, 0, 0, 0].clone(), "num": torch.ones(self.size, dtype=torch.int32)}


def stand_in(sizes, log, specs=None):
    return ExportedDetector(detect=None, config=None, priors=np.zeros((4, 4), np.float32),
                            batch_size=max(sizes), input_size=2,
                            calls={s: _Recorder(s, log) for s in sizes},
                            output_specs=specs or {})


@pytest.mark.parametrize("sizes,batch,calls", [
    ((1, 4), 6, [4, 1, 1]), ((4,), 5, [4, 4]), ((2, 8), 11, [8, 2, 2]), ((1, 4), 4, [4]),
    ((4,), 1, [4])], ids=["largest_then_ones", "pad_tail", "pad_smallest", "exact", "pad_one"])
def test_dispatch_takes_the_largest_fit_and_pads_the_tail(sizes, batch, calls):
    log = []
    x = np.zeros((batch, 2, 2, 3), np.float32)
    x[:, 0, 0, 0] = np.arange(batch)
    out = stand_in(sizes, log)(x)
    assert log == calls
    np.testing.assert_array_equal(out["scores"], np.arange(batch, dtype=np.float32))
    assert out["num"].shape == (batch,)


def test_empty_batch_is_answered_from_the_output_specs_without_running(exported):
    det = load_exported(exported["dir"], device="cpu")

    def refuse(x):
        raise AssertionError("a program ran for an empty batch")

    det.calls = {s: refuse for s in det.calls}
    out = det(np.zeros((0, 75, 75, 3), np.float32))
    assert {k: (v.shape, v.dtype) for k, v in out.items()} == {
        "boxes": ((0, 5, 4), np.float32), "scores": ((0, 5), np.float32),
        "classes": ((0, 5), np.int32), "num": ((0,), np.int32)}


def test_warmup_copies_every_output_of_every_program_to_the_host():
    """warmup() must run every program and copy each output to the host
    before it returns: the daemon's ``ready`` must not fire while a program
    is still in flight (the JAX package's
    tests/test_serving.py::test_warmup_materializes_every_output_leaf)."""

    class _LazyLeaf:
        def __init__(self):
            self.materialized = False

        def __array__(self, dtype=None, copy=None):
            self.materialized = True
            return np.zeros((1,), np.float32)

    leaves = {}

    def make_call(size):
        def call(x):
            assert x.shape == (size, 16, 16, 3)
            leaves[size] = [_LazyLeaf(), _LazyLeaf()]
            return {"boxes": leaves[size][0], "scores": leaves[size][1]}

        return call

    det = ExportedDetector(detect=None, config=None, priors=np.zeros((4, 4), np.float32),
                           batch_size=8, input_size=16, calls={8: make_call(8), 2: make_call(2)})
    det.warmup()
    assert sorted(leaves) == [2, 8]
    for size, pair in leaves.items():
        for leaf in pair:
            assert leaf.materialized, f"an output of the batch-{size} program stayed on device"


MOBILE = dict(SMALL, batch_size=4, quant_calib_batches=2)


@pytest.fixture(scope="module")
def mobile(tmp_path_factory):
    """A MobileNetV2 0.5 checkpoint (small), its config file, priors and
    calibration records, for the export CLI."""
    root = tmp_path_factory.mktemp("torch_export_cli")
    rng = np.random.default_rng(1)
    cfg_path = str(root / "config.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(MOBILE, f)
    cfg = parse_config_file(cfg_path)
    priors = make_priors(rng)
    priors_path = str(root / "priors.pkl")
    save_priors(priors, priors_path)
    model = build_model(cfg, 16, device="cpu")
    state = create_train_state(cfg, model, 0, 16, device="cpu")
    logdir = str(root / "logdir")
    CheckpointManager(logdir).save(1, state, force=True)
    calib = str(root / "calib.tfrecord")
    with TFRecordWriter(calib) as w:
        for i in range(8):
            w.write(build_detection_example(
                b"", f"c{i}", np.array([[0.1, 0.1, 0.6, 0.6]], np.float32), labels=[1],
                raw_canvas=rng.integers(0, 256, (75, 75, 3), dtype=np.uint8)))
    yield {"root": root, "cfg": cfg, "priors": priors, "state": state, "model": model,
           "args": ["--checkpoint_path", logdir, "--priors", priors_path,
                    "--config", cfg_path, "--device", "cpu"], "calib": calib}
    shutil.rmtree(root, ignore_errors=True)


def export_cli(mobile, name, extra):
    out = str(mobile["root"] / name)
    assert cli_export.main(mobile["args"] + ["--output_dir", out] + extra) == 0
    return out


def test_reexport_removes_stale_batch_siblings(mobile):
    out = export_cli(mobile, "re_export", ["--batch_sizes", "1", "4"])
    assert os.path.exists(os.path.join(out, "detect_b4.pt2"))
    export_cli(mobile, "re_export", ["--batch_sizes", "2"])
    assert not os.path.exists(os.path.join(out, "detect_b4.pt2"))
    assert sorted(load_exported(out, device="cpu").calls) == [2]


def test_primary_program_wins_a_batch_size_collision(mobile):
    """A stale ``detect_b2.pt2`` of other weights beside a fresh primary
    ``detect.pt2`` of size 2: the primary serves."""
    fresh = export_cli(mobile, "collision", ["--batch_size", "2"])
    other = str(mobile["root"] / "collision_other")
    cfg, model = mobile["cfg"], mobile["model"]
    variables = model.init_variables(torch.Generator().manual_seed(5))
    cli_export.export_detector(cfg, model, variables, mobile["priors"], other, [2], "cpu")
    shutil.copy(os.path.join(other, "detect.pt2"), os.path.join(fresh, "detect_b2.pt2"))
    det = load_exported(fresh, device="cpu")
    x = np.random.default_rng(2).uniform(-1, 1, (2, 75, 75, 3)).astype(np.float32)
    st = mobile["state"]
    with torch.no_grad():
        want = apply_and_postprocess(model, {"params": st.ema_params,
                                             "batch_stats": st.batch_stats},
                                     torch.from_numpy(x), torch.from_numpy(mobile["priors"]), cfg)
    got = det(x)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key].numpy())


@pytest.mark.parametrize("kind", ["fold_bn", "int8"])
def test_export_cli_folded_and_int8_programs_are_bitwise_their_live_models(mobile, kind):
    cfg, st = mobile["cfg"], mobile["state"]
    ema = {"params": st.ema_params, "batch_stats": st.batch_stats}
    if kind == "fold_bn":
        out = export_cli(mobile, kind, ["--fold_bn", "--batch_size", "4"])
        model = build_model(cfg, 16, folded=True, device="cpu")
        variables, lcfg = fold_batch_norms(ema), cfg
    else:
        out = export_cli(mobile, kind, ["--quantize", "int8", "--calib_tfrecords",
                                        mobile["calib"], "--batch_size", "4"])
        lcfg = dataclasses.replace(cfg, quantize="int8")
        model = build_model(lcfg, 16, folded=True, quantize="int8", device="cpu")
        with np.load(os.path.join(out, "params.npz")) as z:
            variables = {}
            for key in z.files:
                coll, name = key.split("/", 1)
                variables.setdefault(coll, {})[name] = torch.from_numpy(z[key])
        assert len(variables["quant"]) == 52 and all(
            float(v) > 0 for v in variables["quant"].values())
    det = load_exported(out, device="cpu")
    assert det.config.quantize == lcfg.quantize
    x = np.random.default_rng(4).uniform(-1, 1, (4, 75, 75, 3)).astype(np.float32)
    with torch.no_grad():
        want = apply_and_postprocess(model, variables, torch.from_numpy(x),
                                     torch.from_numpy(mobile["priors"]), lcfg)
    got = det(x)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key].numpy())


@pytest.mark.parametrize("extra,message", [
    (["--quantize", "int8", "--fold_bn"], "already folds BN"),
    (["--quantize", "int8"], "--calib_tfrecords"),
    (["--saved_model"], "Not portable"),
], ids=["quantize_and_fold", "quantize_without_calibration", "saved_model"])
def test_export_cli_refuses(mobile, extra, message):
    with pytest.raises(SystemExit, match=message):
        cli_export.main(mobile["args"] + ["--output_dir", str(mobile["root"] / "refused")]
                        + extra)
    assert not os.path.exists(mobile["root"] / "refused")


def test_config_json_is_versioned_and_the_loader_checks_the_device(mobile, tmp_path):
    out = export_cli(mobile, "config_json", ["--batch_size", "1"])
    path = os.path.join(out, "config.json")
    raw = json.load(open(path))
    assert raw["format"] == serving.EXPORT_FORMAT and raw["device"] == "cpu"
    cfg, device = serving.read_config(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(mobile["cfg"]) and device == "cpu"
    # a field the schema no longer has loads with a warning; a missing one
    # takes its default
    raw["config"]["a_removed_field"] = 1
    del raw["config"]["soft_nms_sigma"]
    json.dump(raw, open(path, "w"))
    assert serving.read_config(path)[0].soft_nms_sigma == Config().soft_nms_sigma
    raw["device"] = "cuda"
    json.dump(raw, open(path, "w"))
    with pytest.raises(ValueError, match="exported on cuda"):
        load_exported(out, device="cpu")
    raw["format"] = serving.EXPORT_FORMAT + 1
    json.dump(raw, open(path, "w"))
    with pytest.raises(ValueError, match="newer"):
        serving.read_config(path)

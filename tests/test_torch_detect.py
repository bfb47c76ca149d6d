"""The port's detect path against the JAX package's on the CPU: the golden
fixture, the postprocess variants, EMA selection, flip-TTA and the host
loop. 75×75 input, 16 priors, float32.
"""

import dataclasses
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multibox_tpu import inference as jinf
from multibox_tpu.config import Config as JConfig
from multibox_tpu.data.augment import preprocess_eval as jpreprocess_eval
from multibox_tpu_torch import inference as tinf
from multibox_tpu_torch.config import Config
from multibox_tpu_torch.models import convert

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "detect_v1.npz")
P, SIZE = 16, 75
SMALL = dict(input_size=SIZE, num_priors=P, compute_dtype="float32",
             max_detections=8, detect_score_threshold=0.0, nms_iou_threshold=0.5)


def both_cfgs(**kw):
    return JConfig(**{**SMALL, **kw}), Config(**{**SMALL, **kw})


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(dict(tree)))


def as_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def golden_priors(rng):
    return np.sort(
        rng.uniform(0.05, 0.95, (P, 2, 2)).astype(np.float32), axis=1
    ).reshape(P, 4)


def spread(tree, rng):
    """Move the confidence biases apart so that scores are not all within
    rounding of 0.5 (at a random init they are, and a 1e-7 difference in a
    logit would then reorder NMS for no fault of the port's)."""
    tree = jax.tree_util.tree_map(np.array, tree)
    bias = tree["params"]["MultiBoxHead"]["Confidences"]["bias"]
    tree["params"]["MultiBoxHead"]["Confidences"]["bias"] = rng.normal(
        0, 1.0, bias.shape).astype(np.float32)
    loc = tree["params"]["MultiBoxHead"]["Locations"]["bias"]
    tree["params"]["MultiBoxHead"]["Locations"]["bias"] = rng.normal(
        0, 0.05, loc.shape).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def world():
    """Priors, inputs and the variables of ``model.init(PRNGKey(0))`` exactly
    as tests/test_golden_detect.py makes them, in both packages' forms."""
    jcfg, _ = both_cfgs()
    rng = np.random.default_rng(42)
    priors = golden_priors(rng)
    x = rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    jmodel = jinf.build_model(jcfg, P)
    jvars = to_numpy_tree(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    return {"priors": priors, "x": x, "jvars": jvars,
            "tvars": convert.flax_to_torch(jvars, device="cpu"),
            "jvars_spread": (sp := spread(jvars, np.random.default_rng(1))),
            "tvars_spread": convert.flax_to_torch(sp, device="cpu")}


def assert_detections_match(got, want, atol=1e-5):
    np.testing.assert_array_equal(got["num"].numpy(), np.asarray(want["num"]))
    np.testing.assert_array_equal(got["classes"].numpy(), np.asarray(want["classes"]))
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), atol=atol)
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), atol=atol)


# ------------------------------------------------------------------ golden

@pytest.mark.parametrize("use_pallas", [None, True, False])
def test_port_reproduces_the_golden_detections(world, use_pallas):
    """tests/golden/detect_v1.npz, from weights converted out of
    ``model.init(PRNGKey(0))``. On the CPU ``use_pallas`` changes which
    wrapper is called, not the arithmetic."""
    _, cfg = both_cfgs(use_pallas=use_pallas)
    detect = tinf.make_detect_fn(cfg, world["priors"], use_ema=False, device="cpu")
    out = detect(world["tvars"], world["x"])
    want = np.load(GOLDEN)
    np.testing.assert_array_equal(out["num"].numpy(), want["num"])
    np.testing.assert_allclose(out["scores"].numpy(), want["scores"], atol=1e-5)
    np.testing.assert_allclose(out["boxes"].numpy(), want["boxes"], atol=1e-5)
    assert out["boxes"].shape == (2, 8, 4) and out["num"].dtype == torch.int32


# ------------------------------------------------------------- postprocess

def fixed_logits(rng, B=3, C=3, ties=True):
    loc = rng.normal(0, 0.05, (B, P, 4)).astype(np.float32)
    conf = rng.normal(0, 1.5, (B, P, C)).astype(np.float32)
    if ties:  # exactly equal scores across priors and classes
        conf = np.round(conf * 2) / 2
    return loc, conf.astype(np.float32)


@pytest.mark.parametrize(
    "kw",
    [
        dict(num_classes=3),  # per-class sweep, all candidates
        dict(num_classes=3, detect_candidates=20),  # top-k cuts through ties
        dict(num_classes=3, per_class_detect=False),  # argmax class
        dict(num_classes=3, nms_mode="soft"),
        dict(num_classes=3, detect_score_threshold=0.6, max_detections=40),
        dict(num_classes=3, use_pallas=True),
    ],
    ids=["sweep", "sweep_pruned", "argmax", "soft", "thresholded", "kernel_wrappers"],
)
def test_multiclass_select_matches_jax(world, kw):
    rng = np.random.default_rng(5)
    loc, conf = fixed_logits(rng)
    jcfg, cfg = both_cfgs(**kw)
    if kw.get("use_pallas"):
        jcfg = dataclasses.replace(jcfg, use_pallas=False)  # same spec, jnp
    want = jinf.postprocess(jnp.asarray(loc), jnp.asarray(conf),
                            jnp.asarray(world["priors"]), jcfg)
    got = tinf.postprocess(torch.from_numpy(loc), torch.from_numpy(conf),
                           torch.from_numpy(world["priors"]), cfg)
    assert_detections_match(got, want, atol=1e-6)
    assert got["classes"].dtype == torch.int32


@pytest.mark.parametrize("nms_mode", ["hard", "soft"])
def test_class_agnostic_select_matches_jax(world, nms_mode):
    rng = np.random.default_rng(6)
    loc, conf = fixed_logits(rng, C=1, ties=False)
    jcfg, cfg = both_cfgs(nms_mode=nms_mode, detect_score_threshold=0.2)
    want = jinf.postprocess(jnp.asarray(loc), jnp.asarray(conf[..., 0]),
                            jnp.asarray(world["priors"]), jcfg)
    got = tinf.postprocess(torch.from_numpy(loc), torch.from_numpy(conf[..., 0]),
                           torch.from_numpy(world["priors"]), cfg)
    assert_detections_match(got, want, atol=1e-6)
    assert int(got["classes"].abs().max()) == 0


def test_ssd_decode_matches_jax(world):
    rng = np.random.default_rng(8)
    loc = rng.normal(0, 0.5, (2, P, 4)).astype(np.float32)
    jcfg, cfg = both_cfgs(box_encoding="ssd")
    want = jinf.decode_candidates(jnp.asarray(loc), jnp.asarray(world["priors"]), jcfg)
    got = tinf.decode_candidates(torch.from_numpy(loc), torch.from_numpy(world["priors"]), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_unknown_modes_fail_loudly(world):
    _, cfg = both_cfgs(nms_mode="sfot")
    with pytest.raises(ValueError, match="unknown nms_mode"):
        tinf.select_detections(torch.zeros(1, P, 4), torch.zeros(1, P), cfg)
    _, cfg = both_cfgs(quantize="int4")
    with pytest.raises(ValueError, match="unknown quantize mode"):
        tinf.make_detect_body(cfg, world["priors"], device="cpu")
    _, cfg = both_cfgs(quantize="int8")
    with pytest.raises(NotImplementedError, match="later slice"):
        tinf.make_detect_fn(cfg, world["priors"], device="cpu")


# ------------------------------------------------------------ detect steps

def test_detect_fn_matches_jax_on_spread_scores(world):
    jcfg, cfg = both_cfgs()
    want = jinf.make_detect_fn(jcfg, jnp.asarray(world["priors"]))(
        as_jax(world["jvars_spread"]), jnp.asarray(world["x"]))
    got = tinf.make_detect_fn(cfg, world["priors"], device="cpu")(
        world["tvars_spread"], world["x"])
    assert_detections_match(got, want)


def test_flip_tta_matches_jax(world):
    jcfg, cfg = both_cfgs(flip_tta=True, max_detections=12)
    want = jinf.make_detect_fn(jcfg, jnp.asarray(world["priors"]))(
        as_jax(world["jvars_spread"]), jnp.asarray(world["x"]))
    got = tinf.make_detect_fn(cfg, world["priors"], device="cpu")(
        world["tvars_spread"], world["x"])
    assert got["boxes"].shape == (2, 12, 4)
    assert_detections_match(got, want)


@pytest.mark.parametrize("use_ema", [None, True, False])
def test_use_ema_selects_the_shadow_params(world, use_ema):
    rng = np.random.default_rng(9)
    jvars = dict(world["jvars_spread"])
    jvars["ema"] = spread(jvars, rng)["params"]  # other head biases
    tvars = convert.flax_to_torch(jvars, device="cpu")
    jcfg, cfg = both_cfgs()
    want = jinf.make_detect_fn(jcfg, jnp.asarray(world["priors"]), use_ema=use_ema)(
        as_jax(jvars), jnp.asarray(world["x"]))
    got = tinf.make_detect_fn(cfg, world["priors"], use_ema=use_ema, device="cpu")(
        tvars, world["x"])
    assert_detections_match(got, want)
    plain = tinf.make_detect_fn(cfg, world["priors"], use_ema=False, device="cpu")(
        tvars, world["x"])
    same = torch.equal(plain["scores"], got["scores"])
    assert same == (use_ema is False)  # cfg.use_ema_for_detect defaults to True


# --------------------------------------------------------------- host loop

def test_pack_unpack_round_trip():
    rng = np.random.default_rng(10)
    det = {
        "boxes": torch.from_numpy(rng.uniform(0, 1, (3, 5, 4)).astype(np.float32)),
        "scores": torch.from_numpy(rng.uniform(0, 1, (3, 5)).astype(np.float32)),
        "classes": torch.from_numpy(rng.integers(-1, 90, (3, 5)).astype(np.int32)),
        "num": torch.tensor([5, 0, 3], dtype=torch.int32),
    }
    packed = tinf._pack_dets(det)
    assert packed.shape == (3, 5, 7) and packed.dtype == torch.float32
    want = jinf._pack_dets({k: jnp.asarray(v.numpy()) for k, v in det.items()})
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want))
    boxes, scores, classes, nums = tinf._unpack_dets(packed.numpy())
    np.testing.assert_array_equal(boxes, det["boxes"].numpy())
    np.testing.assert_array_equal(scores, det["scores"].numpy())
    np.testing.assert_array_equal(classes, det["classes"].numpy())
    np.testing.assert_array_equal(nums, det["num"].numpy())


def make_dataset(rng, batches=3, batch=2, valid_last=1, canvas=90):
    data = []
    for i in range(batches):
        valid = valid_last if i == batches - 1 else batch
        data.append({
            "images": rng.integers(0, 256, (batch, canvas, canvas, 3), dtype=np.uint8),
            "image_ids": [f"im{i}_{j}" if j < valid else "" for j in range(batch)],
            "batch_valid": np.int32(valid),
        })
    return data


@pytest.mark.parametrize("score_threshold", [None, 0.45])
def test_run_detect_loop_matches_jax_per_batch(world, score_threshold):
    """An in-memory dataset with a partial last batch; the expected lists
    come from the JAX detect step applied batch by batch."""
    data = make_dataset(np.random.default_rng(12))
    jcfg, cfg = both_cfgs(detect_score_threshold=0.3)
    jdetect = jinf.make_detect_fn(jcfg, jnp.asarray(world["priors"]))
    jvars = as_jax(world["jvars_spread"])
    thr = jcfg.detect_score_threshold if score_threshold is None else score_threshold
    want = []
    for batch in data:
        det = jdetect(jvars, jpreprocess_eval(jnp.asarray(batch["images"]), SIZE))
        det = {k: np.asarray(v) for k, v in det.items()}
        for i in range(int(batch["batch_valid"])):
            keep = det["scores"][i, : det["num"][i]] >= thr
            want.append({
                "image_id": batch["image_ids"][i],
                "boxes": det["boxes"][i, : det["num"][i]][keep],
                "scores": det["scores"][i, : det["num"][i]][keep],
                "classes": det["classes"][i, : det["num"][i]][keep],
            })
    got = tinf.run_detect_loop(cfg, world["tvars_spread"], iter(data), world["priors"],
                               score_threshold=score_threshold, device="cpu")
    assert [r["image_id"] for r in got] == [r["image_id"] for r in want]
    assert len(got) == 5 and any(len(r["scores"]) for r in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["classes"], w["classes"])
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-5)
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-5)


def test_run_detect_loop_reuses_fns_and_reraises_dataset_errors(world):
    _, cfg = both_cfgs()
    fns = tinf.make_detect_loop_fns(cfg, world["priors"], device="cpu")
    data = make_dataset(np.random.default_rng(13), batches=2)
    a = tinf.run_detect_loop(cfg, world["tvars_spread"], data, world["priors"], fns=fns)
    b = tinf.run_detect_loop(cfg, world["tvars_spread"], data, world["priors"], fns=fns)
    assert len(a) == len(b) == 3
    np.testing.assert_array_equal(a[0]["boxes"], b[0]["boxes"])
    assert tinf.run_detect_loop(cfg, world["tvars_spread"], [], world["priors"], fns=fns) == []

    def broken():
        yield data[0]
        raise OSError("corrupt record")

    with pytest.raises(OSError, match="corrupt record"):
        tinf.run_detect_loop(cfg, world["tvars_spread"], broken(), world["priors"], fns=fns)
    with pytest.raises(ValueError, match="fns were built for cpu"):
        tinf.run_detect_loop(cfg, world["tvars_spread"], data, world["priors"],
                             fns=fns, device="cuda")

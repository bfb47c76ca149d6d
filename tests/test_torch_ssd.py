"""The SSD multi-scale head (``models.heads.SSDHead``) and the SSD detector
against the JAX package on the CPU: the head's flatten order (level → row
→ col → shape, C = 1 and 3), Inception-v3 + SSD end to end at 75 px,
MobileNetV2 + SSD with Inception's default endpoints mapped to its pyramid,
the SSD detect postprocess (center/log-scale decode, NMS, the per-class
sweep), the conversion of an SSD tree, and one multi-class train step with
dense matching and SSD encoding.

Tolerances as in ``tests/test_torch_mobilenet.py``: float32 forwards atol
1e-4 and the largest gap at most 1e-3 of the largest entry; the head alone
atol 1e-5; the postprocess on the same inputs: indices, classes and counts
exact, boxes and scores atol 1e-6; the train step as in
``tests/test_torch_train.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.func import functional_call

from multibox_tpu import inference as jinference
from multibox_tpu.config import Config as JConfig
from multibox_tpu.models.detector import MultiBoxDetector as JDetector
from multibox_tpu.models.heads import SSDHead as JSSDHead
from multibox_tpu.priors import generate_priors_multiscale as jpriors_multiscale
from multibox_tpu_torch import inference
from multibox_tpu_torch.config import Config
from multibox_tpu_torch.models import convert, detector
from multibox_tpu_torch.models.heads import SSDHead
from multibox_tpu_torch.priors import generate_priors_multiscale
from tests.test_torch_mobilenet import (
    assert_close,
    flat,
    jax_apply,
    jax_init,
    perturb,
    tiny_batch,
    train_step_against_jax,
)
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

INCEPTION_SSD = ("Mixed_5d", "Mixed_6e", "Mixed_7c")


def count_leaves(tree):
    return sum(count_leaves(v) if isinstance(v, dict) else 1 for v in tree.values())


# -------------------------------------------------------------------- head

@pytest.mark.parametrize("num_classes", [1, 3])
def test_ssd_head_matches_jax(num_classes):
    """Two grids (3×4 and 2×2) with distinct rows, columns and channels: a
    head that flattened NCHW, or split the K·4 channels as (coord, shape),
    would not agree."""
    rng = np.random.default_rng(num_classes)
    feats = {"A": rng.normal(0, 1, (2, 3, 4, 5)).astype(np.float32),
             "B": rng.normal(0, 1, (2, 2, 2, 7)).astype(np.float32)}
    jhead = JSSDHead(endpoints_spec=("A", "B"), priors_per_cell=2, num_classes=num_classes)
    jin = {k: jnp.asarray(v) for k, v in feats.items()}
    jvars = perturb(jax_init(jhead, jin), rng)
    want_loc, want_conf = jhead.apply(jvars, jin)
    thead = SSDHead({"A": 5, "B": 7}, endpoints_spec=("A", "B"), priors_per_cell=2,
                    num_classes=num_classes)
    tvars = convert.flax_to_torch(jvars, device="cpu")["params"]
    assert set(tvars) == {k for k, _ in thead.named_parameters()}
    with torch.no_grad():
        loc, conf = functional_call(
            thead, tvars, ({k: torch.from_numpy(v) for k, v in feats.items()},))
    P = (3 * 4 + 2 * 2) * 2
    assert loc.shape == (2, P, 4)
    assert conf.shape == ((2, P) if num_classes == 1 else (2, P, num_classes))
    np.testing.assert_allclose(loc.numpy(), np.asarray(want_loc), atol=1e-5)
    np.testing.assert_allclose(conf.numpy(), np.asarray(want_conf), atol=1e-5)


# ---------------------------------------------------------------- detector

SIZE, K = 75, 4
P_INCEPTION = (7 * 7 + 3 * 3 + 1 * 1) * K  # Mixed_5d 7², Mixed_6e 3², Mixed_7c 1²


@pytest.fixture(scope="module")
def inception_ssd():
    """Inception-v3 + SSD head at 75 px, 4 priors a cell, perturbed
    variables, float32."""
    rng = np.random.default_rng(75)
    x = rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    jm = JDetector(num_priors=P_INCEPTION, head_type="ssd", ssd_priors_per_cell=K,
                   compute_dtype=jnp.float32)
    jvars = perturb(jax_init(jm, x), rng)
    want = jax_apply(jm, jvars, x)
    return {"x": x, "jvars": jvars, "want": [np.asarray(a) for a in want],
            "tvars": convert.flax_to_torch(jvars, device="cpu")}


def test_inception_ssd_detector_matches_jax_end_to_end(inception_ssd):
    model = detector.MultiBoxDetector(num_priors=P_INCEPTION, input_size=SIZE, head_type="ssd",
                                      ssd_priors_per_cell=K, compute_dtype=torch.float32,
                                      device="cpu")
    assert model.head_scope == "SSDHead"
    with torch.no_grad():
        loc, conf = detector.apply(model, inception_ssd["tvars"], torch.from_numpy(inception_ssd["x"]))
    assert loc.shape == (2, P_INCEPTION, 4) and conf.shape == (2, P_INCEPTION)
    assert_close(loc.numpy(), inception_ssd["want"][0])
    assert_close(conf.numpy(), inception_ssd["want"][1])


def test_ssd_tree_converts_leaf_for_leaf(inception_ssd):
    tvars = inception_ssd["tvars"]
    model = detector.MultiBoxDetector(num_priors=P_INCEPTION, input_size=SIZE, head_type="ssd",
                                      ssd_priors_per_cell=K, device="cpu")
    assert len(tvars["params"]) == count_leaves(inception_ssd["jvars"]["params"])
    assert len(tvars["batch_stats"]) == count_leaves(inception_ssd["jvars"]["batch_stats"])
    want = {k: tuple(v.shape) for k, v in list(model.named_parameters())
            + list(model.named_buffers())}
    assert {k: tuple(v.shape) for k, v in flat(tvars).items()} == want
    assert tvars["params"]["SSDHead.Conf_Mixed_6e.weight"].shape == (K, 768, 3, 3)


def test_wrong_num_priors_raises_as_in_jax(inception_ssd):
    x = inception_ssd["x"]
    msg = f"head produced {P_INCEPTION} priors but num_priors={P_INCEPTION - 1}"
    jm = JDetector(num_priors=P_INCEPTION - 1, head_type="ssd", ssd_priors_per_cell=K,
                   compute_dtype=jnp.float32)
    with pytest.raises(ValueError, match=msg):
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x))
    model = detector.MultiBoxDetector(num_priors=P_INCEPTION - 1, input_size=SIZE,
                                      head_type="ssd", ssd_priors_per_cell=K,
                                      compute_dtype=torch.float32, device="cpu")
    with torch.no_grad(), pytest.raises(ValueError, match=msg):
        detector.apply(model, inception_ssd["tvars"], torch.from_numpy(x))


def test_mobilenet_ssd_maps_the_inception_endpoints():
    """MobileNetV2 (width 0.5) + SSD at 96 px: Inception's default
    ``ssd_endpoints`` become Stage_2 / Stage_4 / Stage_6 (12², 6², 3²), as
    in the JAX package; other missing endpoints raise."""
    rng = np.random.default_rng(96)
    P = (12 * 12 + 6 * 6 + 3 * 3) * 6
    x = rng.uniform(-1, 1, (2, 96, 96, 3)).astype(np.float32)
    kw = dict(num_priors=P, backbone="mobilenet_v2", mobilenet_width=0.5, head_type="ssd",
              num_classes=3)
    jm = JDetector(compute_dtype=jnp.float32, **kw)
    jvars = perturb(jax_init(jm, x), rng)
    assert set(jvars["params"]["SSDHead"]) == {
        f"{h}_Stage_{i}" for h in ("Loc", "Conf") for i in (2, 4, 6)}
    want_loc, want_conf = jax_apply(jm, jvars, x)
    model = detector.MultiBoxDetector(input_size=96, compute_dtype=torch.float32,
                                      device="cpu", **kw)
    with torch.no_grad():
        loc, conf = detector.apply(model, convert.flax_to_torch(jvars, device="cpu"),
                                   torch.from_numpy(x))
    assert conf.shape == (2, P, 3)
    assert_close(loc.numpy(), want_loc)
    assert_close(conf.numpy(), want_conf)
    with pytest.raises(ValueError, match=r"ssd_endpoints \['Mixed_6e'\] not produced"):
        detector.MultiBoxDetector(input_size=96, ssd_endpoints=("Stage_2", "Mixed_6e"),
                                  device="cpu", **kw)


# ---------------------------------------------------------------- detect

@pytest.mark.parametrize("num_classes", [1, 3])
def test_ssd_postprocess_matches_jax(num_classes):
    """Center/log-scale decode over grid priors, then NMS (and for C = 3 the
    per-class sweep to ``detect_candidates`` with class offsets), on the
    same head outputs in both packages."""
    rng = np.random.default_rng(20 + num_classes)
    priors = generate_priors_multiscale([7, 3, 1], aspect_ratios=(1.0, 2.0, 0.5))
    np.testing.assert_allclose(
        priors, jpriors_multiscale([7, 3, 1], aspect_ratios=(1.0, 2.0, 0.5)), atol=1e-7)
    P = priors.shape[0]
    assert P == P_INCEPTION
    loc = rng.normal(0, 0.5, (2, P, 4)).astype(np.float32)
    shape = (2, P) if num_classes == 1 else (2, P, num_classes)
    conf = rng.normal(0, 2, shape).astype(np.float32)
    kw = dict(input_size=SIZE, num_priors=P, head_type="ssd", box_encoding="ssd",
              num_classes=num_classes, max_detections=20, detect_candidates=64,
              detect_score_threshold=0.05)
    want = jinference.postprocess(jnp.asarray(loc), jnp.asarray(conf), jnp.asarray(priors),
                                  JConfig(**kw))
    got = inference.postprocess(torch.from_numpy(loc), torch.from_numpy(conf),
                                torch.from_numpy(priors), Config(**kw))
    for key in ("num", "classes"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    for key in ("boxes", "scores"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-6,
                                   err_msg=key)
    assert int(got["num"].min()) > 0


# ------------------------------------------------------------ train step

def test_ssd_multiclass_train_step_matches_jax():
    """One update of an SSD detector (MobileNetV2 width 0.5 at 64 px, its
    Stage_2/4/6 pyramid 8², 4², 2², 4 priors a cell) with 3 classes, SSD
    dense matching at 0.5 and center/log-scale encoding, as
    ssd_multiscale.yaml trains."""
    rng = np.random.default_rng(1)
    priors = generate_priors_multiscale([8, 4, 2], aspect_ratios=(1.0, 2.0, 0.5))
    P = priors.shape[0]
    model_kw = dict(backbone="mobilenet_v2", mobilenet_width=0.5, head_type="ssd",
                    ssd_endpoints=("Stage_2", "Stage_4", "Stage_6"), ssd_priors_per_cell=K,
                    num_classes=3)
    jm = JDetector(num_priors=P, compute_dtype=jnp.float32, **model_kw)
    init = perturb(jax_init(jm, np.zeros((1, 64, 64, 3), np.float32)), rng)
    cfg_kw = dict(input_size=64, num_priors=P, batch_size=2, max_num_bboxes=3,
                  compute_dtype="float32", initial_learning_rate=0.003,
                  hard_negative_ratio=3.0, num_train_examples=2, bn_momentum=0.997,
                  multi_match_iou=0.5, box_encoding="ssd", **model_kw)
    m = train_step_against_jax(cfg_kw, model_kw, init, priors,
                               tiny_batch(rng, 64, labels=3))
    # dense matching: more positives than gt boxes
    assert m["num_pos"] > 5 and m["num_bad_labels"] == 0

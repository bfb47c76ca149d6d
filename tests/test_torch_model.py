"""multibox_tpu_torch.models and data.augment against the JAX package on
the CPU: weight conversion, per-endpoint backbone parity, head parity, BN
folding and eval preprocessing. Small sizes: 75×75 input, 16 priors,
batch 2, float32.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.func import functional_call

from multibox_tpu.data import augment as jaugment
from multibox_tpu.models.detector import MultiBoxDetector as JDetector
from multibox_tpu.models.heads import MultiBoxHead as JHead
from multibox_tpu.models.inception_v3 import (
    ENDPOINTS as JENDPOINTS,
    InceptionV3 as JInceptionV3,
    fold_batch_norms as jfold,
)
from multibox_tpu_torch.data import augment as taugment
from multibox_tpu_torch.models import convert, detector, inception_v3
from multibox_tpu_torch.models.heads import MultiBoxHead

P, SIZE = 16, 75


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(dict(tree)))


def perturb(tree, rng, path=()):
    """Non-trivial BatchNorm statistics and biases (flax initialises them
    to 0 / 1, which would hide a swapped mean and var or a dropped bias)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = perturb(value, rng, path + (key,))
        elif key == "var":
            out[key] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif key in ("mean", "bias"):
            out[key] = rng.normal(0, 0.1, value.shape).astype(np.float32)
        else:
            out[key] = np.asarray(value)
    return out


@pytest.fixture(scope="module")
def nets():
    """The flax detector at 75 px with perturbed variables, the same
    variables converted, and the port's module."""
    rng = np.random.default_rng(7)
    jmodel = JDetector(num_priors=P, compute_dtype=jnp.float32)
    x = rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    variables = perturb(to_numpy_tree(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))), rng)
    tmodel = detector.MultiBoxDetector(
        num_priors=P, input_size=SIZE, compute_dtype=torch.float32, device="cpu")
    tvars = convert.flax_to_torch(variables, device="cpu")
    return {"jmodel": jmodel, "jvars": variables, "tmodel": tmodel,
            "tvars": tvars, "x": x}


def sub_vars(tvars, prefix):
    out = {}
    for coll in ("params", "batch_stats"):
        for name, value in tvars.get(coll, {}).items():
            if name.startswith(prefix + "."):
                out[name[len(prefix) + 1:]] = value
    return out


def count_leaves(tree):
    return sum(count_leaves(v) if isinstance(v, dict) else 1 for v in tree.values())


# ----------------------------------------------------------------- convert

def test_convert_consumes_every_leaf_and_leaves_none_over(nets):
    tvars, tmodel = nets["tvars"], nets["tmodel"]
    assert set(tvars) == {"params", "batch_stats"}
    assert len(tvars["params"]) == count_leaves(nets["jvars"]["params"])
    assert len(tvars["batch_stats"]) == count_leaves(nets["jvars"]["batch_stats"])
    want_params = {k: tuple(v.shape) for k, v in tmodel.named_parameters()}
    want_stats = {k: tuple(v.shape) for k, v in tmodel.named_buffers()}
    assert {k: tuple(v.shape) for k, v in tvars["params"].items()} == want_params
    assert {k: tuple(v.shape) for k, v in tvars["batch_stats"].items()} == want_stats
    assert all(v.dtype == torch.float32 for v in tvars["params"].values())


def test_convert_keeps_slash_names_and_transposes_hwio(nets):
    name = "InceptionV3.Mixed_5b.Branch_1/Conv2d_0b_5x5.Conv.weight"
    src = nets["jvars"]["params"]["InceptionV3"]["Mixed_5b"]["Branch_1/Conv2d_0b_5x5"]["Conv"]["kernel"]
    got = nets["tvars"]["params"][name].numpy()
    assert src.shape == (5, 5, 48, 64) and got.shape == (64, 48, 5, 5)
    np.testing.assert_array_equal(got, np.transpose(src, (3, 2, 0, 1)))
    dense = nets["jvars"]["params"]["MultiBoxHead"]["Locations"]["kernel"]
    np.testing.assert_array_equal(
        nets["tvars"]["params"]["MultiBoxHead.Locations.kernel"].numpy(), dense)


def test_convert_honours_ema_and_refuses_what_it_does_not_know(nets):
    jvars = dict(nets["jvars"])
    jvars["ema"] = jax.tree_util.tree_map(lambda a: a * 0.5, jvars["params"])
    tvars = convert.flax_to_torch(jvars, device="cpu")
    assert set(tvars["ema"]) == set(tvars["params"])
    key = "MultiBoxHead.Confidences.kernel"
    np.testing.assert_array_equal(
        tvars["ema"][key].numpy(), tvars["params"][key].numpy() * 0.5)
    with pytest.raises(ValueError, match="unknown variable collections"):
        convert.flax_to_torch({"params": {}, "opt_state": {}}, device="cpu")
    # BatchNorm γ (MobileNetV2's) converts by name; a leaf of no known
    # name or rank is refused
    got = convert.flax_to_torch(
        {"params": {"X": {"BatchNorm": {"scale": np.ones(3, np.float32)}}}}, device="cpu")
    assert set(got["params"]) == {"X.BatchNorm.scale"}
    with pytest.raises(ValueError, match="no rule for leaf"):
        convert.flax_to_torch(
            {"params": {"X": {"BatchNorm": {"scale": np.ones((3, 3), np.float32)}}}},
            device="cpu")
    with pytest.raises(ValueError, match="no rule for leaf"):
        convert.flax_to_torch(
            {"params": {"X": {"Embed": {"embedding": np.ones((3, 3), np.float32)}}}},
            device="cpu")


# ---------------------------------------------------------------- backbone

@pytest.fixture(scope="module")
def endpoints(nets):
    jeps = JInceptionV3(compute_dtype=jnp.float32).apply(
        {"params": nets["jvars"]["params"]["InceptionV3"],
         "batch_stats": nets["jvars"]["batch_stats"]["InceptionV3"]},
        jnp.asarray(nets["x"]),
    )
    with torch.no_grad():
        teps = functional_call(
            nets["tmodel"].InceptionV3, sub_vars(nets["tvars"], "InceptionV3"),
            (torch.from_numpy(nets["x"]),))
    return {k: np.asarray(v) for k, v in jeps.items()}, teps


@pytest.mark.parametrize("name", JENDPOINTS)
def test_inception_endpoint_matches_jax(endpoints, name):
    jeps, teps = endpoints
    assert inception_v3.ENDPOINTS == JENDPOINTS
    want, got = jeps[name], teps[name].numpy()
    assert got.shape == want.shape  # NHWC on both sides
    np.testing.assert_allclose(got, want, atol=1e-4)
    # and not only because deep activations are small
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def test_final_endpoint_cuts_the_network_short(nets):
    net = inception_v3.InceptionV3(compute_dtype=torch.float32, final_endpoint="Mixed_5b")
    names = [k for k, _ in net.named_parameters()]
    assert names and not any("Mixed_5c" in k or "Mixed_6" in k for k in names)
    with torch.no_grad():
        eps = functional_call(
            net, {k: v for k, v in sub_vars(nets["tvars"], "InceptionV3").items()
                  if k in set(names) | {b for b, _ in net.named_buffers()}},
            (torch.from_numpy(nets["x"]),))
    assert list(eps)[-1] == "Mixed_5b" and eps["Mixed_5b"].shape == (2, 7, 7, 256)
    assert inception_v3.feature_grid(299) == 8 and inception_v3.feature_grid(75) == 1
    assert inception_v3.feature_grid(299, "Mixed_5d") == 35


def test_unported_variants_say_so():
    # int8 is ported (tests/test_torch_quant.py holds it to the JAX
    # package): every one of the 94 units becomes a QuantConv, on the
    # folded variant only
    from multibox_tpu_torch.models.quant import QuantConv

    net = inception_v3.InceptionV3(quantize="int8", folded=True)
    assert sum(isinstance(m, QuantConv) for m in net.modules()) == 94
    with pytest.raises(ValueError, match="folded"):
        inception_v3.InceptionV3(quantize="int8")
    # the SSD head and the MobileNetV2 backbone are ported: both build and
    # give the JAX package's output shapes (tests/test_torch_ssd.py and
    # tests/test_torch_mobilenet.py hold their values to it)
    ssd = detector.MultiBoxDetector(num_priors=59 * 6, input_size=SIZE, head_type="ssd",
                                    compute_dtype=torch.float32, device="cpu")
    mnet = detector.MultiBoxDetector(num_priors=4, input_size=96, backbone="mobilenet_v2",
                                     compute_dtype=torch.float32, device="cpu")
    for model, size, jkw in ((ssd, SIZE, dict(num_priors=59 * 6, head_type="ssd")),
                             (mnet, 96, dict(num_priors=4, backbone="mobilenet_v2"))):
        shapes = jax.eval_shape(
            lambda x, m=JDetector(compute_dtype=jnp.float32, **jkw): m.init_with_output(
                jax.random.PRNGKey(0), x)[0], jnp.zeros((2, size, size, 3)))
        with torch.no_grad():
            loc, conf = detector.apply(model, model.init_variables(torch.Generator()),
                                       torch.zeros(2, size, size, 3))
        assert (tuple(loc.shape), tuple(conf.shape)) == tuple(tuple(a.shape) for a in shapes)
    with pytest.raises(ValueError, match="unknown head_type"):
        detector.MultiBoxDetector(num_priors=4, head_type="nope")
    # train mode is ported now: batch statistics, and the running update
    # left for detector.apply to collect
    net = inception_v3.ConvBN(3, 4, (3, 3), compute_dtype=torch.float32)
    weights = {"Conv.weight": torch.ones(4, 3, 3, 3), "BatchNorm.bias": torch.zeros(4),
               "BatchNorm.mean": torch.zeros(4), "BatchNorm.var": torch.ones(4)}
    y = functional_call(net, weights, (torch.rand(2, 3, 5, 5),), {"train": True})
    assert torch.isfinite(y).all() and net.BatchNorm.updated is not None


# -------------------------------------------------------------------- head

@pytest.mark.parametrize("num_classes", [1, 3])
@pytest.mark.parametrize("use_kernel_wrapper", [None, True])
def test_multibox_head_matches_jax(num_classes, use_kernel_wrapper):
    """A 3×3 feature map with distinct rows, columns and channels: a head
    that flattened NCHW instead of NHWC would not agree."""
    rng = np.random.default_rng(3)
    feat = rng.normal(0, 1, (2, 3, 3, 40)).astype(np.float32)
    jhead = JHead(num_priors=P, num_classes=num_classes, bottleneck_features=8)
    jvars = perturb(to_numpy_tree(
        jhead.init(jax.random.PRNGKey(1), {"Mixed_7c": jnp.asarray(feat)})), rng)
    want_loc, want_conf = jhead.apply(jvars, {"Mixed_7c": jnp.asarray(feat)})
    thead = MultiBoxHead(num_priors=P, in_features=40, grid=3,
                         num_classes=num_classes, bottleneck_features=8,
                         use_pallas=use_kernel_wrapper)
    tvars = convert.flax_to_torch(jvars, device="cpu")["params"]
    with torch.no_grad():
        loc, conf = functional_call(thead, tvars, ({"Mixed_7c": torch.from_numpy(feat)},))
    assert loc.shape == (2, P, 4)
    assert conf.shape == ((2, P) if num_classes == 1 else (2, P, num_classes))
    np.testing.assert_allclose(loc.numpy(), np.asarray(want_loc), atol=1e-5)
    np.testing.assert_allclose(conf.numpy(), np.asarray(want_conf), atol=1e-5)


def test_detector_matches_jax_end_to_end(nets):
    want_loc, want_conf = nets["jmodel"].apply(nets["jvars"], jnp.asarray(nets["x"]))
    with torch.no_grad():
        loc, conf = detector.apply(nets["tmodel"], nets["tvars"], torch.from_numpy(nets["x"]))
    np.testing.assert_allclose(loc.numpy(), np.asarray(want_loc), atol=1e-4)
    np.testing.assert_allclose(conf.numpy(), np.asarray(want_conf), atol=1e-4)
    with pytest.raises(ValueError, match="model built for 75"):
        detector.apply(nets["tmodel"], nets["tvars"], torch.zeros(1, 80, 80, 3))


# ------------------------------------------------------------------ folded

@pytest.mark.parametrize("use_kernel_wrapper", [None, True])
def test_folded_model_matches_unfolded_and_jax_fold(nets, use_kernel_wrapper):
    folded_vars = inception_v3.fold_batch_norms(nets["tvars"])
    assert set(folded_vars) == {"params"}
    assert not any("BatchNorm" in k for k in folded_vars["params"])
    # the same fold as the JAX package's, leaf for leaf
    jfolded = convert.flax_to_torch(
        to_numpy_tree(jfold(jax.tree_util.tree_map(jnp.asarray, nets["jvars"]))),
        device="cpu")["params"]
    assert set(jfolded) == set(folded_vars["params"])
    for key, value in jfolded.items():
        np.testing.assert_allclose(
            folded_vars["params"][key].numpy(), value.numpy(), rtol=1e-5, atol=1e-6)
    folded = detector.MultiBoxDetector(
        num_priors=P, input_size=SIZE, compute_dtype=torch.float32,
        folded=True, use_pallas=use_kernel_wrapper, device="cpu")
    assert {k for k, _ in folded.named_parameters()} == set(folded_vars["params"])
    assert sum(1 for m in folded.modules()
               if isinstance(m, inception_v3.ConvBN) and m.fused) == 40
    x = torch.from_numpy(nets["x"])
    with torch.no_grad():
        loc_f, conf_f = detector.apply(folded, folded_vars, x)
        loc_u, conf_u = detector.apply(nets["tmodel"], nets["tvars"], x)
    np.testing.assert_allclose(loc_f.numpy(), loc_u.numpy(), atol=1e-4)
    np.testing.assert_allclose(conf_f.numpy(), conf_u.numpy(), atol=1e-4)


def test_init_variables_are_seeded_and_complete():
    model = detector.MultiBoxDetector(num_priors=4, input_size=SIZE,
                                      compute_dtype=torch.float32, device="cpu")
    a = model.init_variables(torch.Generator().manual_seed(5))
    b = model.init_variables(torch.Generator().manual_seed(5))
    assert set(a["params"]) == {k for k, _ in model.named_parameters()}
    assert set(a["batch_stats"]) == {k for k, _ in model.named_buffers()}
    assert all(torch.equal(a["params"][k], b["params"][k]) for k in a["params"])
    with torch.no_grad():
        loc, conf = detector.apply(model, a, torch.zeros(1, SIZE, SIZE, 3))
    assert torch.isfinite(loc).all() and torch.isfinite(conf).all()


# ----------------------------------------------------------- preprocessing

@pytest.mark.parametrize("out_size", [75, 29])
def test_preprocess_eval_matches_jax(out_size):
    """40×53 → 75 (up) and → 29 (down): half-pixel centres, border clamp."""
    rng = np.random.default_rng(11)
    images = rng.integers(0, 256, (2, 40, 53, 3), dtype=np.uint8)
    want = jaugment.preprocess_eval(jnp.asarray(images), out_size)
    got = taugment.preprocess_eval(torch.from_numpy(images), out_size)
    assert got.shape == (2, out_size, out_size, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert float(got.min()) >= -1.0 and float(got.max()) <= 1.0


def test_preprocess_slim_matches_jax():
    from multibox_tpu.models.inception_v3 import preprocess_slim as jslim

    images = np.arange(0, 256, dtype=np.uint8).reshape(1, 16, 16, 1)
    np.testing.assert_allclose(
        inception_v3.preprocess_slim(torch.from_numpy(images)).numpy(),
        np.asarray(jslim(jnp.asarray(images))), atol=1e-6)

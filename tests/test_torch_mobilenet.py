"""multibox_tpu_torch.models.mobilenet against the JAX package's MobileNetV2
on the CPU: endpoints at both input parities and two widths, the stride-2
SAME units, the ReLU6 gradient at its ties, train-mode BatchNorm with γ,
the γ fold, the MultiBox detector over ``Final`` and one train step.

Tolerances as in ``tests/test_torch_model.py``: float32 forwards atol 1e-4
and the largest gap at most 1e-3 of the largest entry; float64 BatchNorm
rtol 1e-10; the train step as in ``tests/test_torch_train.py`` (float64
backbone on both sides, see its docstring).
"""

import numpy as np
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F
from torch.func import functional_call

from multibox_tpu.config import Config as JConfig
from multibox_tpu.models.detector import MultiBoxDetector as JDetector
from multibox_tpu.models.inception_v3 import fold_batch_norms as jfold
from multibox_tpu.models.mobilenet import (
    ENDPOINTS as JENDPOINTS,
    ConvBNRelu6 as JUnit,
    MobileNetV2 as JMobileNet,
)
from multibox_tpu.train import make_train_step as jmake_step
from multibox_tpu.train.state import TrainState as JTrainState
from multibox_tpu.train.state import make_optimizer as jmake_optimizer
from multibox_tpu_torch.config import Config
from multibox_tpu_torch.models import convert, detector, inception_v3, mobilenet
from multibox_tpu_torch.models.inception_v3 import SlimBatchNorm
from multibox_tpu_torch.train import create_train_state, make_train_step
from tests.conftest import random_boxes
from tests.test_torch_train import assert_metrics_close, assert_trees_close
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(dict(tree)))


def perturb(tree, rng):
    """Non-trivial BatchNorm γ, statistics and biases (flax initialises
    them to 1 / 0 / 1 / 0, which would hide a dropped γ or a swapped mean
    and var)."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out[key] = perturb(value, rng)
        elif key in ("var", "scale"):
            out[key] = rng.uniform(0.75, 1.25, value.shape).astype(np.float32)
        elif key in ("mean", "bias"):
            out[key] = rng.normal(0, 0.1, value.shape).astype(np.float32)
        else:
            out[key] = np.asarray(value)
    return out


def assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()


def flat(tvars):
    return {**tvars["params"], **tvars.get("batch_stats", {})}


def jax_init(module, x, **kw):
    """The flax module's variables as numpy, initialised in one jitted
    program (eager initialisation dispatches thousands of small ops)."""
    return numpy_tree(jax.jit(lambda k, a: module.init(k, a, **kw))(
        jax.random.PRNGKey(0), jax.tree_util.tree_map(jnp.asarray, x)))


def jax_apply(module, variables, x):
    return jax.jit(module.apply)(variables, jax.tree_util.tree_map(jnp.asarray, x))


# --------------------------------------------------------------- backbone

@pytest.fixture(scope="module", params=[(1.0, 64), (0.5, 75)], ids=["w1.0_even64", "w0.5_odd75"])
def backbone(request):
    """The flax MobileNetV2 with perturbed variables and the port's, at an
    even input (SAME at stride 2 pads (0, 1)) and an odd one (pads (1, 1))."""
    width, size = request.param
    rng = np.random.default_rng(int(size))
    x = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    jm = JMobileNet(width=width, compute_dtype=jnp.float32)
    jvars = perturb(jax_init(jm, x), rng)
    jeps = {k: np.asarray(v) for k, v in jax_apply(jm, jvars, x).items()}
    tm = mobilenet.MobileNetV2(width=width, compute_dtype=torch.float32)
    tvars = convert.flax_to_torch(jvars, device="cpu")
    with torch.no_grad():
        teps = functional_call(tm, flat(tvars), (torch.from_numpy(x),))
    return {"width": width, "size": size, "x": x, "jvars": jvars, "jeps": jeps,
            "tm": tm, "tvars": tvars, "teps": teps}


def test_mobilenet_endpoints_match_jax(backbone):
    jeps, teps = backbone["jeps"], backbone["teps"]
    assert set(mobilenet.ENDPOINTS) == set(JENDPOINTS) <= set(teps)
    assert set(teps) == set(jeps)
    for name in jeps:
        assert_close(teps[name].numpy(), jeps[name])
    for name in mobilenet.ENDPOINTS:
        grid = mobilenet.feature_grid(backbone["size"], name)
        assert jeps[name].shape[1:] == (grid, grid, backbone["tm"].endpoint_features[name])


def test_mobilenet_variables_convert_leaf_for_leaf(backbone):
    """Every leaf of the flax tree (γ and depthwise kernels included) maps
    to one parameter or buffer of the port's module, none left over."""
    tvars, tm = backbone["tvars"], backbone["tm"]
    want = {k: tuple(v.shape) for k, v in list(tm.named_parameters()) + list(tm.named_buffers())}
    assert {k: tuple(v.shape) for k, v in flat(tvars).items()} == want
    dw = backbone["jvars"]["params"]["Stage_1/Block_0"]["Depthwise"]["Conv"]["kernel"]
    got = tvars["params"]["Stage_1/Block_0.Depthwise.Conv.weight"].numpy()
    assert dw.shape[2] == 1 and got.shape == (dw.shape[3], 1, 3, 3)
    np.testing.assert_array_equal(got, np.transpose(dw, (3, 2, 0, 1)))
    assert "Head.BatchNorm.scale" in tvars["params"]


def test_width_rounding_and_grids():
    for width in (0.35, 0.5, 0.75, 1.0, 1.4):
        net = mobilenet.MobileNetV2(width=width)
        for ch in (16, 24, 32, 64, 96, 160, 320, 1280):
            c = int(ch * width)
            assert mobilenet._channels(ch, width) == max((c + 4) // 8 * 8, 8)
        assert net.endpoint_features["Final"] == max(mobilenet._channels(1280, width), 1280)
    assert [mobilenet.feature_grid(224, e) for e in mobilenet.ENDPOINTS] == [28, 14, 7, 7]
    assert [mobilenet.feature_grid(75, e) for e in mobilenet.ENDPOINTS] == [10, 5, 3, 3]
    with pytest.raises(ValueError, match="unknown endpoint"):
        mobilenet.feature_grid(224, "Mixed_7c")


# ------------------------------------------------------------- the units

@pytest.mark.parametrize("size", [8, 9], ids=["even", "odd"])
@pytest.mark.parametrize("depthwise", [False, True], ids=["plain", "depthwise"])
def test_stride2_unit_matches_flax(depthwise, size):
    """A stride-2 3×3 SAME unit against flax: flax pads (0, 1) on an even
    input and (1, 1) on an odd one; a symmetric padding would shift every
    output by a pixel."""
    rng = np.random.default_rng(size + 10 * depthwise)
    cin, cout = (6, 6) if depthwise else (3, 5)
    groups = cin if depthwise else 1
    x = rng.normal(0, 1, (2, size, size, cin)).astype(np.float32)
    ju = JUnit(cout, (3, 3), strides=(2, 2), groups=groups, compute_dtype=jnp.float32)
    jvars = perturb(numpy_tree(ju.init(jax.random.PRNGKey(3), jnp.asarray(x))), rng)
    want = np.asarray(ju.apply(jvars, jnp.asarray(x)))
    tu = mobilenet.ConvBNRelu6(cin, cout, (3, 3), strides=(2, 2), groups=groups,
                               compute_dtype=torch.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = functional_call(tu, flat(convert.flax_to_torch(jvars, device="cpu")), (xt,))
    assert want.shape[1] == -(-size // 2)
    assert_close(got.permute(0, 2, 3, 1).numpy(), want)
    assert inception_v3.same_padding(size, 3, 2) == ((0, 1) if size % 2 == 0 else (1, 1))


def test_relu6_gradient_at_its_ties_matches_jax():
    """At x = 6 exactly ``jnp.minimum`` splits the gradient (½), where
    ``F.relu6`` gives 0; at x = 0 both ReLUs give 0."""
    pts = np.array([-1.0, 0.0, 3.0, 6.0, 7.0], np.float32)
    want = np.asarray(jax.vmap(jax.grad(lambda v: jnp.minimum(fnn.relu(v), 6.0)))(pts))
    x = torch.from_numpy(pts).requires_grad_(True)
    mobilenet.relu6(x).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), want)
    np.testing.assert_array_equal(want, [0.0, 0.0, 1.0, 0.5, 0.0])
    y = torch.from_numpy(pts).requires_grad_(True)
    F.relu6(y).sum().backward()
    assert float(y.grad[3]) == 0.0  # the gap the port avoids


@pytest.mark.parametrize("mean_offset", [0.0, 0.5])
def test_train_mode_batchnorm_with_scale_matches_flax_float64(mean_offset):
    """BatchNorm with γ in train mode, float64 on both sides: the output,
    the running statistics at momentum 0.997 and the gradients of γ, β
    and the input."""
    rng = np.random.default_rng(5)
    x = (rng.normal(0, 1, (2, 5, 5, 12)) + mean_offset)
    g = rng.normal(0, 1, x.shape)
    scale, bias = rng.uniform(0.5, 1.5, 12), rng.normal(0, 0.1, 12)
    mean0, var0 = rng.normal(0, 0.1, 12), rng.uniform(0.5, 1.5, 12)
    with jax.enable_x64(True):
        bn = fnn.BatchNorm(use_running_average=False, momentum=0.997, epsilon=1e-3,
                           dtype=jnp.float64, param_dtype=jnp.float64)

        def run(params, xx):
            y, upd = bn.apply({"params": params, "batch_stats": {"mean": mean0, "var": var0}},
                              xx, mutable=["batch_stats"])
            return jnp.sum(y * g), (y, upd["batch_stats"])

        (_, (y, stats)), (gp, gx) = jax.value_and_grad(run, argnums=(0, 1), has_aux=True)(
            {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, jnp.asarray(x))
        y, stats, gp, gx = (numpy_tree(a) if isinstance(a, dict) else np.asarray(a)
                            for a in (y, stats, gp, gx))
    m = SlimBatchNorm(12, momentum=0.997, use_scale=True)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    xt.requires_grad_(True)
    p = {"scale": torch.from_numpy(scale).requires_grad_(True),
         "bias": torch.from_numpy(bias).requires_grad_(True)}
    yt = functional_call(m, {**p, "mean": torch.from_numpy(mean0),
                             "var": torch.from_numpy(var0)}, (xt, True))
    (yt.permute(0, 2, 3, 1) * torch.from_numpy(g)).sum().backward()
    tol = dict(rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(yt.detach().permute(0, 2, 3, 1).numpy(), y, **tol)
    np.testing.assert_allclose(m.updated[0].numpy(), stats["mean"], **tol)
    np.testing.assert_allclose(m.updated[1].numpy(), stats["var"], **tol)
    np.testing.assert_allclose(p["scale"].grad.numpy(), gp["scale"], **tol)
    np.testing.assert_allclose(p["bias"].grad.numpy(), gp["bias"], **tol)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), gx, **tol)


# ------------------------------------------------------------ the detector

P, SIZE = 8, 64


@pytest.fixture(scope="module")
def net():
    """The MobileNetV2 MultiBox detector at 64 px (``Final`` 2×2), width 0.5."""
    rng = np.random.default_rng(8)
    x = rng.uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    jm = JDetector(num_priors=P, backbone="mobilenet_v2", mobilenet_width=0.5,
                   compute_dtype=jnp.float32, bottleneck_features=8)
    jvars = perturb(jax_init(jm, x), rng)
    return {"x": x, "jm": jm, "jvars": jvars,
            "tvars": convert.flax_to_torch(jvars, device="cpu")}


def t_model(**kw):
    return detector.MultiBoxDetector(num_priors=P, input_size=SIZE, backbone="mobilenet_v2",
                                     mobilenet_width=0.5, compute_dtype=torch.float32,
                                     bottleneck_features=8, device="cpu", **kw)


@pytest.mark.parametrize("use_kernel_wrapper", [None, True])
def test_mobilenet_detector_matches_jax(net, use_kernel_wrapper):
    want_loc, want_conf = jax_apply(net["jm"], net["jvars"], net["x"])
    model = t_model(use_pallas=use_kernel_wrapper)
    assert model.backbone_scope == "MobileNetV2" and model.head_scope == "MultiBoxHead"
    with torch.no_grad():
        loc, conf = detector.apply(model, net["tvars"], torch.from_numpy(net["x"]))
    assert loc.shape == (2, P, 4) and conf.shape == (2, P)
    assert_close(loc.numpy(), want_loc)
    assert_close(conf.numpy(), want_conf)


@pytest.mark.parametrize("use_kernel_wrapper", [None, True])
def test_scale_fold_matches_jax_fold_and_the_unfolded_model(net, use_kernel_wrapper):
    folded_vars = inception_v3.fold_batch_norms(net["tvars"])
    assert not any("BatchNorm" in k for k in folded_vars["params"])
    jfolded = convert.flax_to_torch(
        numpy_tree(jfold(jax.tree_util.tree_map(jnp.asarray, net["jvars"]))),
        device="cpu")["params"]
    assert set(jfolded) == set(folded_vars["params"])
    for key, value in jfolded.items():
        np.testing.assert_allclose(folded_vars["params"][key].numpy(), value.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    folded = t_model(folded=True, use_pallas=use_kernel_wrapper)
    assert {k for k, _ in folded.named_parameters()} == set(folded_vars["params"])
    x = torch.from_numpy(net["x"])
    with torch.no_grad():
        loc_f, conf_f = detector.apply(folded, folded_vars, x)
        loc_u, conf_u = detector.apply(t_model(), net["tvars"], x)
    assert_close(loc_f.numpy(), loc_u.numpy())
    assert_close(conf_f.numpy(), conf_u.numpy())


def test_init_variables_set_scale_to_one_and_he_normal_on_the_backbone():
    model = t_model()
    v = model.init_variables(torch.Generator().manual_seed(2))
    assert set(v["params"]) == {k for k, _ in model.named_parameters()}
    scales = [k for k in v["params"] if k.endswith("BatchNorm.scale")]
    assert len(scales) == 52 and all(torch.equal(v["params"][k], torch.ones_like(
        v["params"][k])) for k in scales)
    dw = v["params"]["MobileNetV2.Stage_1/Block_0.Depthwise.Conv.weight"]
    assert abs(float(dw.std()) - (2.0 / 9) ** 0.5) < 0.05  # fan-in 3·3·1
    with torch.no_grad():
        loc, conf = detector.apply(model, v, torch.zeros(1, SIZE, SIZE, 3))
    assert torch.isfinite(loc).all() and torch.isfinite(conf).all()


# ------------------------------------------------------------ train step

def tiny_batch(rng, size, labels=None):
    batch = {
        "images": rng.normal(0, 0.5, (2, size, size, 3)).astype(np.float32),
        "boxes": np.stack([random_boxes(rng, 3, min_size=0.2), random_boxes(rng, 3, min_size=0.2)]),
        "num_boxes": np.array([3, 2], np.int32),
    }
    if labels is not None:
        batch["labels"] = rng.integers(0, labels, (2, 3)).astype(np.int32)
    return batch


def train_step_against_jax(cfg_kw, model_kw, init, priors, batch):
    """One step of both packages from the same initial variables ``init``
    (numpy ``params`` and ``batch_stats``), float64 backbone
    (``tests/test_torch_train.py``'s docstring): loss, metrics, every
    parameter, running statistic and EMA shadow after it. Returns the
    port's metrics."""
    P = priors.shape[0]
    with jax.enable_x64(True):
        cfg = JConfig(**cfg_kw)
        jm = JDetector(num_priors=P, compute_dtype=jnp.float64, bn_momentum=cfg.bn_momentum,
                       **model_kw)
        tx = jmake_optimizer(cfg)
        params = jax.tree_util.tree_map(jnp.asarray, init["params"])
        opt_state, ema = jax.jit(lambda p: (tx.init(p), jax.tree.map(lambda a: a + 0.0, p)))(
            params)
        # statistics updated from a float64 batch are float64: start them so
        state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                            batch_stats=jax.tree_util.tree_map(
                                lambda a: jnp.asarray(a, jnp.float64), init["batch_stats"]),
                            opt_state=opt_state, ema_params=ema)
        step = jax.jit(jmake_step(cfg, jm, jnp.asarray(priors)))
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        jmetrics = [{k: float(v) for k, v in m.items()}]
        final = numpy_tree({"params": state.params, "batch_stats": state.batch_stats,
                            "ema": state.ema_params})
    cfg = Config(**cfg_kw)
    tm = detector.MultiBoxDetector(num_priors=P, input_size=cfg.input_size,
                                   compute_dtype=torch.float64,
                                   bn_momentum=cfg.bn_momentum, device="cpu", **model_kw)
    tstate = create_train_state(cfg, tm, 0, P, device="cpu",
                                variables=convert.flax_to_torch(init, device="cpu"))
    tstep = make_train_step(cfg, tm, priors, device="cpu")
    tstate, tm_metrics = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()})
    metrics = [{k: float(v) for k, v in tm_metrics.items()}]
    assert_metrics_close(metrics, jmetrics)
    assert_trees_close(final, tstate, atol=1e-5)
    assert tstate.step == 1
    return metrics[0]


def test_mobilenet_train_step_matches_jax(net):
    """One update of the MobileNetV2 (width 0.5, 64 px) MultiBox detector
    at mobilenet_edge.yaml's BatchNorm momentum 0.997, from the perturbed
    variables (γ included)."""
    rng = np.random.default_rng(0)
    priors = np.sort(rng.uniform(0.05, 0.95, (P, 2, 2)).astype(np.float32),
                     axis=1).reshape(P, 4)
    cfg_kw = dict(input_size=SIZE, num_priors=P, batch_size=2, max_num_bboxes=3,
                  compute_dtype="float32", initial_learning_rate=0.003,
                  hard_negative_ratio=3.0, num_train_examples=2, bn_momentum=0.997,
                  backbone="mobilenet_v2", mobilenet_width=0.5, bottleneck_features=8)
    m = train_step_against_jax(
        cfg_kw, dict(backbone="mobilenet_v2", mobilenet_width=0.5, bottleneck_features=8),
        net["jvars"], priors, tiny_batch(rng, SIZE))
    assert m["num_pos"] > 0

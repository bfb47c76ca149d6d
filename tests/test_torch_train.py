"""The port's train step against the JAX package's on the CPU: train-mode
BatchNorm, one optimizer update, three steps, gradient accumulation.

Why the backbone runs in float64 in the step comparisons. At the test
configuration (75 px, batch 2, the JAX package's ``tiny_setup``) the
``Mixed_7`` BatchNorms normalize over two values per channel and the
fast variance E[x²] − E[x]² cancels, so float32 rounding is amplified
through the depth: measured against a float64 forward, the port's float32
locations are 1.6e-2 off and the JAX package's 3.9e-2. No float32
implementation can agree with another at 1e-4 there. Both packages take
``compute_dtype`` float64 for the backbone (flax computes BatchNorm
statistics in at least float32, and so does the port), while the head,
the loss and the optimizer stay float32 as in production; then the first
step agrees to 1e-6. The training trajectory is itself chaotic at this
configuration (a 1e-6 difference in the parameters after one update, left
by the float32 head's backward, moves the loss by 1e-4 a step later and
by percent two steps later, in the JAX package's own remat and
data-parallel tests too), so the three-step comparison runs at learning
rate 0, as that package's chunked-step test does: the forward, the
BatchNorm running statistics, the RMSProp second moment and the EMA still
advance every step.

Tolerances: losses and metrics rtol 1e-5; parameters, statistics and EMA
atol 1e-5 and rtol 1e-5 (measured 1.1e-6 on the parameters after one
update); the RMSProp second moments rtol 1e-3 and atol 1e-3 of the
tensor's largest entry: they sum squared gradients, which reach 1e6 in
the first layers at random init and carry the float32 head's backward
rounding amplified through the depth (measured 1.7e-4 relative on
``Conv2d_1a_3x3`` after three steps); train-mode BatchNorm alone at
float32 1e-5.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import flax.linen as fnn
import torch
from torch.func import functional_call

from multibox_tpu.config import Config as JConfig
from multibox_tpu.models.detector import MultiBoxDetector as JDetector
from multibox_tpu.train import create_train_state as jcreate
from multibox_tpu.train import make_train_step as jmake_step
from multibox_tpu_torch.config import Config
from multibox_tpu_torch.models import convert, detector
from multibox_tpu_torch.models.inception_v3 import SlimBatchNorm
from multibox_tpu_torch.train import create_train_state, make_train_step
from tests.conftest import random_boxes
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

TINY = dict(input_size=75, num_priors=8, batch_size=2, max_num_bboxes=3,
            compute_dtype="float32", initial_learning_rate=0.003,
            hard_negative_ratio=3.0, num_train_examples=2)


def tiny_world():
    """The JAX package's ``tiny_setup`` priors and batch (same draws)."""
    rng = np.random.default_rng(0)
    priors = np.sort(rng.uniform(0.05, 0.95, (8, 2, 2)).astype(np.float32),
                     axis=1).reshape(8, 4)
    batch = {
        "images": rng.normal(0, 0.5, (2, 75, 75, 3)).astype(np.float32),
        "boxes": np.stack([random_boxes(rng, 3), random_boxes(rng, 3)]),
        "num_boxes": np.array([3, 2], np.int32),
    }
    return priors, batch


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def run_jax(kw, steps):
    """JAX train steps with a float64 backbone; returns the initial
    variables, per-step metrics and the final state as numpy trees."""
    priors, batch = tiny_world()
    with jax.enable_x64(True):
        cfg = JConfig(**kw)
        model = JDetector(num_priors=8, compute_dtype=jnp.float64)
        state = jcreate(cfg, model, jax.random.PRNGKey(0), 8)
        init = numpy_tree({"params": state.params, "batch_stats": state.batch_stats})
        # statistics updated from a float64 batch are float64: start them
        # so, or the gradient-accumulation scan's carry changes dtype
        state = state.replace(batch_stats=jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float64), state.batch_stats))
        step = jax.jit(jmake_step(cfg, model, jnp.asarray(priors)))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        metrics = []
        for _ in range(steps):
            state, m = step(state, jb)
            metrics.append({k: float(v) for k, v in m.items()})
        final = numpy_tree({"params": state.params, "batch_stats": state.batch_stats,
                            "ema": state.ema_params, "nu": state.opt_state[0].nu})
    return init, metrics, final


def run_torch(kw, init, steps):
    priors, batch = tiny_world()
    cfg = Config(**kw)
    model = detector.MultiBoxDetector(num_priors=8, input_size=75,
                                      compute_dtype=torch.float64, device="cpu")
    state = create_train_state(cfg, model, 0, 8, device="cpu",
                               variables=convert.flax_to_torch(init, device="cpu"))
    step = make_train_step(cfg, model, priors, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = []
    for _ in range(steps):
        state, m = step(state, tb)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def assert_trees_close(final, state, atol, with_nu=False):
    want = convert.flax_to_torch({"params": final["params"], "batch_stats": final["batch_stats"],
                                  "ema": final["ema"]}, device="cpu")
    got = {"params": state.params, "batch_stats": state.batch_stats, "ema": state.ema_params}
    if with_nu:
        want["nu"] = convert.flax_to_torch({"params": final["nu"]}, device="cpu")["params"]
        got["nu"] = state.opt_state["nu"]
    for coll, tensors in want.items():
        assert set(got[coll]) == set(tensors), coll
        for k, v in tensors.items():
            rtol, tol = 1e-5, atol
            if coll == "nu":  # sums of squared gradients, see the docstring
                rtol, tol = 1e-3, 1e-3 * float(v.abs().max())
            np.testing.assert_allclose(got[coll][k].detach().double().numpy(),
                                       v.double().numpy(), atol=tol, rtol=rtol,
                                       err_msg=f"{coll}/{k}")


def assert_metrics_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("case", ["one_update", "three_steps_lr0", "grad_accum2"])
def test_tiny_train_steps_match_jax(case):
    """``one_update``: one step at the tiny setup's learning rate, every
    parameter, statistic and EMA shadow after it. ``three_steps_lr0``:
    three steps, per-step loss and metrics, then statistics, EMA and the
    RMSProp second moment. ``grad_accum2``: two sequential microbatches of
    one image, BatchNorm statistics carried between them, one update."""
    kw = dict(TINY)
    steps = 1
    if case == "three_steps_lr0":
        kw["initial_learning_rate"], steps = 0.0, 3
    elif case == "grad_accum2":
        kw["grad_accum_steps"] = 2
    init, jmetrics, final = run_jax(kw, steps)
    state, metrics = run_torch(kw, init, steps)
    assert state.step == steps and state.opt_state["count"] == steps
    assert_metrics_close(metrics, jmetrics)
    assert_trees_close(final, state, atol=1e-5, with_nu=case == "three_steps_lr0")
    assert metrics[-1]["num_pos"] > 0


@pytest.mark.parametrize("mean_offset", [0.0, 0.5])
def test_train_mode_batchnorm_matches_flax(mean_offset):
    """One BatchNorm at float32: the output and the updated running
    statistics against flax's ``BatchNorm(use_running_average=False)``."""
    rng = np.random.default_rng(3)
    x = (rng.normal(0, 1, (2, 9, 9, 40)) + mean_offset).astype(np.float32)
    bias = rng.normal(0, 0.1, 40).astype(np.float32)
    mean0 = rng.normal(0, 0.1, 40).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 40).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-3,
                       use_scale=False, dtype=jnp.float32)
    y, upd = bn.apply({"params": {"bias": bias},
                       "batch_stats": {"mean": mean0, "var": var0}},
                      jnp.asarray(x), mutable=["batch_stats"])
    m = SlimBatchNorm(40, momentum=0.9)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    yt = functional_call(m, {"bias": torch.from_numpy(bias), "mean": torch.from_numpy(mean0),
                             "var": torch.from_numpy(var0)}, (xt, True))
    np.testing.assert_allclose(yt.permute(0, 2, 3, 1).numpy(), np.asarray(y),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.updated[0].numpy(), np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(m.updated[1].numpy(), np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)


def test_train_mode_detector_matches_flax_endpoints_and_batch_stats():
    """The whole detector in train mode (float64 backbone, see the module
    docstring): locations, logits and every new running statistic against
    flax's ``apply(train=True, mutable=["batch_stats"])``, and the
    statistics leave ``apply`` keyed like ``batch_stats``."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 0.5, (2, 75, 75, 3)).astype(np.float32)
    with jax.enable_x64(True):
        jm = JDetector(num_priors=8, compute_dtype=jnp.float64)
        v = jax.jit(lambda k, a: jm.init(k, a, train=True))(
            jax.random.PRNGKey(1), jnp.asarray(x))
        (jl, jc), upd = jax.jit(lambda w, a: jm.apply(
            w, a, train=True, mutable=["batch_stats"]))(v, jnp.asarray(x))
        jl, jc, upd, v = (numpy_tree(a) for a in (jl, jc, upd, dict(v)))
    tm = detector.MultiBoxDetector(num_priors=8, input_size=75,
                                   compute_dtype=torch.float64, device="cpu")
    tv = convert.flax_to_torch(v, device="cpu")
    (tl, tc), stats = detector.apply(tm, tv, torch.from_numpy(x), train=True)
    np.testing.assert_allclose(tl.detach().numpy(), jl, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tc.detach().numpy(), jc, rtol=1e-5, atol=1e-5)
    want = convert.flax_to_torch({"params": v["params"], "batch_stats": upd["batch_stats"]},
                                 device="cpu")["batch_stats"]
    assert set(stats) == set(want) == set(tv["batch_stats"])
    for k, w in want.items():
        np.testing.assert_allclose(stats[k].double().numpy(), w.double().numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
    assert all(m.updated is None for m in tm.modules() if isinstance(m, SlimBatchNorm))

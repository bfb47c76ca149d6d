"""multibox_tpu_torch.train.loss and the backward of the fused matmul
kernel against the JAX package on the CPU.

Tolerances: the loss and every metric rtol 1e-5 (float32 sums over a few
hundred terms in another order); the gradients with respect to the
locations and logits 1e-5; the fused layer's dx, dw, db at float32
rtol 1e-5 (products over K = 70 in another order) and at bfloat16
2e-2 (one bfloat16 rounding of the result).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from multibox_tpu.ops.pallas.fused_matmul import fused_matmul_bias_relu as jfused
from multibox_tpu.train import loss as jloss
from multibox_tpu_torch.ops import kernels
from multibox_tpu_torch.ops.kernels import fused_matmul
from multibox_tpu_torch.train import loss as tloss
from tests.conftest import random_boxes
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def t(a):
    return torch.from_numpy(np.array(a))


def loss_inputs(seed, multiclass):
    rng = np.random.default_rng(seed)
    B, G, P, C = 4, 5, 48, 3
    priors = random_boxes(rng, P)
    gt = np.stack([random_boxes(rng, G) for _ in range(B)])
    num_gt = np.array([5, 3, 0, 1], np.int32)
    loc = rng.normal(0, 0.05, (B, P, 4)).astype(np.float32)
    shape = (B, P, C) if multiclass else (B, P)
    conf = rng.normal(0, 1.5, shape).astype(np.float32)
    conf[0, :4] = conf[0, 4]  # equal negative losses: the rank tie-break
    labels = rng.integers(0, C, (B, G)).astype(np.int32)
    labels[0, 1] = C  # out of range: counted in num_bad_labels
    return priors, gt, num_gt, loc, conf, labels


@pytest.mark.parametrize("use_pallas", [None, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("multiclass", [False, True], ids=["agnostic", "multiclass"])
@pytest.mark.parametrize("ratio", [0.0, 3.0], ids=["all_neg", "hnm3"])
@pytest.mark.parametrize("conf_loss", ["bce", "focal"])
def test_multibox_loss_and_metrics_match_jax(conf_loss, ratio, multiclass, use_pallas):
    priors, gt, num_gt, loc, conf, labels = loss_inputs(1, multiclass)
    kw = dict(hard_negative_ratio=ratio, conf_loss=conf_loss, alpha=1.5,
              use_pallas=use_pallas)
    jl = jnp.asarray(labels) if multiclass else None
    tl = t(labels) if multiclass else None
    args = [jnp.asarray(a) for a in (loc, conf, gt, num_gt, priors)]
    if use_pallas:
        with pltpu.force_tpu_interpret_mode():
            want_total, want = jloss.multibox_loss(*args, gt_labels=jl, **kw)
    else:
        want_total, want = jloss.multibox_loss(*args, gt_labels=jl, **kw)
    got_total, got = tloss.multibox_loss(t(loc), t(conf), t(gt), t(num_gt), t(priors),
                                         gt_labels=tl, **kw)
    assert set(got) == set(want)
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-5)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    if multiclass:
        assert float(got["num_bad_labels"]) == 1.0
    assert float(got["num_pos"]) > 0


@pytest.mark.parametrize("multiclass", [False, True], ids=["agnostic", "multiclass"])
def test_loss_gradients_match_jax(multiclass):
    priors, gt, num_gt, loc, conf, labels = loss_inputs(2, multiclass)
    jl = jnp.asarray(labels) if multiclass else None

    def f(loc_, conf_):
        return jloss.multibox_loss(loc_, conf_, jnp.asarray(gt), jnp.asarray(num_gt),
                                   jnp.asarray(priors), gt_labels=jl)[0]

    want_loc, want_conf = jax.grad(f, argnums=(0, 1))(jnp.asarray(loc), jnp.asarray(conf))
    tloc, tconf = t(loc).requires_grad_(True), t(conf).requires_grad_(True)
    total, _ = tloss.multibox_loss(tloc, tconf, t(gt), t(num_gt), t(priors),
                                   gt_labels=t(labels) if multiclass else None)
    total.backward()
    np.testing.assert_allclose(tloc.grad.numpy(), np.asarray(want_loc), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tconf.grad.numpy(), np.asarray(want_conf), rtol=1e-5, atol=1e-7)


def test_bce_helpers_match_jax():
    # atol 1e-30: XLA on the CPU flushes subnormal results (log1p(e^-90)
    # is 8e-40) to zero, PyTorch keeps them
    x = np.array([-90.0, -5.0, -0.5, 0.0, 0.5, 5.0, 90.0], np.float32)
    z = np.array([0.0, 1.0, 0.0, 1.0, 1.0, 0.0, 1.0], np.float32)
    np.testing.assert_allclose(tloss.optax_sigmoid_bce(t(x), t(z)).numpy(),
                               np.asarray(jloss.optax_sigmoid_bce(x, z)), rtol=1e-6,
                               atol=1e-30)
    np.testing.assert_allclose(tloss.focal_sigmoid_bce(t(x), t(z), 1.5, 0.3).numpy(),
                               np.asarray(jloss.focal_sigmoid_bce(x, z, 1.5, 0.3)),
                               rtol=1e-5, atol=1e-30)


def test_hungarian_matching_is_refused():
    """Hungarian matching was refused until it was ported: it now gives the
    JAX package's loss (rtol 1e-5, as above), and an unknown method is
    refused."""
    priors, gt, num_gt, loc, conf, _ = loss_inputs(3, False)
    want_total, _ = jloss.multibox_loss(*[jnp.asarray(a) for a in (loc, conf, gt, num_gt,
                                                                   priors)],
                                        matching="hungarian")
    got_total, _ = tloss.multibox_loss(t(loc), t(conf), t(gt), t(num_gt), t(priors),
                                       matching="hungarian")
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-5)
    with pytest.raises(ValueError, match="unknown matching method"):
        tloss.multibox_loss(t(loc), t(conf), t(gt), t(num_gt), t(priors), matching="nope")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("relu", [True, False])
def test_fused_matmul_backward_matches_the_jax_custom_vjp(dtype, relu):
    """B2's autograd (kernel forward, plain backward) against the JAX
    custom VJP with the Pallas forward in interpret mode. Some outputs are
    exactly 0 (a zero row of x with a zero bias), where the mask uses the
    output as the JAX backward does."""
    rng = np.random.default_rng(4)
    M, K, N = 33, 70, 21
    x = rng.normal(0, 1, (M, K)).astype(np.float32)
    x[3] = 0.0
    w = (rng.normal(0, 1, (K, N)) / np.sqrt(K)).astype(np.float32)
    b = rng.normal(0, 0.1, N).astype(np.float32)
    b[:5] = 0.0
    g = rng.normal(0, 1, (M, N)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    y, vjp = jax.vjp(lambda a, c, d: jfused(a, c, d, relu), jx, jw, jnp.asarray(b))
    dx, dw, db = vjp(jnp.asarray(g).astype(y.dtype))
    tx = t(x).to(tdt).requires_grad_(True)
    tw = t(w).to(tdt).requires_grad_(True)
    tb = t(b).requires_grad_(True)
    ty = fused_matmul.fused_matmul_bias_relu(tx, tw, tb, relu)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(ty.detach().float().numpy(),
                               np.asarray(y.astype(jnp.float32)), rtol=tol, atol=tol)
    if relu:
        assert (ty.detach()[3, :5] == 0).all()  # outputs exactly 0
    kernels.reset_launch_counts()
    ty.backward(t(g).to(tdt))
    assert kernels.launch_counts()["fused_matmul_backward"] == 0  # CPU
    for got, want in ((tx.grad, dx), (tw.grad, dw), (tb.grad, db)):
        assert got.dtype == {jnp.float32: torch.float32,
                             jnp.bfloat16: torch.bfloat16}[want.dtype.type]
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   rtol=tol, atol=tol)


def test_fused_matmul_backward_equals_plain_autograd():
    """The hand-written backward against autograd through the plain
    version (the comparison the card makes at the head's shapes)."""
    rng = np.random.default_rng(9)
    x = t(rng.normal(0, 1, (17, 40)).astype(np.float32)).requires_grad_(True)
    w = t(rng.normal(0, 0.2, (40, 9)).astype(np.float32)).requires_grad_(True)
    b = t(rng.normal(0, 0.1, 9).astype(np.float32)).requires_grad_(True)
    g = t(rng.normal(0, 1, (17, 9)).astype(np.float32))
    got = torch.autograd.grad(fused_matmul.fused_matmul_bias_relu(x, w, b, True), (x, w, b), g)
    want = torch.autograd.grad(fused_matmul.fused_matmul_plain(x, w, b, True), (x, w, b), g)
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, rtol=1e-6, atol=1e-6)

"""multibox_tpu_torch.ops.matching and the matching kernel's plain version
against the JAX package on the CPU.

Tolerances: assignments and per-prior indices exact (integers; the IoU is
computed with the same rounded f32 operations in the same order, and ties
break on the first row-major cell in both); benefits and targets 1e-6
(one f32 rounding of values in [0, 1]). The plain version of the CUDA
matching kernel is held exactly against the Pallas kernel in interpret
mode.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multibox_tpu.ops import matching as jm
from multibox_tpu.ops.pallas.match_kernel import greedy_match_pallas_batched
from multibox_tpu_torch.ops import kernels, matching as tm
from multibox_tpu_torch.ops.kernels import box_kernel, match_kernel
from tests.conftest import random_boxes
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def t(a):
    return torch.from_numpy(np.array(a))


def batch_boxes(rng, B, G):
    return np.stack([random_boxes(rng, G) for _ in range(B)]).astype(np.float32)


def jax_greedy_batched(gt, num_gt, priors):
    return np.asarray(jax.vmap(
        lambda g, n: jm.greedy_match(jm.compute_benefit(g, priors), n)
    )(jnp.asarray(gt), jnp.asarray(num_gt)))


def test_compute_benefit_plain_and_hybrid_match_jax():
    rng = np.random.default_rng(0)
    gt = random_boxes(rng, 5)
    priors = random_boxes(rng, 40)
    conf = rng.normal(0, 1, 40).astype(np.float32)
    loc = rng.normal(0, 0.05, (40, 4)).astype(np.float32)
    want = jm.compute_benefit(jnp.asarray(gt), jnp.asarray(priors))
    got = tm.compute_benefit(t(gt), t(priors))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    want = jm.compute_benefit(jnp.asarray(gt), jnp.asarray(priors), jnp.asarray(conf),
                              jnp.asarray(loc), alpha=0.7, conf_weight=0.5)
    got = tm.compute_benefit(t(gt), t(priors), t(conf), t(loc), alpha=0.7,
                             conf_weight=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # batched: one call over [B, G, 4] equals the per-image calls
    gts = batch_boxes(rng, 3, 5)
    got = tm.compute_benefit(t(gts), t(priors))
    for b in range(3):
        np.testing.assert_array_equal(got[b].numpy(),
                                      tm.compute_benefit(t(gts[b]), t(priors)).numpy())


def tie_heavy_benefit(rng, G, P):
    """Benefits quantized to eight levels (many exact ties), a duplicated
    row and an all-zero row."""
    b = np.round(rng.uniform(0, 1, (G, P)) * 7) / 7
    b[1] = b[0]
    b[2] = 0.0
    return b.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "ties", "num_gt_0", "num_gt_above_P"])
def test_greedy_match_is_index_exact_against_jax(kind):
    rng = np.random.default_rng({"random": 1, "ties": 2, "num_gt_0": 3,
                                 "num_gt_above_P": 4}[kind])
    G, P = (12, 7) if kind == "num_gt_above_P" else (10, 30)
    for _ in range(4):
        benefit = (tie_heavy_benefit(rng, G, P) if kind == "ties"
                   else rng.uniform(0, 1, (G, P)).astype(np.float32))
        n = {"num_gt_0": 0, "num_gt_above_P": G}.get(kind, int(rng.integers(1, G + 1)))
        want = np.asarray(jm.greedy_match(jnp.asarray(benefit), jnp.int32(n)))
        got = tm.greedy_match(t(benefit), n).numpy()
        np.testing.assert_array_equal(got, want)
        if kind == "num_gt_above_P":
            assert (got >= 0).sum() == P  # the rows past P rounds stay -1
    # batched over images with different counts
    bs = np.stack([tie_heavy_benefit(rng, G, P) for _ in range(5)])
    ns = rng.integers(0, G + 1, 5).astype(np.int32)
    want = np.asarray(jax.vmap(jm.greedy_match)(jnp.asarray(bs), jnp.asarray(ns)))
    np.testing.assert_array_equal(tm.greedy_match(t(bs), t(ns)).numpy(), want)


@pytest.mark.parametrize("B,G,P", [(1, 5, 40), (4, 8, 130), (9, 16, 256), (2, 128, 300)])
def test_kernel_plain_version_is_exact_against_the_pallas_kernel(B, G, P):
    """greedy_match_plain (what the CUDA kernel is held to on the card)
    against greedy_match_pallas_batched in interpret mode, and against the
    vmapped jnp spec."""
    rng = np.random.default_rng(B * 1000 + G)
    gt = batch_boxes(rng, B, G)
    if G >= 16:
        gt[0, 3] = gt[0, 2]  # a duplicated gt box: tied IoU rows
        gt[0, 4] = [0.99, 0.99, 0.995, 0.995]  # overlaps no prior: zero row
    priors = random_boxes(rng, P)
    num_gt = rng.integers(0, G + 1, B).astype(np.int32)
    num_gt[0] = G
    got = match_kernel.greedy_match_cuda(t(gt), t(num_gt), t(priors)).numpy()
    want = np.asarray(greedy_match_pallas_batched(
        jnp.asarray(gt), jnp.asarray(num_gt), jnp.asarray(priors), interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_greedy_batched(gt, num_gt, priors))
    assert got.dtype == np.int32


def test_match_wrapper_takes_the_plain_version_on_the_cpu_and_refuses_bad_input():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(5)
    gt, priors = t(batch_boxes(rng, 2, 4)), t(random_boxes(rng, 9))
    n = torch.tensor([4, 1], dtype=torch.int32)
    assert torch.equal(match_kernel.greedy_match_cuda(gt, n, priors),
                       match_kernel.greedy_match_plain(gt, n, priors))
    assert kernels.launch_counts()["match"] == 0
    with pytest.raises(ValueError):
        match_kernel.greedy_match_cuda(gt[0], n, priors)
    with pytest.raises(ValueError):
        match_kernel.greedy_match_cuda(gt, n[:1], priors)


@pytest.mark.parametrize("multi_match_iou", [0.0, 0.5])
@pytest.mark.parametrize("encode", ["multibox", "ssd"])
def test_dense_assignment_and_targets_match_jax(multi_match_iou, encode):
    rng = np.random.default_rng(6)
    B, G, P = 3, 6, 50
    gt = batch_boxes(rng, B, G)
    priors = random_boxes(rng, P)
    num_gt = np.array([6, 2, 0], np.int32)
    labels = rng.integers(0, 4, (B, G)).astype(np.int32)
    assign = jax_greedy_batched(gt, num_gt, priors)
    jpg = jax.vmap(lambda a, g, n: jm.dense_prior_assignment(
        a, g, n, jnp.asarray(priors), multi_match_iou))(
        jnp.asarray(assign), jnp.asarray(gt), jnp.asarray(num_gt))
    tpg = tm.dense_prior_assignment(t(assign), t(gt), t(num_gt), t(priors),
                                    multi_match_iou)
    np.testing.assert_array_equal(tpg.numpy(), np.asarray(jpg))
    if multi_match_iou:
        assert (tpg.numpy() >= 0).sum() > (assign >= 0).sum()  # it densified
    want = jax.vmap(lambda pg, g, lb: jm.dense_targets(
        pg, g, jnp.asarray(priors), encode, lb))(jpg, jnp.asarray(gt), jnp.asarray(labels))
    got = tm.dense_targets(tpg, t(gt), t(priors), encode, t(labels))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)
    # the per-gt form, image by image
    for b in range(B):
        want = jm.matching_targets(jnp.asarray(assign[b]), jnp.asarray(gt[b]),
                                   jnp.asarray(priors), encode, jnp.asarray(labels[b]))
        got = tm.matching_targets(t(assign[b]), t(gt[b]), t(priors), encode, t(labels[b]))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_match_priors_matches_jax_and_refuses_hungarian():
    rng = np.random.default_rng(7)
    gt, priors = random_boxes(rng, 4), random_boxes(rng, 30)
    want = jm.match_priors(jnp.asarray(gt), jnp.int32(3), jnp.asarray(priors),
                           multi_match_iou=0.4)
    got = tm.match_priors(t(gt), torch.tensor(3), t(priors), multi_match_iou=0.4)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy().astype(np.float64),
                                   np.asarray(w).astype(np.float64), rtol=1e-6, atol=1e-6)
    # Hungarian was refused until it was ported; now it is the JAX package's
    want = jm.match_priors(jnp.asarray(gt), jnp.int32(3), jnp.asarray(priors),
                           method="hungarian")
    got = tm.match_priors(t(gt), torch.tensor(3), t(priors), method="hungarian")
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy().astype(np.float64),
                                   np.asarray(w).astype(np.float64), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="unknown matching method"):
        tm.match_priors(t(gt), torch.tensor(3), t(priors), method="nope")


def test_dense_targets_route_through_the_encode_kernel_gives_the_plain_result():
    """use_kernel=True sends the multibox encode through the box kernel's
    wrapper, which on the CPU is the plain ``gt − prior``: bitwise equal."""
    rng = np.random.default_rng(8)
    gt, priors = t(batch_boxes(rng, 2, 5)), t(random_boxes(rng, 20))
    assign = match_kernel.greedy_match_plain(gt, torch.tensor([5, 3]), priors)
    pg = tm.dense_prior_assignment(assign, gt, torch.tensor([5, 3]), priors)
    kernels.reset_launch_counts()
    a = tm.dense_targets(pg, gt, priors, use_kernel=True)
    b = tm.dense_targets(pg, gt, priors, use_kernel=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert kernels.launch_counts()["box_encode"] == 0  # CPU: the plain version
    assert box_kernel.encode_boxes_cuda is not None

"""multibox_tpu_torch.ops.matching.hungarian_match against scipy and the
JAX package's ``hungarian_match`` on the CPU, on the cases of
tests/test_matching.py, then through ``match_priors`` and
``multibox_loss``.

Tolerances: assignments exact (integers) against the JAX package on every
case, and against ``scipy.optimize.linear_sum_assignment`` wherever the
optimum is unique (uniform or IoU benefits: float64 there, float32 here,
but no two assignments' totals come within the rounding). On tie-heavy
integer benefits several assignments are optimal, and scipy picks among
equal columns in another order (it scans them from the last), so there the
total benefit equals scipy's exactly (integers) and the indices equal the
JAX package's, whose rule the port keeps. Targets 1e-6, losses rtol 1e-5
as in tests/test_torch_matching.py and tests/test_torch_loss.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from scipy.optimize import linear_sum_assignment

from multibox_tpu.ops import boxes as jbox
from multibox_tpu.ops import matching as jm
from multibox_tpu.train import loss as jloss
from multibox_tpu_torch.ops import matching as tm
from multibox_tpu_torch.train import loss as tloss
from tests.conftest import random_boxes
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def t(a):
    return torch.from_numpy(np.array(a))


def scipy_assignment(benefit, num_gt):
    """scipy's per-row columns for the first min(num_gt, P) rows, −1 for the
    rest (the truncation the packages document; scipy itself raises)."""
    n = min(int(num_gt), benefit.shape[1])
    out = np.full(benefit.shape[0], -1)
    if n:
        rows, cols = linear_sum_assignment(benefit[:n].astype(np.float64), maximize=True)
        out[rows] = cols
    return out


def total(benefit, assignment):
    return sum(float(benefit[i, j]) for i, j in enumerate(assignment) if j >= 0)


def jax_batched(benefit, num_gt):
    return np.asarray(jax.vmap(jm.hungarian_match)(jnp.asarray(benefit),
                                                  jnp.asarray(num_gt, jnp.int32)))


def check(benefit, num_gt, unique=True):
    """[B, G, P] benefits: the port's one batched call against the JAX
    package per image (vmapped) and scipy per image."""
    got = tm.hungarian_match(t(benefit), t(np.asarray(num_gt, np.int32))).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jax_batched(benefit, num_gt))
    for b in range(benefit.shape[0]):
        want = scipy_assignment(benefit[b], num_gt[b])
        if unique:
            np.testing.assert_array_equal(got[b], want)
        else:
            assert (got[b] >= 0).tolist() == (want >= 0).tolist()
            assert total(benefit[b], got[b]) == total(benefit[b], want)
        active = got[b][got[b] >= 0]
        assert len(set(active.tolist())) == len(active)
    return got


@pytest.mark.parametrize("G,P,num_gt", [(5, 40, 5), (8, 100, 3), (1, 16, 1), (16, 64, 16)])
def test_hungarian_matches_scipy_and_jax_on_the_grid(G, P, num_gt):
    rng = np.random.default_rng(0)
    benefit = rng.uniform(0, 1, size=(1, G, P)).astype(np.float32)
    got = check(benefit, [num_gt])
    assert (got[0, num_gt:] == -1).all() and (got[0, :num_gt] >= 0).all()


def test_hungarian_on_iou_benefit():
    rng = np.random.default_rng(1)
    gt = np.stack([random_boxes(rng, 6) for _ in range(4)])
    priors = random_boxes(rng, 80)
    benefit = np.asarray(jax.vmap(lambda g: jbox.iou_matrix(g, jnp.asarray(priors)))(
        jnp.asarray(gt)))
    check(benefit, [6, 4, 1, 6])


def test_hungarian_many_random_exact():
    """20 random instances in one batch each of a few sizes, with the rows
    of the batch's images at different depths of their searches."""
    rng = np.random.default_rng(2)
    for _ in range(5):
        G = int(rng.integers(1, 12))
        P = int(rng.integers(G, 60))
        benefit = rng.uniform(0, 1, size=(4, G, P)).astype(np.float32)
        check(benefit, rng.integers(0, G + 1, 4))


def test_hungarian_more_gt_than_priors_truncates():
    """num_gt > P: the first P rows are matched among themselves (scipy on
    those rows), the rest get −1."""
    rng = np.random.default_rng(3)
    benefit = rng.uniform(0, 1, size=(1, 6, 3)).astype(np.float32)
    got = check(benefit, [6])
    assert (got[0, 3:] == -1).all() and sorted(got[0, :3].tolist()) == [0, 1, 2]


def test_hungarian_batch_with_mixed_num_gt_and_overflow():
    """One batch: an image past P, a padded one, an empty one, a full one —
    the masked lock step leaves each image's result its own."""
    rng = np.random.default_rng(4)
    priors = random_boxes(rng, 8)
    gt = np.stack([random_boxes(rng, 12) for _ in range(4)])
    num_gt = np.array([12, 3, 0, 9], np.int32)
    benefit = np.asarray(jax.vmap(lambda g: jbox.iou_matrix(g, jnp.asarray(priors)))(
        jnp.asarray(gt)))
    got = check(benefit, num_gt)
    for b in range(4):
        alone = tm.hungarian_match(t(benefit[b]), int(num_gt[b])).numpy()
        np.testing.assert_array_equal(got[b], alone)
    assert (got[2] == -1).all()


@pytest.mark.parametrize("levels", [2, 3], ids=["binary", "ternary"])
def test_hungarian_tie_heavy_integer_benefits(levels):
    """Integer benefits tie everywhere: the column picked among the least
    tentative costs (unassigned first, then the lowest index) decides the
    assignment, so it must be the JAX package's exactly."""
    rng = np.random.default_rng(5 + levels)
    benefit = rng.integers(0, levels, size=(6, 7, 12)).astype(np.float32)
    benefit[0] = 1.0  # every cell equal
    check(benefit, rng.integers(1, 8, 6).clip(max=7), unique=False)


def test_hungarian_counts_its_exit_tests():
    rng = np.random.default_rng(6)
    benefit = t(rng.uniform(0, 1, size=(3, 5, 20)).astype(np.float32))
    tm.reset_exit_tests()
    tm.hungarian_match(benefit, t(np.array([5, 2, 0], np.int32)))
    # one read of the row count, then at least one test per active row
    assert tm.EXIT_TESTS["calls"] == 1 and tm.EXIT_TESTS["tests"] >= 1 + 5
    tm.hungarian_match(benefit, 0)
    assert tm.EXIT_TESTS["calls"] == 2


def test_match_priors_hungarian_matches_jax():
    rng = np.random.default_rng(7)
    B, G, P = 4, 5, 40
    gt = np.stack([random_boxes(rng, G) for _ in range(B)])
    num_gt = np.array([5, 3, 0, 1], np.int32)
    priors = random_boxes(rng, P)
    want = jax.vmap(lambda g, n: jm.match_priors(g, n, jnp.asarray(priors),
                                                 method="hungarian"))(
        jnp.asarray(gt), jnp.asarray(num_gt))
    got = tm.match_priors(t(gt), t(num_gt), t(priors), method="hungarian")
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)


@pytest.mark.parametrize("hybrid", [0.0, 0.5], ids=["iou", "hybrid"])
def test_multibox_loss_with_hungarian_matches_jax(hybrid):
    rng = np.random.default_rng(8)
    B, G, P = 4, 5, 48
    priors = random_boxes(rng, P)
    gt = np.stack([random_boxes(rng, G) for _ in range(B)])
    num_gt = np.array([5, 3, 0, 1], np.int32)
    loc = rng.normal(0, 0.05, (B, P, 4)).astype(np.float32)
    conf = rng.normal(0, 1.5, (B, P)).astype(np.float32)
    kw = dict(matching="hungarian", hybrid_conf_weight=hybrid)
    want_total, want = jloss.multibox_loss(
        *[jnp.asarray(a) for a in (loc, conf, gt, num_gt, priors)], **kw)
    got_total, got = tloss.multibox_loss(t(loc), t(conf), t(gt), t(num_gt), t(priors), **kw)
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-5)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)
    assert float(got["num_pos"]) == 9.0

"""multibox_tpu_torch.priors' k-means against the JAX package on the CPU.

torch cannot reproduce ``jax.random``'s draws, so the seeding is held to
its properties and ``_lloyd`` to the JAX package's from the same initial
centers. Tolerance for ``_lloyd``: atol 1e-6 on the centers (means of
values in [0, 1], float32 sums over up to 500 points in another order);
the assignments of the hand-made cases, an empty cluster and a point at
equal distance from two centers, are exact (values exact in float32).
The properties of the seeded whole run are tests/test_priors.py's.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from multibox_tpu import priors as jpriors
from multibox_tpu_torch import priors as tpriors
from tests.conftest import random_boxes


def lloyd_both(points, centers, iters):
    want = np.asarray(jpriors._lloyd(jnp.asarray(points), jnp.asarray(centers), iters))
    got = tpriors._lloyd(torch.from_numpy(points), torch.from_numpy(centers), iters).numpy()
    return got, want


@pytest.mark.parametrize("k,iters", [(16, 50), (5, 1), (32, 10)])
def test_lloyd_matches_jax_from_given_centers(k, iters):
    rng = np.random.default_rng(k)
    points = random_boxes(rng, 500)
    centers = points[rng.choice(500, k, replace=False)].copy()
    got, want = lloyd_both(points, centers, iters)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_lloyd_keeps_an_empty_clusters_center_and_breaks_ties_to_the_first():
    points = np.array([[0.0, 0.0, 0.0, 0.0], [0.5, 0.5, 0.5, 0.5],
                       [1.0, 1.0, 1.0, 1.0], [0.25, 0.25, 0.25, 0.25]], np.float32)
    # center 2 is nearest to no point (empty); point 3 sits at equal
    # distance from centers 0 and 1 and must go to center 0
    centers = np.array([[0.0, 0.0, 0.0, 0.0], [0.5, 0.5, 0.5, 0.5],
                        [9.0, 9.0, 9.0, 9.0], [1.0, 1.0, 1.0, 1.0]], np.float32)
    got, want = lloyd_both(points, centers, 1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[2], centers[2])
    np.testing.assert_array_equal(got[0], np.full(4, 0.125, np.float32))
    np.testing.assert_array_equal(got[1], centers[1])


def test_kmeans_deterministic():
    boxes = random_boxes(np.random.default_rng(0), 500)
    p1 = tpriors.generate_priors_kmeans(boxes, 16, seed=3, device="cpu")
    p2 = tpriors.generate_priors_kmeans(boxes, 16, seed=3, device="cpu")
    np.testing.assert_array_equal(p1, p2)
    assert p1.dtype == np.float32
    np.testing.assert_array_equal(p1, p1[np.lexsort((p1[:, 3], p1[:, 2], p1[:, 1],
                                                     p1[:, 0]))])


def test_kmeans_covers_modes():
    rng = np.random.default_rng(0)
    a = np.tile([[0.1, 0.1, 0.3, 0.3]], (100, 1)) + rng.normal(0, 0.005, (100, 4))
    b = np.tile([[0.6, 0.6, 0.9, 0.9]], (100, 1)) + rng.normal(0, 0.005, (100, 4))
    boxes = np.concatenate([a, b]).astype(np.float32)
    priors = tpriors.generate_priors_kmeans(boxes, 2, seed=0, device="cpu")
    assert np.linalg.norm(priors - [0.1, 0.1, 0.3, 0.3], axis=1).min() < 0.05
    assert np.linalg.norm(priors - [0.6, 0.6, 0.9, 0.9], axis=1).min() < 0.05


def test_kmeans_shape_and_validity():
    boxes = random_boxes(np.random.default_rng(1), 300)
    priors = tpriors.generate_priors_kmeans(boxes, 32, seed=1, device="cpu")
    assert priors.shape == (32, 4)
    assert (priors[:, 2] >= priors[:, 0]).all() and (priors[:, 3] >= priors[:, 1]).all()


def test_kmeans_pp_seeds_distinct_points_and_survives_identical_ones():
    boxes = random_boxes(np.random.default_rng(2), 50)
    gen = torch.Generator().manual_seed(0)
    centers = tpriors._kmeans_pp_init(gen, torch.from_numpy(boxes), 8).numpy()
    rows = {tuple(r) for r in centers}
    assert len(rows) == 8 and rows <= {tuple(r) for r in boxes}
    # all distances zero: every draw picks index 0, nothing divides by 0;
    # the mean of ten equal floats is within one rounding of them
    same = np.tile(boxes[:1], (10, 1))
    out = tpriors.generate_priors_kmeans(same, 3, seed=0, device="cpu")
    np.testing.assert_allclose(out, np.tile(boxes[:1], (3, 1)), atol=1e-7)

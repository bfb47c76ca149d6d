"""multibox_tpu_torch.ops against multibox_tpu.ops on the CPU.

The same inputs, made with a seeded numpy generator, go through the JAX
function and its PyTorch counterpart. On the CPU the port's kernel wrappers
take their plain versions; the JAX side runs its Pallas kernels in
interpret mode where it has one.
"""

import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from multibox_tpu.ops import boxes as jboxes
import multibox_tpu.ops.nms  # noqa: F401  (the package re-exports a function named nms)
from multibox_tpu.ops.pallas.box_kernel import (
    decode_boxes_pallas,
    encode_boxes_pallas,
)
from multibox_tpu.ops.pallas.fused_matmul import (
    fused_matmul_bias_relu as fused_matmul_pallas,
)
from multibox_tpu.ops.pallas.nms_kernel import nms_pallas_batched
from multibox_tpu_torch.ops import boxes as tboxes
from multibox_tpu_torch.ops import nms as tnms
from multibox_tpu_torch.ops.kernels import box_kernel, fused_matmul, nms_kernel
from tests.conftest import random_boxes

jnms = sys.modules["multibox_tpu.ops.nms"]


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def n(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()


def batch_boxes(rng, B, P):
    return np.stack([random_boxes(rng, P) for _ in range(B)], axis=0)


# ---------------------------------------------------------------- ops/boxes

@pytest.mark.parametrize(
    "name", ["area", "clip_boxes", "flip_boxes_horizontal"]
)
def test_boxes_unary_matches_jax(rng, name):
    b = random_boxes(rng, 40) + rng.normal(0, 0.2, (40, 4)).astype(np.float32)
    want = getattr(jboxes, name)(jnp.asarray(b))
    got = getattr(tboxes, name)(t(b))
    np.testing.assert_allclose(n(got), n(want), atol=1e-6)


@pytest.mark.parametrize("name", ["intersection", "iou_matrix"])
def test_boxes_pairwise_matrix_matches_jax(rng, name):
    a, b = random_boxes(rng, 17), random_boxes(rng, 23)
    b[3] = 0.0  # degenerate (padding) box: IoU 0, not NaN
    want = getattr(jboxes, name)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(tboxes, name)(t(a), t(b))
    assert got.shape == (17, 23)
    np.testing.assert_allclose(n(got), n(want), atol=1e-6)


def test_iou_pairwise_matches_jax(rng):
    a, b = batch_boxes(rng, 3, 11), batch_boxes(rng, 3, 11)
    b[0, 0] = 0.0
    want = jboxes.iou_pairwise(jnp.asarray(a), jnp.asarray(b))
    got = tboxes.iou_pairwise(t(a), t(b))
    np.testing.assert_allclose(n(got), n(want), atol=1e-6)


@pytest.mark.parametrize("clip", [True, False])
def test_residual_encoding_matches_jax(rng, clip):
    gt, pri = batch_boxes(rng, 2, 19), random_boxes(rng, 19)
    enc_j = jboxes.encode_boxes(jnp.asarray(gt), jnp.asarray(pri))
    enc_t = tboxes.encode_boxes(t(gt), t(pri))
    np.testing.assert_allclose(n(enc_t), n(enc_j), atol=1e-6)
    off = rng.normal(0, 0.3, (2, 19, 4)).astype(np.float32)
    want = jboxes.decode_boxes(jnp.asarray(off), jnp.asarray(pri)[None], clip=clip)
    got = tboxes.decode_boxes(t(off), t(pri)[None], clip=clip)
    np.testing.assert_allclose(n(got), n(want), atol=1e-6)


@pytest.mark.parametrize("clip", [True, False])
def test_ssd_encoding_matches_jax(rng, clip):
    gt, pri = random_boxes(rng, 31), random_boxes(rng, 31)
    enc_j = jboxes.encode_boxes_ssd(jnp.asarray(gt), jnp.asarray(pri))
    enc_t = tboxes.encode_boxes_ssd(t(gt), t(pri))
    np.testing.assert_allclose(n(enc_t), n(enc_j), atol=1e-5)
    off = rng.normal(0, 0.5, (31, 4)).astype(np.float32)
    want = jboxes.decode_boxes_ssd(jnp.asarray(off), jnp.asarray(pri), clip=clip)
    got = tboxes.decode_boxes_ssd(t(off), t(pri), clip=clip)
    np.testing.assert_allclose(n(got), n(want), atol=1e-6)


# ------------------------------------------------------------------ ops/nms

def assert_nms_equal(got, want):
    """(boxes, scores, idx, num): indices and counts exact."""
    np.testing.assert_array_equal(n(got[2]), n(want[2]))
    np.testing.assert_array_equal(n(got[3]), n(want[3]))
    np.testing.assert_allclose(n(got[1]), n(want[1]), atol=1e-6)
    np.testing.assert_allclose(n(got[0]), n(want[0]), atol=1e-6)
    assert got[2].dtype == torch.int32


@pytest.mark.parametrize("use_kernel_wrapper", [False, True])
@pytest.mark.parametrize(
    "P,k,iou,thr",
    [(50, 10, 0.5, 0.1), (128, 32, 0.3, float("-inf")), (20, 20, 0.7, 0.0),
     (128, 128, 0.5, 0.1)],
)
def test_nms_matches_jax(rng, P, k, iou, thr, use_kernel_wrapper):
    boxes = random_boxes(rng, P)
    scores = rng.uniform(0, 1, P).astype(np.float32)
    want = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), k, iou, thr)
    # On CPU tensors use_pallas=True goes through the kernel's wrapper and
    # lands on its plain version.
    got = tnms.nms(t(boxes), t(scores), k, iou, thr, use_pallas=use_kernel_wrapper)
    assert_nms_equal(got, want)


def test_nms_score_threshold_and_empty_padding():
    """The cases of tests/test_nms.py: only above-threshold boxes survive,
    and empty slots are idx −1 / score −1 / box 0."""
    boxes = np.array(
        [[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9], [0.0, 0.6, 0.3, 0.9]],
        np.float32,
    )
    scores = np.array([0.9, 0.05, 0.6], np.float32)
    sel_b, sel_s, sel_i, nv = tnms.nms(t(boxes), t(scores), 5, 0.5, 0.5)
    want = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), 5, 0.5, 0.5)
    assert int(nv) == 2
    np.testing.assert_array_equal(n(sel_i), [0, 2, -1, -1, -1])
    np.testing.assert_array_equal(n(sel_s)[2:], [-1, -1, -1])
    np.testing.assert_array_equal(n(sel_b)[2:], np.zeros((3, 4)))
    assert_nms_equal((sel_b, sel_s, sel_i, nv), want)


def test_nms_ties_take_the_lowest_index(rng):
    boxes = random_boxes(rng, 60)
    scores = (np.round(rng.uniform(0, 1, 60) * 4) / 4).astype(np.float32)
    want = jnms.nms(jnp.asarray(boxes), jnp.asarray(scores), 60, 0.4, 0.0)
    got = tnms.nms(t(boxes), t(scores), 60, 0.4, 0.0)
    assert_nms_equal(got, want)


@pytest.mark.parametrize("with_classes", [False, True])
@pytest.mark.parametrize("use_kernel_wrapper", [False, True])
def test_batched_nms_matches_jax(rng, with_classes, use_kernel_wrapper):
    B, P, k = 3, 96, 16
    boxes = batch_boxes(rng, B, P)
    scores = rng.uniform(0, 1, (B, P)).astype(np.float32)
    cls = rng.integers(0, 3, (B, P)).astype(np.int32) if with_classes else None
    want = jnms.batched_nms(
        jnp.asarray(boxes), jnp.asarray(scores), k, 0.5, 0.1,
        class_ids=None if cls is None else jnp.asarray(cls),
    )
    got = tnms.batched_nms(
        t(boxes), t(scores), k, 0.5, 0.1,
        class_ids=None if cls is None else t(cls),
        use_pallas=use_kernel_wrapper,
    )
    assert_nms_equal(got, want)
    # the returned boxes are the UN-offset ones
    assert float(got[0].max()) <= 1.0


@pytest.mark.parametrize("with_classes", [False, True])
def test_batched_soft_nms_matches_jax(rng, with_classes):
    B, P, k = 2, 64, 20
    boxes = batch_boxes(rng, B, P)
    scores = rng.uniform(0, 1, (B, P)).astype(np.float32)
    cls = rng.integers(0, 2, (B, P)).astype(np.int32) if with_classes else None
    want = jnms.batched_soft_nms(
        jnp.asarray(boxes), jnp.asarray(scores), k, 0.5, 0.05,
        class_ids=None if cls is None else jnp.asarray(cls),
    )
    got = tnms.batched_soft_nms(
        t(boxes), t(scores), k, 0.5, 0.05,
        class_ids=None if cls is None else t(cls),
    )
    assert_nms_equal(got, want)


def test_soft_nms_keeps_occluded_true_positive():
    """tests/test_nms.py's case: hard NMS drops the occluded box, soft keeps
    it with a decayed score — same answer from both packages."""
    boxes = np.array(
        [[0.1, 0.1, 0.5, 0.5], [0.15, 0.15, 0.55, 0.55], [0.6, 0.6, 0.9, 0.9]],
        np.float32,
    )
    scores = np.array([0.9, 0.8, 0.7], np.float32)
    got = tnms.soft_nms(t(boxes), t(scores), 3, 0.5, 0.001)
    want = jnms.soft_nms(jnp.asarray(boxes), jnp.asarray(scores), 3, 0.5, 0.001)
    assert int(got[3]) == 3
    assert_nms_equal(got, want)
    hard = tnms.nms(t(boxes), t(scores), 3, 0.5)
    assert int(hard[3]) == 2


# ------------------------------------- plain versions against Pallas kernels

@pytest.mark.parametrize("B,P,k", [(1, 50, 10), (3, 200, 32), (8, 128, 100), (11, 96, 16)])
def test_plain_nms_matches_pallas_interpret(rng, B, P, k):
    boxes = batch_boxes(rng, B, P)
    scores = rng.uniform(0, 1, (B, P)).astype(np.float32)
    want = nms_pallas_batched(
        jnp.asarray(boxes), jnp.asarray(scores), k, 0.5, 0.1, interpret=True
    )
    got = nms_kernel.nms_cuda_batched(t(boxes), t(scores), k, 0.5, 0.1)
    assert_nms_equal(got, want)


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("M,K,N", [(70, 50, 30), (33, 130, 70), (8, 256, 128)])
def test_plain_matmul_matches_pallas_interpret(rng, M, K, N, relu):
    x = rng.normal(0, 1, (M, K)).astype(np.float32)
    w = rng.normal(0, 0.1, (K, N)).astype(np.float32)
    b = rng.normal(0, 0.1, N).astype(np.float32)
    want = fused_matmul_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu)
    got = fused_matmul.fused_matmul_bias_relu(t(x), t(w), t(b), relu)
    # both accumulate in f32; only the order of the K-sum differs
    np.testing.assert_allclose(n(got), n(want), rtol=1e-5, atol=1e-5)


def test_plain_matmul_bf16_output_dtype(rng):
    x = t(rng.normal(0, 1, (9, 20)).astype(np.float32)).to(torch.bfloat16)
    w = t(rng.normal(0, 0.2, (20, 6)).astype(np.float32)).to(torch.bfloat16)
    b = t(rng.normal(0, 0.1, 6).astype(np.float32))
    got = fused_matmul.fused_matmul_bias_relu(x, w, b, True)
    assert got.dtype == torch.bfloat16 and got.shape == (9, 6)
    want = torch.relu(x.float() @ w.float() + b)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=2e-2, atol=2e-2)


def test_conv1x1_is_the_matmul_over_pixels(rng):
    x = rng.normal(0, 1, (2, 3, 5, 7)).astype(np.float32)
    w = rng.normal(0, 0.3, (7, 4)).astype(np.float32)
    b = rng.normal(0, 0.1, 4).astype(np.float32)
    got = fused_matmul.conv1x1_bias_relu(t(x), t(w), t(b), True)
    want = np.maximum(x.reshape(-1, 7) @ w + b, 0).reshape(2, 3, 5, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("prior_shape", [(77, 4), (1, 77, 4)])
def test_plain_decode_matches_pallas(rng, clip, prior_shape):
    offsets = rng.normal(0, 0.3, (3, 77, 4)).astype(np.float32)
    priors = random_boxes(rng, 77)
    want = decode_boxes_pallas(jnp.asarray(offsets), jnp.asarray(priors)[None], clip=clip)
    got = box_kernel.decode_boxes_cuda(t(offsets), t(priors.reshape(prior_shape)), clip)
    np.testing.assert_array_equal(n(got), n(want))  # add-then-clip is exact


def test_plain_encode_matches_pallas(rng):
    gt, priors = batch_boxes(rng, 2, 33), random_boxes(rng, 33)
    want = encode_boxes_pallas(jnp.asarray(gt), jnp.asarray(priors))
    got = box_kernel.encode_boxes_cuda(t(gt), t(priors))
    np.testing.assert_array_equal(n(got), n(want))


def test_matmul_refuses_tensors_that_require_grad(rng):
    x = t(rng.normal(0, 1, (4, 5)).astype(np.float32)).requires_grad_()
    w = t(rng.normal(0, 1, (5, 3)).astype(np.float32))
    b = torch.zeros(3)
    with pytest.raises(NotImplementedError, match="training slice"):
        fused_matmul.fused_matmul_bias_relu(x, w, b, True)
    with torch.no_grad():
        assert fused_matmul.fused_matmul_bias_relu(x, w, b, True).shape == (4, 3)

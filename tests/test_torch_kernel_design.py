"""The designs of the port's B1 (NMS + top-k), B2 (fused matmul), B3 (box
decode/encode) and B4 (greedy matching) kernels, checked on the CPU where
the kernels cannot run.

- B2's route planner (``fused_matmul._plan``) over every shape the port's
  paths give it: the head's three layers, every folded 1×1 unit at batch 32
  (enumerated from the model), and the ragged cases; its slices partition
  K, its workspace matches its grid, and the FC and Bottleneck shapes put
  enough blocks up.
- B2's arithmetic, emulated in plain PyTorch (each slice's partial product,
  then the reduction kernel's fixed order of sums, bias and ReLU), against
  the JAX Pallas kernel in interpret mode at the head's full shapes with
  ``chip_smoke.py``'s data. Tolerance rtol 1e-4 / atol 1e-4, the kernel's
  own against its plain version on the card.
- Why the tall f32 route keeps plain f32 products: TF32 rounding, emulated
  by rounding away 13 mantissa bits, misses that tolerance at K = 2048,
  where f32 and 3xTF32 keep it.
- B4's rounds (each row's running best, a rescan only for rows whose best
  column was just taken), written here in numpy, give exactly the
  assignments of the plain version and of the JAX package's
  ``greedy_match``, on tie-heavy cases drawn by hypothesis.
- B1's sorted scan (``nms_kernel.sorted_scan_emulation``: the kernel's keys
  with -0.0 made +0.0, the descending sort, the chunks tested against the
  kept list and against themselves, the in-order resolution, the cut at K)
  gives exactly the indices, scores and counts of the plain version, of the
  JAX package's ``_nms_jnp`` and of its Pallas kernel in interpret mode, on
  the card's edge cases and on tie-heavy grid boxes drawn by hypothesis.
- B3's launch plan (``box_kernel._plan``) covers every box once at the
  main and SSD shapes, with either priors layout, one box, and more rows
  than a grid's y limit.
"""

import numpy as np
import pytest
from hypothesis import HealthCheck, example, given, settings
from hypothesis import strategies as st

import functools

import jax
import jax.numpy as jnp
import torch

from multibox_tpu.ops import matching as jm
from multibox_tpu.ops.nms import _nms_jnp
from multibox_tpu.ops.pallas.nms_kernel import nms_pallas_batched
from multibox_tpu.ops.pallas.fused_matmul import (
    fused_matmul_bias_relu as fused_matmul_pallas,
)
from multibox_tpu_torch.models.inception_v3 import fused_unit_shapes
from multibox_tpu_torch.ops import boxes as box_ops
from multibox_tpu_torch.ops import matching as tm
from multibox_tpu_torch.ops.kernels import box_kernel, fused_matmul, match_kernel, nms_kernel
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

F32, BF16 = torch.float32, torch.bfloat16
HEAD = (("Bottleneck", 2048, 2048, 96, True), ("Locations", 32, 6144, 1024, False),
        ("Confidences", 32, 6144, 256, False))
RAGGED = ((65, 17, 129, BF16), (33, 130, 70, F32), (1, 5, 3, F32), (1, 256, 128, F32),
          (64, 1000, 200, F32), (65, 256, 128, F32), (32, 6144, 1000, F32),
          (2050, 2052, 100, F32), (1000, 72, 40, BF16), (500, 1288, 200, BF16),
          (512, 2048, 384, BF16))


@pytest.fixture(scope="module")
def folded_units():
    return fused_unit_shapes(32)


# ------------------------------------------------------------ B2: the plan

def check_plan(plan, M, K, N, dtype):
    cdiv = fused_matmul._cdiv
    S, L = plan.split_k, plan.kslice
    # slices [s·L, min((s+1)·L, K)) cover K once, none empty
    assert S >= 1 and (S - 1) * L < K <= S * L or (S == 1 and K == 0)
    bounds = [(s * L, min((s + 1) * L, K)) for s in range(S)]
    assert bounds[0][0] == 0 and bounds[-1][1] == K
    assert all(a < b for a, b in bounds) or K == 0
    assert all(bounds[i][1] == bounds[i + 1][0] for i in range(S - 1))
    bm, bn, bk = plan.tile
    mt, nt = cdiv(M, bm), cdiv(N, bn)
    if plan.route == "skinny":
        assert plan.grid == (nt, mt, S) and M <= fused_matmul.SKINNY_MAX_M
    else:
        assert plan.grid == (mt, nt, S)
    assert plan.blocks == mt * nt * S
    if plan.route != "general":
        row = 8 if dtype == BF16 else 4  # 16-byte chunks
        assert K % row == 0 and N % row == 0 and (S == 1 or L % row == 0)
    else:
        assert S == 1
    # the workspace holds the slices' partial sums, [S, M, N] f32
    assert plan.workspace_floats == (S * M * N if S > 1 else 0)
    assert plan.grid[1] <= 65535 and plan.grid[2] <= 65535


def test_plan_routes_the_head():
    plans = {name: fused_matmul._plan(M, K, N, F32) for name, M, K, N, _ in HEAD}
    for name, M, K, N, _ in HEAD:
        check_plan(plans[name], M, K, N, F32)
    assert plans["Bottleneck"].route == "tall_f32" and plans["Bottleneck"].blocks >= 128
    for name in ("Locations", "Confidences"):  # two blocks on each of 132 SMs
        assert plans[name].route == "skinny" and plans[name].blocks >= 264
        assert plans[name].split_k > 1


def test_plan_routes_every_folded_unit(folded_units):
    assert len(folded_units) == 40  # the folded Inception-v3's 1×1 stride-1 units
    assert {m for _, m, _, _ in folded_units} == {170528, 39200, 9248, 2048}  # batch 32
    for _, M, K, N in folded_units:
        plan = fused_matmul._plan(M, K, N, BF16)
        check_plan(plan, M, K, N, BF16)
        assert plan.route == "tall_bf16"
        assert plan.tile[1] == next((t for t in (32, 64, 96, 128) if N <= t), 64)


@pytest.mark.parametrize("M,K,N,dtype", RAGGED)
def test_plan_routes_the_ragged_cases(M, K, N, dtype):
    plan = fused_matmul._plan(M, K, N, dtype)
    check_plan(plan, M, K, N, dtype)
    if dtype == BF16:
        assert plan.route == ("tall_bf16" if K % 8 == 0 and N % 8 == 0 else "general")
    elif K % 4 or N % 4:
        assert plan.route == "general"
    else:
        assert plan.route == ("skinny" if M <= 64 else "tall_f32" if M >= 512 else "general")


def test_plan_edges_and_refusals():
    # the skinny boundary, unaligned pointers, the split only where it pays
    assert fused_matmul._plan(64, 256, 128, F32).route == "skinny"
    assert fused_matmul._plan(65, 256, 128, F32).route == "general"
    assert fused_matmul._plan(32, 6144, 1024, F32, aligned=False).route == "general"
    assert fused_matmul._plan(39200, 288, 64, BF16, aligned=False).route == "general"
    assert fused_matmul._plan(39200, 288, 64, BF16).split_k == 1
    small = fused_matmul._plan(512, 2048, 384, BF16)  # the 8×8 units at batch 8
    assert small.split_k > 1 and small.kslice % 64 == 0
    uneven = fused_matmul._plan(64, 1000, 200, F32)
    assert uneven.split_k * uneven.kslice != 1000  # a short last slice
    with pytest.raises(ValueError, match="too large"):
        fused_matmul._plan(2**31, 8, 8, F32)
    with pytest.raises(ValueError, match="too large"):
        fused_matmul._plan(8, 8, 8 * 65536 * 128, BF16)


# ------------------------------------------------------ B2: the arithmetic

def split_k_emulation(x, w, b, relu, plan):
    """What the split routes compute: each slice's partial product in f32,
    then the reduction kernel's order: warp g sums slices g, g + 8, ... in
    turn, warp 0 adds the 8 partial sums in warp order, then bias, ReLU."""
    S, L = plan.split_k, plan.kslice
    parts = [x[:, s * L:(s + 1) * L] @ w[s * L:(s + 1) * L] for s in range(S)]
    if S == 1:
        y = parts[0] + b
    else:
        groups = []
        for g in range(8):
            acc = torch.zeros_like(parts[0])
            for s in range(g, S, 8):
                acc = acc + parts[s]
            groups.append(acc)
        y = groups[0]
        for g in range(1, 8):
            y = y + groups[g]
        y = y + b
    return torch.relu(y) if relu else y


@pytest.mark.parametrize("name,M,K,N,relu", HEAD, ids=[h[0] for h in HEAD])
def test_split_k_arithmetic_holds_the_tolerance_against_pallas(name, M, K, N, relu):
    rng = np.random.default_rng(7)
    x = np.maximum(rng.normal(0, 1, (M, K)), 0).astype(np.float32)
    w = (rng.normal(0, 1, (K, N)) / np.sqrt(K)).astype(np.float32)
    b = rng.normal(0, 0.1, N).astype(np.float32)
    want = np.asarray(fused_matmul_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu))
    plan = fused_matmul._plan(M, K, N, F32)
    assert plan.split_k > 1
    got = split_k_emulation(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                            relu, plan)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # a different split is a different order of the same sums
    again = split_k_emulation(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                              relu, fused_matmul.Plan("tall_f32", (0, 0, 0), 3, -(-K // 3),
                                                      (1, 1, 3), 1))
    np.testing.assert_allclose(again.numpy(), want, rtol=1e-4, atol=1e-4)


def tf32(a):
    """Round f32 to TF32 (10 mantissa bits): to nearest on the 13 dropped."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def test_single_pass_tf32_misses_the_tolerance_where_f32_and_3xtf32_hold():
    rng = np.random.default_rng(0)
    M, K, N = 2048, 2048, 96  # the Bottleneck, chip_smoke's data
    x = np.maximum(rng.normal(0, 1, (M, K)), 0).astype(np.float32)
    w = (rng.normal(0, 1, (K, N)) / np.sqrt(K)).astype(np.float32)
    exact = x.astype(np.float64) @ w.astype(np.float64)
    xb, wb = tf32(x), tf32(w)
    xs, ws = tf32(x - xb), tf32(w - wb)
    f64 = np.float64
    one_pass = xb.astype(f64) @ wb.astype(f64)
    three = one_pass + xb.astype(f64) @ ws.astype(f64) + xs.astype(f64) @ wb.astype(f64)
    plain = (torch.from_numpy(x) @ torch.from_numpy(w)).numpy()
    err = {k: float(np.abs(v - exact).max())
           for k, v in (("tf32", one_pass), ("3xtf32", three), ("f32", plain))}
    assert err["tf32"] > 1e-4, err
    assert err["3xtf32"] < 1e-5 and err["f32"] < 1e-5, err


# --------------------------------------------------- B4: the round structure

def running_best_rounds(benefit, n):
    """B4's rounds in numpy: each live row keeps (best value, lowest column
    among equal values); a round takes the row whose best is largest (the
    lowest row among equal ones, i.e. the lowest flat index), kills its row
    and column, and rescans only the live rows whose cached column died.
    Returns the assignment and the number of rescans."""
    G, P = benefit.shape
    n = max(0, min(int(n), G))
    out = np.full(G, -1, np.int32)
    dead_col = np.zeros(P, bool)

    def best_of(i):
        live = np.where(dead_col, -np.inf, benefit[i])
        j = int(np.argmax(live))  # first of equal values
        return (live[j], j) if np.isfinite(live[j]) else (None, None)

    best = {i: best_of(i) for i in range(n)}
    rescans = 0
    for _ in range(min(n, P)):
        live_rows = [i for i in best if best[i][0] is not None]
        if not live_rows:
            break
        i = min(live_rows, key=lambda r: (-best[r][0], r * P + best[r][1]))
        j = best[i][1]
        out[i] = j
        dead_col[j] = True
        del best[i]
        for r in best:
            if best[r][1] == j:
                best[r] = best_of(r)
                rescans += 1
    return out, rescans


GRID = (0.0, 0.25, 0.5, 0.75, 1.0)  # few coordinates: many equal IoUs
SHAPES = ((6, 12), (8, 5), (12, 12))  # G < P, G > P, square


def grid_boxes(draw, k):
    boxes = []
    for _ in range(k):
        y = sorted(draw(st.sampled_from(GRID)) for _ in range(2))
        x = sorted(draw(st.sampled_from(GRID)) for _ in range(2))
        boxes.append([y[0], x[0], y[1], x[1]])
    return np.asarray(boxes, np.float32)


@st.composite
def tie_heavy_worlds(draw):
    G, P = draw(st.sampled_from(SHAPES))
    B = 3
    gt = np.stack([grid_boxes(draw, G) for _ in range(B)])
    pri = grid_boxes(draw, P)
    for b in range(B):  # duplicated gt rows and a zero-area (zero-IoU) row
        if draw(st.booleans()):
            gt[b, draw(st.integers(1, G - 1))] = gt[b, 0]
        if draw(st.booleans()):
            gt[b, draw(st.integers(0, G - 1))] = [0.5, 0.5, 0.5, 0.5]
    if draw(st.booleans()):  # duplicated priors
        pri[draw(st.integers(1, P - 1))] = pri[0]
    num = np.asarray([draw(st.integers(0, G)) for _ in range(B)], np.int32)
    return gt, num, pri


_jax_greedy = jax.jit(jax.vmap(lambda g, n, p: jm.greedy_match(jm.compute_benefit(g, p), n),
                               in_axes=(0, 0, None)))


def check_world(gt, num, pri):
    tg, tn, tp = torch.from_numpy(gt), torch.from_numpy(num), torch.from_numpy(pri)
    plain = match_kernel.greedy_match_plain(tg, tn, tp).numpy()
    jax_out = np.asarray(_jax_greedy(jnp.asarray(gt), jnp.asarray(num), jnp.asarray(pri)))
    benefit = tm.compute_benefit(tg, tp).numpy()  # the plain version's IoUs, bit for bit
    rescans = 0
    for b in range(gt.shape[0]):
        got, r = running_best_rounds(benefit[b], num[b])
        rescans += r
        np.testing.assert_array_equal(got, plain[b])
        np.testing.assert_array_equal(got, jax_out[b])
    return rescans


@settings(max_examples=60, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(tie_heavy_worlds())
@example((np.zeros((3, 8, 4), np.float32), np.asarray([0, 8, 3], np.int32),
          np.zeros((5, 4), np.float32)))  # all-zero IoU, num_gt 0, G > P
def test_running_bests_give_the_greedy_assignments(world):
    check_world(*world)


def test_running_bests_on_duplicates_rescan_and_agree():
    # every gt row the same box: all rows share one best prior, so each round
    # rescans all the rows left
    rng = np.random.default_rng(3)
    gt = np.repeat(rng.uniform(0.2, 0.4, (1, 1, 4)).astype(np.float32), 10, axis=1)
    gt[..., 2:] += 0.3
    gt = np.repeat(gt, 2, axis=0)
    pri = np.sort(rng.uniform(0, 1, (16, 2, 2)), axis=1).reshape(16, 4).astype(np.float32)
    pri[5] = pri[9]
    assert check_world(gt, np.asarray([10, 7], np.int32), pri) > 0


# ------------------------------------------------------- B1: the sorted scan

def random_nms_boxes(rng, B, P, lo=0.05, hi=0.5):
    cy, cx = rng.uniform(0.1, 0.9, (2, B, P))
    h, w = rng.uniform(lo, hi, (2, B, P))
    return np.clip(np.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], -1),
                   0, 1).astype(np.float32)


def nms_edge_cases():
    """(name, boxes, scores, K, iou threshold, score threshold): the cases
    ``chip_smoke.py`` holds the kernel to, at small sizes."""
    rng = np.random.default_rng(11)
    boxes = random_nms_boxes(rng, 3, 40)
    scores = rng.uniform(0, 1, (3, 40)).astype(np.float32)
    zeros = rng.choice(np.array([0.0, -0.0, 0.25, -0.25], np.float32), (3, 40))
    odd = scores.copy()
    odd[:, ::5], odd[:, 1::7], odd[:, 2::11] = np.nan, np.inf, -np.inf
    centre = random_nms_boxes(rng, 3, 1, 0.3, 0.5)
    cluster = np.clip(centre + rng.normal(0, 0.01, (3, 40, 4)), 0, 1).astype(np.float32)
    ninf = float("-inf")
    return [
        ("random", boxes, scores, 24, 0.5, 0.01),
        ("signed_zeros", boxes, zeros, 24, 0.5, ninf),
        ("signed_zeros_at_threshold", boxes, zeros, 24, 0.5, 0.0),
        ("nan_and_inf", boxes, odd, 24, 0.5, ninf),
        ("nan_and_inf_thresholded", boxes, odd, 24, 0.5, 0.5),
        ("all_equal", boxes, np.full((3, 40), 0.5, np.float32), 24, 0.5, 0.0),
        ("all_dead", boxes, scores, 24, 0.5, 2.0),
        ("dense_cluster", cluster, scores, 24, 0.5, 0.0),
        ("p1", boxes[:, :1], scores[:, :1], 5, 0.5, ninf),
        ("k_equals_p", boxes, scores, 40, 0.5, ninf),
        ("k_above_p", boxes, scores, 50, 0.7, ninf),
        ("p33", random_nms_boxes(rng, 2, 33), rng.uniform(0, 1, (2, 33)).astype(np.float32),
         40, 0.3, 0.0),
        ("p257", random_nms_boxes(rng, 2, 257), rng.uniform(0, 1, (2, 257)).astype(np.float32),
         100, 0.5, 0.0),
    ]


@functools.lru_cache(maxsize=None)
def _jax_nms(K):
    """vmap of the JAX package's ``_nms_jnp``, the thresholds traced."""
    return jax.jit(lambda b, s, iou, thr: jax.vmap(
        lambda bb, ss: _nms_jnp(bb, ss, K, iou, thr))(b, s))


def check_sorted_scan(boxes, scores, K, iou, thr, pallas=False):
    """The emulation against the plain version and the JAX spec exactly;
    with ``pallas`` also against the Pallas kernel in interpret mode.
    Returns the chunks run."""
    got_idx, got_scores, chunks = nms_kernel.sorted_scan_emulation(boxes, scores, K, iou, thr)
    want_idx, want_scores = nms_kernel.nms_batched_plain(
        torch.from_numpy(boxes), torch.from_numpy(scores), K, iou, thr)
    np.testing.assert_array_equal(got_idx, want_idx.numpy())
    np.testing.assert_array_equal(got_scores, want_scores.numpy())
    refs = [_jax_nms(K)(boxes, scores, np.float32(iou), np.float32(thr))]
    if pallas:
        refs.append(jax.jit(functools.partial(
            nms_pallas_batched, max_outputs=K, iou_threshold=iou, score_threshold=thr,
            interpret=True))(boxes, scores))
    for _, ref_scores, ref_idx, ref_num in refs:
        np.testing.assert_array_equal(got_idx, np.asarray(ref_idx))
        np.testing.assert_array_equal(got_scores, np.asarray(ref_scores))
        np.testing.assert_array_equal((got_idx >= 0).sum(1), np.asarray(ref_num))
    return chunks


@pytest.mark.parametrize("case", nms_edge_cases(), ids=lambda c: c[0])
def test_sorted_scan_gives_the_spec_on_the_edge_cases(case):
    name, boxes, scores, K, iou, thr = case
    chunks = check_sorted_scan(boxes, scores, K, iou, thr, pallas=True)
    if name == "dense_cluster":  # most candidates suppressed: every chunk runs
        assert chunks.min() == 2
    if name == "all_dead":
        assert chunks.max() == 0


def test_sorted_scan_orders_signed_zeros_by_index():
    # -0.0 first at index 0, +0.0 at index 1, disjoint boxes: the spec keeps
    # both in index order, as raw float bits would not
    boxes = np.asarray([[[0, 0, 0.1, 0.1], [0.5, 0.5, 0.6, 0.6]]], np.float32)
    scores = np.asarray([[-0.0, 0.0]], np.float32)
    idx, sc, _ = nms_kernel.sorted_scan_emulation(boxes, scores, 2, 0.5, float("-inf"))
    assert idx.tolist() == [[0, 1]] and np.signbit(sc[0, 0]) and not np.signbit(sc[0, 1])
    check_sorted_scan(boxes, scores, 2, 0.5, float("-inf"))


@st.composite
def tie_heavy_nms_worlds(draw):
    P = draw(st.sampled_from((8, 33)))
    K = draw(st.sampled_from((5, 40)))
    boxes = np.stack([grid_boxes(draw, P) for _ in range(2)])
    levels = np.asarray([0.0, -0.0, 0.25, 0.5, 1.0], np.float32)
    scores = levels[np.asarray(draw(st.lists(st.integers(0, 4), min_size=2 * P,
                                             max_size=2 * P))).reshape(2, P)]
    iou = draw(st.sampled_from((0.0, 0.3, 0.5)))
    thr = draw(st.sampled_from((float("-inf"), 0.0, 0.25)))
    return boxes, scores, K, iou, thr


@settings(max_examples=40, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(tie_heavy_nms_worlds())
def test_sorted_scan_gives_the_spec_on_tie_heavy_grid_boxes(world):
    check_sorted_scan(*world)


def brute_force_iou_tests(boxes, scores, sel_idx, K, iou, thr):
    """Greedy NMS's IoU tests, one pair at a time through the plain
    version's IoU: live candidates by (score descending, index ascending),
    each against the kept boxes in order up to the first above ``iou``."""
    tests = 0
    for b in range(scores.shape[0]):
        live = [i for i in range(scores.shape[1])
                if scores[b, i] >= np.float32(thr) and scores[b, i] != -np.inf]
        kept = []
        for c in sorted(live, key=lambda i: (-float(scores[b, i]), i)):
            if len(kept) == K:
                break
            for n, k in enumerate(kept):
                pair = torch.from_numpy(boxes[b, [k, c]])
                if float(box_ops.iou_pairwise(pair[0], pair[1])) > np.float32(iou):
                    tests += n + 1
                    break
            else:
                tests += len(kept)
                kept.append(c)
        assert kept == [i for i in sel_idx[b] if i >= 0]
    return tests


@pytest.mark.parametrize("case", [c for c in nms_edge_cases()
                                  if c[0] in ("random", "signed_zeros", "nan_and_inf_thresholded",
                                              "dense_cluster", "k_equals_p", "p33")],
                         ids=lambda c: c[0])
def test_greedy_iou_tests_count_the_work_the_selection_needs(case):
    """``greedy_iou_tests``, the work ``chip_smoke.py``'s bound of B1 counts."""
    _, boxes, scores, K, iou, thr = case
    idx, _ = nms_kernel.nms_batched_plain(torch.from_numpy(boxes), torch.from_numpy(scores),
                                          K, iou, thr)
    want = brute_force_iou_tests(boxes, scores, idx.numpy(), K, iou, thr)
    assert nms_kernel.greedy_iou_tests(boxes, scores, idx.numpy(), iou, thr) == want


def test_greedy_iou_tests_on_disjoint_boxes_and_a_wrong_selection():
    # n disjoint boxes, all kept: candidate j is tested against the j before it
    n = 12
    lo = np.arange(n, dtype=np.float32) / n
    boxes = np.stack([lo, lo, lo + 0.5 / n, lo + 0.5 / n], -1)[None]
    scores = np.linspace(1, 0.1, n, dtype=np.float32)[None]
    idx = np.arange(n, dtype=np.int32)[None]
    assert nms_kernel.greedy_iou_tests(boxes, scores, idx) == n * (n - 1) // 2
    with pytest.raises(ValueError):
        nms_kernel.greedy_iou_tests(boxes, scores, idx[:, ::-1].copy())


@pytest.mark.parametrize("P,K,fits", [
    (256, 100, True), (1, 1, True), (9468, 200, True), (8192, 8192, True),
    (16384, 5312, True), (16384, 5313, False), (9468, 9468, False)])
def test_nms_kept_list_fits_beside_the_keys(P, K, fits):
    """The wrapper's refusal: 8 B a key (P padded to a power of two) and 16 B
    a kept box within csrc/nms.cu's 211 KiB of shared memory."""
    assert nms_kernel.kept_list_fits(P, K) is fits


@pytest.mark.parametrize("P,K,route", [
    (256, 100, "shared"), (16384, 100, "shared"), (16384, 5312, "shared"),
    (16385, 100, "global"), (18936, 100, "global"), (40000, 200, "global"),
    (16384, 5313, "global"), (9468, 9468, "global"), (13504, 13504, "global"),
    (40000, 13504, "global"), (13505, 13505, None), (40000, 20000, None),
    (nms_kernel.MAX_P + 1, 100, None)],
    ids=lambda v: str(v))
def test_nms_route_at_the_boundaries(P, K, route):
    """The wrapper's route: the shared one while the keys (P padded to a
    power of two) and the kept list fit beside each other; else the
    global-keys route while the kept list alone fits (16 B a box in 211 KiB,
    13,504 boxes); else a refusal, as for more boxes than the kernel
    indexes."""
    if route is None:
        with pytest.raises(ValueError):
            nms_kernel.nms_route(P, K)
    else:
        assert nms_kernel.nms_route(P, K) == route


@pytest.mark.parametrize("n,tile", [(64, 64), (256, 64), (1024, 128), (4096, 256)])
def test_tiled_bitonic_sort_is_the_descending_order(n, tile):
    """The global-keys route's network (tiles sorted on their own, then the
    merges of larger strides over the whole sequence and the smaller ones
    tile by tile) sorts descending: random 64-bit keys with dead (0) ones
    and repeats, and the keys of real scores."""
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2**63, n, dtype=np.uint64) * np.uint64(2)
    keys[rng.random(n) < 0.2] = 0
    keys[: n // 8] = keys[n // 8: n // 4]
    np.testing.assert_array_equal(nms_kernel.tiled_bitonic_sort(keys, tile),
                                  np.sort(keys)[::-1])
    scores = rng.uniform(0, 1, n).astype(np.float32)
    order = nms_kernel._candidates(scores, 0.1)
    bits = (scores + np.float32(0)).view(np.uint32)
    live = ((bits | np.uint32(0x80000000)).astype(np.uint64) << np.uint64(32)) | \
        (~np.arange(n, dtype=np.uint32)).astype(np.uint64)
    live[scores < np.float32(0.1)] = 0
    got = nms_kernel.tiled_bitonic_sort(live, tile)
    assert [int(~np.uint32(k & np.uint64(0xFFFFFFFF))) for k in got[:len(order)]] == \
        order.tolist()


def test_plain_nms_at_the_flip_tta_candidate_count_is_the_jax_spec():
    """P = 18,936 (the SSD prior count twice, as flip TTA hands it over, the
    second half the first's boxes mirrored): the plain version, and the
    kernel's algorithm in numpy, exactly the JAX package's ``_nms_jnp``."""
    rng = np.random.default_rng(18936)
    half = random_nms_boxes(rng, 2, 9468)
    mirrored = np.stack([half[..., 0], 1 - half[..., 3], half[..., 2], 1 - half[..., 1]], -1)
    boxes = np.ascontiguousarray(np.concatenate([half, mirrored], axis=1))
    scores = rng.uniform(0, 1, (2, 18936)).astype(np.float32)
    got_idx, got_scores = nms_kernel.nms_batched_plain(
        torch.from_numpy(boxes), torch.from_numpy(scores), 100, 0.5, 0.05)
    _, ref_scores, ref_idx, ref_num = _jax_nms(100)(boxes, scores, np.float32(0.5),
                                                    np.float32(0.05))
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(got_scores.numpy(), np.asarray(ref_scores))
    np.testing.assert_array_equal((got_idx >= 0).sum(1).numpy(), np.asarray(ref_num))
    emu_idx, _, _ = nms_kernel.sorted_scan_emulation(boxes, scores, 100, 0.5, 0.05)
    np.testing.assert_array_equal(emu_idx, got_idx.numpy())
    assert nms_kernel.nms_route(18936, 100) == "global"


# ------------------------------------------------------------ B3: the plan

@pytest.mark.parametrize("a_shape,prior_shape", [
    ((32, 256, 4), (256, 4)),      # the detect and train batches
    ((32, 256, 4), (1, 256, 4)),
    ((32, 9468, 4), (9468, 4)),    # the SSD prior count
    ((2, 9468, 4), (1, 9468, 4)),
    ((1, 1, 4), (1, 4)),           # one box
    ((1, 4), (1, 4)),
    ((70000, 1, 4), (1, 4)),       # past the grid's y limit
    ((2, 3, 77, 4), (77, 4)),      # two leading dims
    ((3, 77, 4), (3, 77, 4)),      # priors of the same shape: one row
], ids=["main", "main_leading_1", "ssd", "ssd_leading_1", "one_box", "one_box_2d",
        "rows_past_y_limit", "two_leading_dims", "same_shape"])
def test_box_plan_covers_every_box_once(a_shape, prior_shape):
    a, pri = torch.zeros(a_shape), torch.zeros(prior_shape)
    plan = box_kernel._check(a, pri, "test")
    P = pri.numel() // 4
    assert plan.P == P and plan.rows * P == a.numel() // 4
    gx, gy = plan.grid
    # x: one thread a prior in blocks of 256 (csrc/box.cu), the last block's tail masked
    assert box_kernel.THREADS == 256
    assert (gx - 1) * box_kernel.THREADS < P <= gx * box_kernel.THREADS
    # y: the blocks y, y + gy, ... visit every row once
    assert 1 <= gy <= min(plan.rows, box_kernel.MAX_GRID_Y)
    visits = np.zeros(plan.rows, np.int64)
    for y in range(gy):
        visits[y::gy] += 1
    assert (visits == 1).all()


def test_box_plan_refuses_what_the_kernel_does_not_take():
    shifted = torch.zeros(2 * 8 * 4 + 1)[1:].view(2, 8, 4)  # 4 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        box_kernel._check(shifted, torch.zeros(8, 4), "decode")
    with pytest.raises(ValueError, match="16-byte"):
        box_kernel._check(torch.zeros(2, 8, 4), torch.zeros(33)[1:].view(8, 4), "decode")
    with pytest.raises(ValueError, match="broadcast"):
        box_kernel._check(torch.zeros(2, 8, 4), torch.zeros(7, 4), "decode")
    with pytest.raises(ValueError, match="rows"):
        box_kernel._plan(10, 4)


def test_threshold_test_without_division_is_the_rounded_quotients():
    """The kernel's ``inter > mid * u`` (or ``==`` with ``tie_up``) in double
    against float32 ``inter / u > thr``, at quotients within a few ulps of
    the threshold and at thresholds on the edges of the float32 range."""
    rng = np.random.default_rng(5)
    f32 = np.float32
    tiny = np.nextafter(f32(0), f32(1))
    for thr in (0.5, 0.3, 0.7, 0.9, 1.0, 0.0, -0.0, -0.25, float(tiny), 1e-30,
                float(np.finfo(np.float32).max), float("inf"), float("nan")):
        t = f32(thr)
        u = rng.uniform(1e-8, 2.0, 4000).astype(f32)
        if abs(thr) > 1e30:  # quotients near the largest float: u <= 1
            u = rng.uniform(0.25, 1.0, 4000).astype(f32)
        centre = (t * u).astype(f32) if np.isfinite(t) else rng.uniform(0, 1, 4000).astype(f32)
        inter = centre.copy()
        with np.errstate(over="ignore"):  # one ulp past the largest float
            for _ in range(3):  # up to 3 ulps either side, and the centre itself
                step = rng.integers(-1, 2, 4000)
                inter = np.where(step > 0, np.nextafter(inter, f32(np.inf)),
                                 np.where(step < 0, np.nextafter(inter, f32(0)), inter))
        inter = np.abs(inter).astype(f32)
        with np.errstate(over="ignore"):
            want = (inter / u) > t
        mid, tie_up = nms_kernel.threshold_split(thr)
        lhs, rhs = inter.astype(np.float64), mid * u.astype(np.float64)
        got = (lhs > rhs) | (tie_up & (lhs == rhs))
        np.testing.assert_array_equal(got, want, err_msg=f"thr={thr}")

"""The designs of the port's B2 (fused matmul) and B4 (greedy matching)
kernels, checked on the CPU where the kernels cannot run.

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
"""

import numpy as np
import pytest
from hypothesis import HealthCheck, example, given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp
import torch

from multibox_tpu.ops import matching as jm
from multibox_tpu.ops.pallas.fused_matmul import (
    fused_matmul_bias_relu as fused_matmul_pallas,
)
from multibox_tpu_torch.models.inception_v3 import fused_unit_shapes
from multibox_tpu_torch.ops import matching as tm
from multibox_tpu_torch.ops.kernels import fused_matmul, match_kernel
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

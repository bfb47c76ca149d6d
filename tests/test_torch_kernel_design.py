"""The designs of the port's B1 (NMS + top-k), B2 (fused matmul), B3 (box
decode/encode) and B4 (greedy matching) kernels, checked on the CPU where
the kernels cannot run.

- B2's route planner (``fused_matmul._plan``) over every shape the port's
  paths give it: the head's three layers at 32, 128 and 256 rows, every
  folded 1×1 unit at batch 32 (enumerated from the model), and the ragged
  cases; its slices partition K, its workspace matches its grid, the FC
  and Bottleneck shapes put enough blocks up, the wgmma route's shared
  memory fits and N past 256 takes two tiles; the persistent grid's walk
  covers every tile once.
- B2's arithmetic, emulated in plain PyTorch (each slice's partial product,
  then the reduction kernel's fixed order of sums, bias and ReLU), against
  the JAX Pallas kernel in interpret mode at the head's full shapes with
  ``chip_smoke.py``'s data, and against the plain version at 128 and 256
  rows. Tolerance rtol 1e-4 / atol 1e-4, the kernel's own against its
  plain version on the card.
- Why the f32 route keeps plain f32 products: TF32 rounding, emulated
  by rounding away 13 mantissa bits, misses that tolerance at K = 2048,
  where f32 and 3xTF32 keep it.
- B4's rounds (each row's running best, a rescan only for rows whose best
  column was just taken), written here in numpy, give exactly the
  assignments of the plain version and of the JAX package's
  ``greedy_match``, on tie-heavy cases drawn by hypothesis. So does the
  redesigned kernel's algorithm (``match_kernel.list_rounds_emulation``:
  each row's first min(n, P) cells per part of its columns, the parts'
  lists merged, head pointers moving past dead columns) over 1-8 ragged
  slices and 1-8 images a block, against the Pallas kernel in interpret
  mode too, on those cases and on all-equal IoUs; and ``match_plan`` fits
  every path's shape in shared memory and the card's SMs.
- B1's sorted scan (``nms_kernel.sorted_scan_emulation``: the kernel's keys
  with -0.0 made +0.0, the descending sort, the chunks tested against the
  kept list and against themselves, the in-order resolution, the cut at K)
  gives exactly the indices, scores and counts of the plain version, of the
  JAX package's ``_nms_jnp`` and of its Pallas kernel in interpret mode, on
  the card's edge cases and on tie-heavy grid boxes drawn by hypothesis;
  and so does it window by window (``nms_kernel.radix_select``: digit
  histograms, the floor, the refill below it), with windows small enough
  that the refill runs, at P = 9,468 with all-equal scores and scores
  inside one exponent. Each window is the next prefix of ``np.argsort``'s
  order.
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
from multibox_tpu.ops.pallas.match_kernel import greedy_match_pallas_batched
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
          (512, 2048, 384, BF16), (511, 6144, 1024, F32), (256, 64, 48, BF16),
          (129, 288, 448, BF16), (9248, 768, 448, BF16))
# the head's three layers at n images (an 8×8 grid, 256 priors)
HEAD_ROWS = tuple((f"{name}_rows{n}", M * n // 32 if name == "Bottleneck" else n, K, N)
                  for n in (32, 128, 256) for name, M, K, N, _ in HEAD)


@pytest.fixture(scope="module")
def folded_units():
    return fused_unit_shapes(32)


# ------------------------------------------------------------ B2: the plan

def wgmma_smem(plan, K):
    """The dynamic shared memory ``wgmma_bf16`` asks for: the ring, w's
    resident column tile, the output staging and the barriers' slack."""
    nb = plan.tile[1] // 64
    kblocks = -(-K // 64)
    return (fused_matmul.WG_SLACK + plan.stages * (16384 + (0 if plan.resident else nb * 8192))
            + (nb * kblocks * 8192 if plan.resident else 0) + 2 * nb * 8192)


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
    elif plan.route == "wgmma_bf16":
        # a persistent grid: at most one block an SM, none without work
        assert plan.grid == (min(mt * nt * S, fused_matmul.SMS), 1, 1)
        assert bm == 128 and bn % 64 == 0 and 64 <= bn <= 256 and bk == 64
        assert S == 1 or (L % 64 == 0 and mt * nt * S <= fused_matmul.SMS)
        assert 2 <= plan.stages <= fused_matmul.WG_MAX_STAGES
        assert wgmma_smem(plan, K) <= fused_matmul.SMEM_MAX
        assert not plan.resident or (nt == 1 and S == 1)
    else:
        assert plan.grid == (mt, nt, S)
    assert plan.blocks == plan.grid[0] * plan.grid[1] * plan.grid[2]
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
    assert plans["Bottleneck"].route == "f32_tile" and plans["Bottleneck"].blocks >= 128
    assert plans["Bottleneck"].tile[:2] == (128, 96)  # N = 96: no column wasted
    for name in ("Locations", "Confidences"):  # two blocks on each of 132 SMs
        assert plans[name].route == "skinny" and plans[name].blocks >= 264
        assert plans[name].split_k > 1


@pytest.mark.parametrize("name,M,K,N", HEAD_ROWS, ids=[h[0] for h in HEAD_ROWS])
def test_plan_puts_the_head_at_65_to_511_rows_on_the_f32_tile(name, M, K, N):
    """The batch-128 and batch-256 head: the new f32 route, split so that
    the 132 SMs have work (the first port's kernel ran 8 blocks at
    128×6144×256)."""
    plan = fused_matmul._plan(M, K, N, F32)
    check_plan(plan, M, K, N, F32)
    assert plan.route == ("skinny" if M <= 64 else "f32_tile")
    if plan.route == "f32_tile":
        assert plan.blocks >= fused_matmul.SMS - 4 or plan.split_k == 1


def test_plan_routes_every_folded_unit(folded_units):
    assert len(folded_units) == 40  # the folded Inception-v3's 1×1 stride-1 units
    assert {m for _, m, _, _ in folded_units} == {170528, 39200, 9248, 2048}  # batch 32
    for _, M, K, N in folded_units:
        plan = fused_matmul._plan(M, K, N, BF16)
        check_plan(plan, M, K, N, BF16)
        assert plan.route == "wgmma_bf16"
        assert plan.tile[1] == fused_matmul._wgmma_tile_n(M, N)
        # the 2,048-row units: 64-column tiles, no split; the others: the
        # whole width in one tile, w resident where it fits (K ≤ 288)
        if M == 2048:
            assert plan.tile[1] == 64 and plan.split_k == 1
        else:
            assert plan.tile[1] >= N and plan.resident == (K <= 288)


@pytest.mark.parametrize("M,K,N,dtype", RAGGED)
def test_plan_routes_the_ragged_cases(M, K, N, dtype):
    plan = fused_matmul._plan(M, K, N, dtype)
    check_plan(plan, M, K, N, dtype)
    if dtype == BF16:
        assert plan.route == ("wgmma_bf16" if K % 8 == 0 and N % 8 == 0 else "general")
    elif K % 4 or N % 4:
        assert plan.route == "general"
    else:
        assert plan.route == ("skinny" if M <= 64 else "f32_tile")


def test_plan_edges_and_refusals():
    # the skinny boundary; the old 511/512 edge is gone (both f32_tile);
    # unaligned operands and rows that are not 16 bytes go to general
    assert fused_matmul._plan(64, 256, 128, F32).route == "skinny"
    assert fused_matmul._plan(65, 256, 128, F32).route == "f32_tile"
    assert fused_matmul._plan(511, 6144, 1024, F32).route == "f32_tile"
    assert fused_matmul._plan(512, 6144, 1024, F32).route == "f32_tile"
    assert fused_matmul._plan(32, 6144, 1024, F32, aligned=False).route == "general"
    assert fused_matmul._plan(256, 6144, 2048, F32, aligned=False).route == "general"
    assert fused_matmul._plan(256, 6144, 2046, F32).route == "general"
    assert fused_matmul._plan(39200, 288, 64, BF16, aligned=False).route == "general"
    assert fused_matmul._plan(39200, 284, 64, BF16).route == "general"
    assert fused_matmul._plan(39200, 288, 64, BF16).split_k == 1
    small = fused_matmul._plan(512, 2048, 384, BF16)  # the 8×8 units at batch 8
    assert small.split_k > 1 and small.kslice % 64 == 0
    uneven = fused_matmul._plan(64, 1000, 200, F32)
    assert uneven.split_k * uneven.kslice != 1000  # a short last slice
    with pytest.raises(ValueError, match="too large"):
        fused_matmul._plan(2**31, 8, 8, F32)
    with pytest.raises(ValueError, match="too large"):
        fused_matmul._plan(128, 8, 8 * 65536 * 128, F32)


@pytest.mark.parametrize("N,tile", [(256, 256), (320, 192), (384, 192), (448, 256), (1000, 256)])
def test_plan_splits_n_past_256_into_wgmma_tiles(N, tile):
    """Up to N = 256 the whole width is one wgmma tile; past it the fewest
    tiles of at most 256 columns, in 64-column blocks (9,248 rows: enough
    row tiles for the whole width)."""
    plan = fused_matmul._plan(9248, 768, N, BF16)
    check_plan(plan, 9248, 768, N, BF16)
    assert plan.tile[1] == tile and -(-N // tile) == -(-N // 256)
    assert (N <= 256) == (-(-N // tile) == 1)


def covered_once(plan, M, N):
    """Every (row tile, column tile, slice) of ``plan``'s grid, walked as
    its kernel walks it: ``wgmma_bf16``'s persistent blocks take items
    ``blockIdx.x + i·grid[0]`` (row tile fastest), the other routes one
    item a block from ``blockIdx``. Returns the count per item and the
    items a block takes."""
    cdiv = fused_matmul._cdiv
    bm, bn, _ = plan.tile
    mt, nt, S = cdiv(M, bm), cdiv(N, bn), plan.split_k
    seen = np.zeros((mt, nt, S), np.int64)
    per_block = []
    if plan.route == "wgmma_bf16":
        items = mt * nt * S
        for block in range(plan.grid[0]):
            mine = range(block, items, plan.grid[0])
            per_block.append(len(mine))
            for item in mine:
                seen[item % mt, (item // mt) % nt, item // (mt * nt)] += 1
    else:
        for x in range(plan.grid[0]):
            for y in range(plan.grid[1]):
                for z in range(plan.grid[2]):
                    tm, tn = (y, x) if plan.route == "skinny" else (x, y)
                    seen[tm, tn, z] += 1
                    per_block.append(1)
    # the tiles cover the output's rows and columns once
    assert (mt - 1) * bm < M <= mt * bm and (nt - 1) * bn < N <= nt * bn
    return seen, per_block


def test_persistent_grid_covers_every_tile_once(folded_units):
    """The folded units' persistent walk (and the head's grids at 32, 128
    and 256 rows): each item exactly once, every block busy, the blocks'
    shares within one item of each other."""
    shapes = sorted({(M, K, N, BF16) for _, M, K, N in folded_units})
    shapes += [(M, K, N, F32) for _, M, K, N in HEAD_ROWS] + [r for r in RAGGED if r[3] == BF16]
    for M, K, N, dtype in shapes:
        plan = fused_matmul._plan(M, K, N, dtype)
        seen, per_block = covered_once(plan, M, N)
        assert (seen == 1).all(), (M, K, N, plan)
        assert min(per_block) >= 1 and max(per_block) - min(per_block) <= 1, (M, K, N)


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


def head_data(M, K, N, seed=7):
    """chip_smoke.py's matmul data: x = max(N(0, 1), 0), w = N(0, 1)/√K, b = N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(0, 1, (M, K)), 0).astype(np.float32)
    w = (rng.normal(0, 1, (K, N)) / np.sqrt(K)).astype(np.float32)
    b = rng.normal(0, 0.1, N).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("name,M,K,N,relu", HEAD, ids=[h[0] for h in HEAD])
def test_split_k_arithmetic_holds_the_tolerance_against_pallas(name, M, K, N, relu):
    x, w, b = head_data(M, K, N)
    want = np.asarray(fused_matmul_pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu))
    plan = fused_matmul._plan(M, K, N, F32)
    assert plan.split_k > 1
    got = split_k_emulation(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                            relu, plan)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    # a different split is a different order of the same sums
    again = split_k_emulation(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                              relu, fused_matmul.Plan("f32_tile", (0, 0, 0), 3, -(-K // 3),
                                                      (1, 1, 3), 1))
    np.testing.assert_allclose(again.numpy(), want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("M,K,N", [(128, 6144, 1024), (128, 6144, 256), (256, 6144, 2048)],
                         ids=["Locations_rows128", "Confidences_rows128", "coco_Locations_rows256"])
def test_f32_tile_split_sum_order_holds_the_tolerance_at_128_and_256_rows(M, K, N):
    """The f32 route's split at the head's batch-128 shapes and coco_dp's
    256-row Locations: each slice's partial product, then the reduction's
    fixed order, against the plain version within rtol 1e-4 / atol 1e-4
    (chip_smoke.py's tolerance; the card's FMAs sum each slice in yet
    another order), and within 2e-5 of float64."""
    x, w, b = (torch.from_numpy(a) for a in head_data(M, K, N, seed=M + N))
    plan = fused_matmul._plan(M, K, N, F32)
    assert plan.route == "f32_tile" and plan.split_k > 1
    got = split_k_emulation(x, w, b, False, plan)
    plain = fused_matmul.fused_matmul_plain(x, w, b, False)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-4, atol=1e-4)
    exact = x.double() @ w.double() + b.double()
    assert float((got.double() - exact).abs().max()) < 2e-5


def test_wgmma_split_sum_order_holds_the_bf16_tolerance():
    """The bf16 route's split (the 8×8 units at batch 8): f32 partial sums
    of bf16 products, the same reduction, one rounding to bf16 at the end,
    against the plain version within 2e-2 (chip_smoke.py's bf16
    tolerance); the output is the plain version's to 1 bf16 ulp."""
    M, K, N = 512, 2048, 384
    x, w, b = head_data(M, K, N, seed=3)
    xb, wb = torch.from_numpy(x).to(BF16), torch.from_numpy(w).to(BF16)
    plan = fused_matmul._plan(M, K, N, BF16)
    assert plan.route == "wgmma_bf16" and plan.split_k > 1
    got = split_k_emulation(xb.float(), wb.float(), torch.from_numpy(b), True, plan).to(BF16)
    plain = fused_matmul.fused_matmul_plain(xb, wb, torch.from_numpy(b), True)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), rtol=2e-2, atol=2e-2)
    assert float((got.float() - plain.float()).abs().max()) <= float(plain.float().abs().max()) / 128


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


# ------------------------------------------ B4: candidate lists and head pointers

_pallas_greedy = functools.partial(greedy_match_pallas_batched, interpret=True)

# (cluster, images a block) of the kernel's decompositions: a cluster of 1,
# 2, 3, 4, 8 blocks an image, and 2 or 8 images sharing a block's warps
LIST_PLANS = ((1, 1), (2, 1), (3, 1), (4, 1), (8, 1), (1, 2), (1, 8))


def check_lists(gt, num, pri, chunk, pallas=True):
    """csrc/match.cu's algorithm (``match_kernel.list_rounds_emulation``) on
    every decomposition of LIST_PLANS, exactly the plain version, the vmapped
    JAX ``greedy_match`` and (``pallas``) the Pallas kernel in interpret
    mode. Returns the head pointers' advances."""
    tg, tn, tp = torch.from_numpy(gt), torch.from_numpy(num), torch.from_numpy(pri)
    plain = match_kernel.greedy_match_plain(tg, tn, tp).numpy()
    np.testing.assert_array_equal(
        plain, np.asarray(_jax_greedy(jnp.asarray(gt), jnp.asarray(num), jnp.asarray(pri))))
    if pallas:
        np.testing.assert_array_equal(plain, np.asarray(_pallas_greedy(
            jnp.asarray(gt), jnp.asarray(num), jnp.asarray(pri))))
    advances = 0
    for cluster, images in LIST_PLANS:
        plan = match_kernel.MatchPlan(cluster, images, 32, 0)
        got, work = match_kernel.list_rounds_emulation(gt, num, pri, plan, chunk)
        np.testing.assert_array_equal(got, plain, err_msg=f"{plan} chunk {chunk}")
        assert work.rounds == int(np.minimum(np.clip(num, 0, gt.shape[1]), len(pri)).sum())
        assert (work.rounds > 0) <= work.batches <= work.rounds
        advances += work.advances
    return advances


@settings(max_examples=12, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(tie_heavy_worlds(), st.sampled_from([1, 2, 32]))
@example((np.zeros((3, 8, 4), np.float32), np.asarray([0, 8, 3], np.int32),
          np.zeros((5, 4), np.float32)), 1)  # all-zero IoU, num_gt 0, G > P
def test_candidate_lists_give_the_greedy_assignments(world, chunk):
    # chunks of 1 and 2 columns cut these few priors into ragged slices of
    # up to 8 blocks; 32 is the kernel's own chunk
    check_lists(*world, chunk)


@pytest.mark.parametrize("P", [100, 300])
def test_candidate_lists_over_ragged_slices_of_32_column_chunks(P):
    # the kernel's own chunks: P = 100 over 2 blocks is 64 + 36 columns, P =
    # 300 over 8 is 64, 64, 64, 64, 44 and three empty blocks
    rng = np.random.default_rng(P)
    gt = np.round(random_nms_boxes(rng, 3, 20) * 8) / 8  # grid boxes: equal IoUs
    pri = np.round(random_nms_boxes(rng, 1, P)[0] * 8) / 8
    gt[0, 3] = gt[0, 1]
    pri[7] = pri[40]
    num = np.asarray([20, 5, 0], np.int32)
    check_lists(gt.astype(np.float32), num, pri.astype(np.float32), 32, pallas=False)


def test_candidate_lists_on_all_equal_ious():
    # every prior the same box: a row's cells tie everywhere, so its list is
    # its first L columns, every round takes the lowest live column and every
    # other live row's head moves on
    rng = np.random.default_rng(11)
    gt = random_nms_boxes(rng, 2, 12)
    pri = np.repeat(random_nms_boxes(rng, 1, 1)[0], 40, axis=0)
    num = np.asarray([12, 7], np.int32)
    assert check_lists(gt, num, pri, 2) > 0
    got, work = match_kernel.list_rounds_emulation(
        gt, num, pri, match_kernel.MatchPlan(1, 1, 32, 0))
    assert sorted(got[0]) == list(range(12)) and sorted(got[1][:7]) == list(range(7))
    # every head on the same column: a batch assigns one row
    assert work.batches == work.rounds == 19


# (B, G, P) of every path: the train slice and a rank's half of it, SSD at
# 32 and at a rank's 16, MobileNet, coco_dp's widths, chip_smoke's cases
PATH_SHAPES = ((32, 16, 256), (16, 16, 256), (32, 16, 9468), (16, 16, 9468), (64, 16, 128),
               (8, 64, 512), (256, 64, 512), (2, 128, 9468), (4, 16, 40000), (4, 16, 1),
               (3, 24, 10), (600, 16, 256), (1, 128, 40000), (4, 128, 9468))


# clusters of 0-8 blocks an H100 of 132 SMs holds at once
# (cudaOccupancyMaxActiveClusters on the card: its GPCs' SMs do not divide
# by 4 or 8)
H100_CLUSTERS = (132, 132, 66, 39, 30, 22, 17, 15, 15)


@pytest.mark.parametrize("sms", [16, 66, 132])
@pytest.mark.parametrize("real", [False, True])
def test_match_plan_fits_the_card(sms, real):
    clusters = (tuple(c * sms // 132 for c in H100_CLUSTERS) if real
                else match_kernel.ideal_clusters(sms))
    for B, G, P in PATH_SHAPES:
        plan = match_kernel.match_plan(B, G, P, sms, clusters)
        assert plan.smem == match_kernel.match_smem(G, P, plan.cluster, plan.images, plan.tile)
        assert plan.smem <= match_kernel.SMEM_LIMIT < 227 * 1024, (B, G, P, plan)
        assert 1 <= plan.cluster <= 8 and plan.images in (1, 2, 4, 8)
        # a batch of clusters the card holds at once, one wave
        assert plan.cluster == 1 or (plan.images == 1 and B <= clusters[plan.cluster]
                                     and B * plan.cluster <= sms)
        assert 32 <= plan.tile <= match_kernel.MAX_TILE and plan.tile % 32 == 0
        # every block of a cluster fills a slice of at least its minimum,
        # and no larger cluster would both fit and keep it
        sl = match_kernel.slice_cols(P, plan.cluster)
        least = match_kernel.CLUSTER_MIN_COLS if G <= 32 else match_kernel.CLUSTER_MIN_COLS_LONG
        assert plan.cluster == 1 or sl >= least
        assert not any(B <= clusters[c] and match_kernel.slice_cols(P, c) >= least
                       for c in range(plan.cluster + 1, 9))
        if plan.images > 1:
            assert -(-B // (plan.images // 2)) > 2 * sms


def test_match_plan_on_an_h100():
    plan = functools.partial(match_kernel.match_plan, sms=132, clusters=H100_CLUSTERS)
    assert plan(32, 16, 256).cluster == 1 and plan(64, 16, 128).cluster == 1
    # SSD: 32 clusters of 4 would take two waves (30 fit), 16 of 8 too (15)
    assert plan(32, 16, 9468).cluster == 3 and plan(16, 16, 9468).cluster == 6
    assert plan(8, 16, 1024).cluster == 4  # slices of 256 columns
    assert plan(8, 64, 512).cluster == 8 and plan(2, 128, 9468).cluster == 8
    assert plan(600, 16, 256).images > 1  # past two blocks an SM: packed
    big = plan(1, 128, 40000)  # the largest lists beside many prior tiles
    assert big.cluster == 8 and -(-match_kernel.slice_cols(40000, 8) // big.tile) > 1
    assert big.smem <= match_kernel.SMEM_LIMIT
    # on a card that held any SMs as a cluster, 4 and 8
    ideal = functools.partial(match_kernel.match_plan, sms=132)
    assert ideal(32, 16, 9468).cluster == 4 and ideal(16, 16, 9468).cluster == 8
    with pytest.raises(ValueError, match="at most 128"):
        plan(2, 129, 256)


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


def check_sorted_scan(boxes, scores, K, iou, thr, pallas=False, window=None, window_max=None):
    """The emulation (on the wrapper's plan, or ``window`` keys at a time,
    each refill's four times the last up to ``window_max``) against the plain
    version and the JAX spec exactly; with ``pallas`` also against the
    Pallas kernel in interpret mode. Returns the work
    (``nms_kernel.ScanWork``)."""
    got_idx, got_scores, work = nms_kernel.sorted_scan_emulation(
        boxes, scores, K, iou, thr, window=window, window_max=window_max)
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
    return work


@pytest.mark.parametrize("case", nms_edge_cases(), ids=lambda c: c[0])
def test_sorted_scan_gives_the_spec_on_the_edge_cases(case):
    name, boxes, scores, K, iou, thr = case
    work = check_sorted_scan(boxes, scores, K, iou, thr, pallas=True)
    chunks = work.chunks
    if name == "dense_cluster":  # most candidates suppressed: every chunk runs
        assert chunks.min() == 2
    if name == "all_dead":
        assert chunks.max() == 0
    assert work.windows.tolist() == [1] * len(chunks) and work.passes.max() == 0  # staged whole


@pytest.mark.parametrize("case", nms_edge_cases(), ids=lambda c: c[0])
def test_windowed_scan_gives_the_spec_on_the_edge_cases(case):
    """The same cases window by window: a window of 16 keys (the kernel's
    are 64 or more, the algorithm is the same), so that the selection, its
    digit passes and the refill run on every edge (signed zeros, NaN and
    infinities, all equal, all dead, K past P)."""
    name, boxes, scores, K, iou, thr = case
    work = check_sorted_scan(boxes, scores, K, iou, thr, pallas=True, window=16)
    live = np.stack([nms_kernel.nms_keys(s, thr) != 0 for s in scores]).sum(1)
    assert (work.windows >= 1).all() and (work.passes >= 1).all()
    if name in ("k_equals_p", "k_above_p"):  # every live key is read: one window a 16
        assert (work.windows >= np.ceil(live / 16)).all()


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


@settings(max_examples=40, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(tie_heavy_nms_worlds(), st.sampled_from((2, 4, 16)))
def test_windowed_scan_gives_the_spec_on_tie_heavy_grid_boxes(world, window):
    """Tie-heavy scores (five levels, ±0.0) window by window, down to
    windows of 2 keys: the selection's index digits decide among equal
    scores, and the refill goes on from each floor."""
    check_sorted_scan(*world, window=window)


def brute_force_iou_tests(boxes, scores, sel_idx, K, iou, thr):
    """Greedy NMS's IoU tests, one pair at a time through the plain
    version's IoU: live candidates by (score descending, index ascending),
    each against the kept boxes in order up to the first above ``iou``.
    Returns the tests and the candidates visited."""
    tests = visited = 0
    for b in range(scores.shape[0]):
        live = [i for i in range(scores.shape[1])
                if scores[b, i] >= np.float32(thr) and scores[b, i] != -np.inf]
        kept = []
        for c in sorted(live, key=lambda i: (-float(scores[b, i]), i)):
            if len(kept) == K:
                break
            visited += 1
            for n, k in enumerate(kept):
                pair = torch.from_numpy(boxes[b, [k, c]])
                if float(box_ops.iou_pairwise(pair[0], pair[1])) > np.float32(iou):
                    tests += n + 1
                    break
            else:
                tests += len(kept)
                kept.append(c)
        assert kept == [i for i in sel_idx[b] if i >= 0]
    return tests, visited


@pytest.mark.parametrize("case", [c for c in nms_edge_cases()
                                  if c[0] in ("random", "signed_zeros", "nan_and_inf_thresholded",
                                              "dense_cluster", "k_equals_p", "p33")],
                         ids=lambda c: c[0])
def test_greedy_iou_tests_count_the_work_the_selection_needs(case):
    """``greedy_iou_tests``, the work ``chip_smoke.py``'s bound of B1 counts."""
    _, boxes, scores, K, iou, thr = case
    idx, _ = nms_kernel.nms_batched_plain(torch.from_numpy(boxes), torch.from_numpy(scores),
                                          K, iou, thr)
    want, _ = brute_force_iou_tests(boxes, scores, idx.numpy(), K, iou, thr)
    assert nms_kernel.greedy_iou_tests(boxes, scores, idx.numpy(), iou, thr) == want


@pytest.mark.parametrize("case", [c for c in nms_edge_cases()
                                  if c[0] in ("random", "signed_zeros", "nan_and_inf_thresholded",
                                              "dense_cluster", "k_equals_p", "all_dead")],
                         ids=lambda c: c[0])
def test_greedy_candidates_count_the_boxes_the_selection_reads(case):
    """``greedy_candidates``, the boxes ``chip_smoke.py``'s byte bound of
    B1 counts: the candidates greedy NMS visits, up to the K-th kept or
    every live one."""
    _, boxes, scores, K, iou, thr = case
    idx, _ = nms_kernel.nms_batched_plain(torch.from_numpy(boxes), torch.from_numpy(scores),
                                          K, iou, thr)
    _, want = brute_force_iou_tests(boxes, scores, idx.numpy(), K, iou, thr)
    assert nms_kernel.greedy_candidates(scores, idx.numpy(), thr) == want


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
    (256, 100, True), (1, 1, True), (1024, 1024, True), (1025, 100, True), (9468, 200, True),
    (9468, 9468, True), (18936, 100, True), (40000, 200, True), (40000, 11968, True),
    (40000, 11969, False), (20000, 20000, False), (nms_kernel.MAX_P, 200, True),
    (nms_kernel.MAX_P + 1, 200, False)], ids=lambda v: str(v))
def test_nms_fits_at_the_boundaries(P, K, fits):
    """The wrapper's one refusal: more boxes than the kernel indexes, or a
    kept list (16 B a box) that does not fit in csrc/nms.cu's 211 KiB of
    shared memory beside its window (24 B a key; 1,024 keys for K past 256:
    11,968 boxes); an image of at most 1,024 boxes is staged whole, kept
    list and all. :func:`nms_plan` raises where it does not fit, else plans
    the one kernel for every P: staged whole up to 1,024 boxes, else
    window by window, 1 to 8 blocks an image within half the SMs."""
    assert nms_kernel.nms_fits(P, K) is fits
    if fits:
        plan = nms_kernel.nms_plan(4, P, K, 132)
        if P <= nms_kernel.WHOLE:
            assert plan == nms_kernel.NmsPlan(0, 0, 1, False)
        else:
            assert plan.window == nms_kernel.window_for(K)
            assert 256 <= plan.window <= 1024 and plan.window >= min(2 * K, 1024)
            assert plan.window <= plan.window_max <= nms_kernel.MAX_WINDOW == 2048
            assert plan.window_max * 24 + min(K, P) * 16 <= nms_kernel.SMEM_LIMIT
            assert plan.window_max == 2048 or plan.window_max == plan.window or \
                2 * plan.window_max * 24 + min(K, P) * 16 > nms_kernel.SMEM_LIMIT
            assert 1 <= plan.cluster <= nms_kernel.MAX_CLUSTER
            assert 4 * plan.cluster <= 132 // 2
            assert plan.staged == nms_kernel.scores_staged(P, K, plan.window_max, plan.cluster)
    else:
        with pytest.raises(ValueError):
            nms_kernel.nms_plan(4, P, K, 132)


@pytest.mark.parametrize("sms,B,P,cluster", [
    (132, 4, 40000, 8), (132, 32, 18936, 2), (132, 8, 9468, 4), (132, 4, 4096, 1),
    (132, 8, 40000, 8), (114, 8, 40000, 4), (114, 32, 18936, 1), (16, 4, 40000, 2)],
    ids=lambda v: str(v))
def test_nms_plan_clusters_follow_the_cards_sms(sms, B, P, cluster):
    """The cluster an image: the largest of 1, 2, 4, 8 blocks that keeps B ×
    cluster within half the card's SMs (132 on an H100 SXM, 114 on an H100
    PCIe) and 2,048 keys a block, past 8,192 boxes."""
    assert nms_kernel.nms_plan(B, P, 100, sms).cluster == cluster


@pytest.mark.parametrize("B,P,K,staged", [
    (4, 9468, 200, True), (32, 18936, 100, True), (4, 40000, 200, True),
    (2, 9468, 9468, True), (1, 40000, 8000, True), (64, 50000, 100, False),
    (1, 40000, 11968, False), (1, 2 ** 20, 100, False)], ids=lambda v: str(v))
def test_scores_are_staged_where_they_fit(B, P, K, staged):
    """A block's slice of scores is staged when, 16 B more to align the
    bulk copies, it fits csrc/nms.cu's 211 KiB beside the window's room (24
    B a key) and the kept list (16 B a box), in at most 16 tiles of 16 KiB;
    else every pass reads it from global memory (64 images of 50,000 boxes,
    one block each; a kept list of 11,968 beside slices of 5,000)."""
    plan = nms_kernel.nms_plan(B, P, K, 132)
    slice_ = (-(-P // plan.cluster) + 3) // 4 * 4
    fits = plan.window_max * 24 + min(K, P) * 16 + (slice_ + 4) * 4 <= 227 * 1024 - 16 * 1024
    assert plan.window > 0 and plan.staged is staged
    assert staged == (fits and slice_ * 4 <= 16 * 16384)


def selection_keys(kind, n, rng):
    """One image's keys (``nms_kernel.nms_keys``) for the selection tests."""
    thr = float("-inf")
    if kind == "uniform":
        s = rng.uniform(0, 1, n)
    elif kind == "all_equal":
        s = np.full(n, 0.5)
    elif kind == "one_exponent":  # [0.5, 1): only the mantissa digits differ
        s = rng.uniform(0.5, 1, n)
    elif kind == "concentrated":  # what random weights give: every score near 0.5
        s = 0.5 + rng.normal(0, 1e-4, n)
    elif kind == "signed_zeros":
        s = rng.choice(np.array([0.0, -0.0, 0.25, -0.25]), n)
    elif kind == "nan_inf_dead":
        s = rng.uniform(-1, 1, n)
        s[::5], s[1::7], s[2::11] = np.nan, np.inf, -np.inf
        thr = 0.0
    else:  # "few_levels": long runs of equal scores
        s = rng.integers(0, 3, n) / 4
    return nms_kernel.nms_keys(np.asarray(s, np.float32), thr)


@pytest.mark.parametrize("cap", (64, 1024))
@pytest.mark.parametrize("kind", ("uniform", "all_equal", "one_exponent", "concentrated",
                                  "signed_zeros", "nan_inf_dead", "few_levels"))
def test_radix_select_windows_are_the_order_cut_in_prefixes(kind, cap):
    """Window after window below the last floor, as the kernel refills: each
    is exactly the next ``count`` keys of the descending order
    (``np.argsort``), at least half the window and at most all of it (all
    that is left when it is the last), and the windows together are every
    live key once. Equal scores cost passes over the index digits, never a
    wrong window."""
    rng = np.random.default_rng(cap)
    keys = selection_keys(kind, 9468, rng)
    order = np.sort(keys[keys != 0])[::-1]
    ceiling, taken, passes = nms_kernel.NO_CEILING, 0, []
    while True:
        win = nms_kernel.radix_select(keys, ceiling, cap)
        inside = keys[(keys >= np.uint64(win.floor)) & (keys < np.uint64(ceiling))]
        assert len(inside) == win.count
        np.testing.assert_array_equal(np.sort(inside)[::-1], order[taken:taken + win.count])
        taken += win.count
        passes.append(win.passes)
        if win.final:
            break
        assert cap // 2 <= win.count <= cap and win.floor > 1
        ceiling = win.floor
    assert taken == len(order) and win.count <= cap
    assert max(passes) <= 64 // nms_kernel.DIGIT_BITS
    if kind == "all_equal":  # one pass on the shared score, then the index digits
        assert passes[0] <= 3


def test_radix_select_on_no_live_key_and_on_one():
    keys = np.zeros(100, np.uint64)
    assert nms_kernel.radix_select(keys) == nms_kernel.Window(1, 0, 1, True)
    keys[37] = nms_kernel.nms_keys(np.full(100, 0.25, np.float32), 0.0)[37]
    assert nms_kernel.radix_select(keys, cap=64) == nms_kernel.Window(1, 1, 1, True)
    assert nms_kernel.radix_select(keys, ceiling=int(keys[37]), cap=64).count == 0


@pytest.mark.parametrize("kind", ("all_equal", "one_exponent"))
def test_windowed_scan_at_the_ssd_prior_count(kind):
    """P = 9,468 on the wrapper's windows (``nms_windows``: a first window
    of ``window_for(100)`` = 256 keys, each refill's four times the last up
    to 2,048): all-equal scores, where only the index digits tell the keys
    apart, and scores inside one float exponent; exactly the plain version,
    the JAX spec and the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(9468)
    boxes = random_nms_boxes(rng, 2, 9468)
    scores = (np.full((2, 9468), 0.5) if kind == "all_equal"
              else rng.uniform(0.5, 1.0, (2, 9468))).astype(np.float32)
    work = check_sorted_scan(boxes, scores, 100, 0.5, 0.0, pallas=True)
    assert (work.passes >= 2).all() and (work.windows >= 1).all()


@pytest.mark.parametrize("window_max", (64, 256))
def test_windowed_scan_refills_with_the_same_kept_list(window_max):
    """K large and windows small: the scan uses up window after window
    (at least three) and goes on below each floor with the boxes kept so
    far, on boxes where some are kept and many suppressed; with each
    refill's window four times the last within a room of 256 keys (64,
    256, 256, ...), or all of 64."""
    rng = np.random.default_rng(3)
    boxes = random_nms_boxes(rng, 2, 600, 0.02, 0.2)
    scores = rng.uniform(0, 1, (2, 600)).astype(np.float32)
    work = check_sorted_scan(boxes, scores, 400, 0.3, 0.05, pallas=True, window=64,
                             window_max=window_max)
    assert (work.windows >= 3).all()


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
    emu_idx, _, work = nms_kernel.sorted_scan_emulation(boxes, scores, 100, 0.5, 0.05)
    np.testing.assert_array_equal(emu_idx, got_idx.numpy())
    assert nms_kernel.nms_fits(18936, 100) and (work.passes >= 1).all()


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

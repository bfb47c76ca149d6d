"""CUDA kernel: greedy bipartite prior matching, batched.

Replaces ``greedy_match_pallas_batched`` / ``greedy_match_pallas`` of the
JAX package (``multibox_tpu/ops/pallas/match_kernel.py``). Semantics are
those of that package's ``ops.matching.greedy_match`` over the IoU benefit:
per image, rows ``>= num_gt`` are padding; each round the live (gt, prior)
cell of largest IoU (the first row-major cell among equal values) assigns
the gt to the prior, and the row and the column die. Output ``[B, G]``
int32, −1 for a gt never assigned. G ≤ 128.

Bound on this card: neither bytes (the priors, P·16 bytes, are shared by
the batch) nor the f32 rate, but issue and latency on the SMs an image
gets: the fill's n·P IoUs (some 50 instructions a cell with the division
and the key) and the selection of each row's best cells, then one warp's
assignment of min(num_gt, P) rows. At P = 256 and 128 a block waits a
quarter of its time for its prior tile (from device memory) and spends the
rest on the fill and one warp's assignment; at P = 9,468 the fill of the
image with the most rows sets the time.

The design keeps no benefit matrix: while a row is live fewer than n =
num_gt columns have died, so its live best is the first live cell of its
first L = min(n, P) cells in (IoU descending, column ascending) order. The
fill computes each IoU once, windows of columns at a time, and keeps per
row only those L cells (64-bit keys, sorted in shared memory; keys above
the L-th staged by ballots and merged in by counting). The rounds run in
batches: the live rows ranked by their heads, every row before the first
whose head column an earlier row holds assigned at once (what the rounds
one by one would assign), and a row whose head column died moves its
pointer on past dead columns instead of rescanning. The priors stream
through shared memory by bulk copies in tiles (any P, one route); where
images are few for the card, an image's columns are split over a
thread-block cluster of as many blocks as the card holds B clusters of at
once, and the blocks merge the rows' lists (:func:`match_plan`).
:func:`list_rounds_emulation` is the same algorithm step by step in numpy,
for the CPU tests. The TPU kernel's masked-min arg-max over the whole
benefit and its 8-row output tile answered that compiler's lack of dynamic
indexing and are not carried over.

:func:`greedy_match_plain` is the plain PyTorch version: the same IoU
arithmetic op for op, so assignments agree exactly, ties included.

Source: ``csrc/match.cu``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from multibox_tpu_torch.ops import kernels as K
from multibox_tpu_torch.ops import matching
from multibox_tpu_torch.ops.kernels.nms_kernel import sm_count

MAX_GT = 128
# csrc/match.cu's constants
WARPS = 16          # kThreads / 32
STAGES = 4          # prior tiles in flight
MAX_TILE = 4096     # columns a tile
MAX_CLUSTER = 8
MAX_IMAGES = 8      # images a block
HASH_SLOTS = 256    # dead columns of an image
WINDOW_WIDE, WINDOW_NARROW = 8, 4  # chunks a window: wide where a slice has 8
STAGE_BYTES = WARPS * 32 * 8  # every warp's 32 staged keys
SMEM_LIMIT = 227 * 1024 - 2 * 1024
# The plan's constants (scripts/torch_kernel_design.py, b4_sweep): the
# columns a block of a cluster fills at least, where lists hold at most 32
# keys (G <= 32: at P = 1,024 four blocks of 256 beat one; at P = 256 one
# block beat two of 128) and where they hold more (G = 64 P = 512: eight
# blocks of 64 columns beat fewer); prior columns a tile
CLUSTER_MIN_COLS = 256
CLUSTER_MIN_COLS_LONG = 64
TILE_COLS = 1024


class MatchPlan(NamedTuple):
    """A launch of csrc/match.cu: ``cluster`` blocks an image (a
    thread-block cluster when more than 1) or ``images`` a block, prior
    tiles of ``tile`` columns, ``smem`` bytes of shared memory a block."""
    cluster: int
    images: int
    tile: int
    smem: int


def rows_a_lane(G: int) -> int:
    """R: rows a lane holds in the rounds; a row's list holds 32 R keys."""
    return 1 if G <= 32 else 2 if G <= 64 else 4


def slice_cols(P: int, cluster: int, chunk: int = 32) -> int:
    """Columns of one block of an image's cluster: P / cluster rounded up
    to a chunk (32 columns, one a lane, in the kernel)."""
    return -(-(-(-P // cluster)) // chunk) * chunk


def match_smem(G: int, P: int, cluster: int, images: int, tile: int) -> int:
    """Shared memory of a block (csrc/match.cu ``mbx_greedy_match_smem``):
    the prior ring (at most :data:`STAGES` tiles of 16 B a column), every
    warp's staged keys, then per image its gt boxes, its lists (max(G,
    warps an image) of 32 R keys), its dead-column hash and the rounds'
    ranks (32 R keys and columns)."""
    tiles = -(-slice_cols(P, cluster) // tile)
    warps = WARPS // images
    image = (G * 16 + max(G, warps) * 32 * rows_a_lane(G) * 8 + HASH_SLOTS * 4
             + 32 * rows_a_lane(G) * 12)
    return min(tiles, STAGES) * tile * 16 + STAGE_BYTES + images * image


def ideal_clusters(sms: int) -> Tuple[int, ...]:
    """Clusters of c blocks (index c, 0-8) a card of ``sms`` SMs would hold
    at once if any SMs could form one: sms // c, a block an SM. A real card
    holds fewer (:func:`cluster_capacity`)."""
    return tuple(sms // max(c, 1) for c in range(MAX_CLUSTER + 1))


@functools.lru_cache(maxsize=None)
def _cluster_capacity(index: int) -> Tuple[int, ...]:
    lib = K.load_library()
    with torch.cuda.device(index):
        caps = [0, 0] + [lib.mbx_greedy_match_clusters(16, 9468, c, TILE_COLS)
                         for c in range(2, MAX_CLUSTER + 1)]
    caps[1] = torch.cuda.get_device_properties(index).multi_processor_count
    return tuple(caps)


def cluster_capacity(device) -> Tuple[int, ...]:
    """Clusters of c blocks (index c) the CUDA device ``device`` holds at
    once, read once a device (``mbx_greedy_match_clusters``,
    cudaOccupancyMaxActiveClusters): a cluster's blocks take SMs of one GPC,
    so on an H100 of 132 SMs 30 clusters of 4 fit, not 33, and 15 of 8. A
    block of the kernel takes an SM."""
    device = torch.device(device)
    return _cluster_capacity(torch.cuda.current_device() if device.index is None
                             else device.index)


@functools.lru_cache(maxsize=256)
def match_plan(B: int, G: int, P: int, sms: int,
               clusters: Tuple[int, ...] = None) -> MatchPlan:
    """The launch's plan on a card of ``sms`` SMs (``nms_kernel.sm_count``)
    that holds ``clusters[c]`` clusters of c blocks at once
    (:func:`cluster_capacity`; :func:`ideal_clusters` when not given). The
    cluster is the largest of 1-8 blocks an image that the card holds B of
    at once (a batch past that waits for a second wave, and takes twice as
    long) and that gives each block at least :data:`CLUSTER_MIN_COLS`
    columns (:data:`CLUSTER_MIN_COLS_LONG` where a row's list holds more
    than 32 keys, G > 32: those cost more to fill than to merge). Without a
    cluster, images are packed 2, 4 or 8 to a block while the batch alone
    would take more than two blocks an SM. The tile is :data:`TILE_COLS`
    columns, or the block's slice where that is less, halved while the
    shared memory does not fit (a block's lists take at most 137 KiB, at G =
    128). Raises ValueError for G > 128."""
    K.require(0 < G <= MAX_GT, "greedy_match: at most {} gt boxes, got {}", MAX_GT, G)
    if clusters is None:
        clusters = ideal_clusters(sms)
    min_cols = CLUSTER_MIN_COLS if G <= 32 else CLUSTER_MIN_COLS_LONG
    cluster = 1
    for c in range(2, MAX_CLUSTER + 1):
        if B <= clusters[c] and slice_cols(P, c) >= min_cols:
            cluster = c
    tile = max(32, min(TILE_COLS, slice_cols(P, cluster)))
    while tile > 32 and match_smem(G, P, cluster, 1, tile) > SMEM_LIMIT:
        tile //= 2
    images = 1
    while (cluster == 1 and 2 * images <= MAX_IMAGES and -(-B // images) > 2 * sms
           and match_smem(G, P, 1, 2 * images, tile) <= SMEM_LIMIT):
        images *= 2
    return MatchPlan(cluster, images, tile, match_smem(G, P, cluster, images, tile))


def device_plan(B: int, G: int, P: int, device) -> MatchPlan:
    """:func:`match_plan` on the CUDA device ``device``: its SMs and the
    clusters it holds at once."""
    return match_plan(B, G, P, sm_count(device), cluster_capacity(device))


# ------------------------------------------------------------- emulation

def cell_keys(benefit: np.ndarray) -> np.ndarray:
    """csrc/match.cu's keys of a ``[..., P]`` float32 IoU array: the value's
    bits + 1 (−0.0 made +0.0) above the complemented column, so that a larger
    key comes first in (value descending, column ascending)."""
    v = (np.asarray(benefit, np.float32) + np.float32(0)).view(np.uint32)
    cols = np.arange(benefit.shape[-1], dtype=np.uint32)
    return ((v.astype(np.uint64) + np.uint64(1)) << np.uint64(32)) | \
        (~cols).astype(np.uint64)


def top_keys(keys: np.ndarray, L: int) -> np.ndarray:
    """The first L keys of ``keys`` in descending order."""
    return np.sort(keys)[::-1][:L]


def part_columns(P: int, plan: MatchPlan, n: int, chunk: int = 32) -> list:
    """The column sets whose lists the kernel fills for a row of an image of
    n rows: block r of the cluster takes [r·slice, (r+1)·slice) (ragged at
    the end), cut into chunks dealt to S parts (chunk q to part q mod S):
    the image's warps over its rows, max(1, warps / n), but no more than the
    slice's windows of W chunks. The kernel's chunk is 32 columns; a smaller
    one gives small P several ragged slices."""
    sl = slice_cols(P, plan.cluster, chunk)
    chunks = sl // chunk
    window = WINDOW_WIDE if chunks >= WINDOW_WIDE else WINDOW_NARROW
    S = max(1, min((WARPS // plan.images) // max(n, 1), -(-chunks // window)))
    parts = []
    for r in range(plan.cluster):
        lo, hi = min(P, r * sl), min(P, (r + 1) * sl)
        cols = np.arange(lo, hi)
        q = (cols - lo) // chunk
        parts += [cols[q % S == s] for s in range(S)]
    return parts


class RoundsWork(NamedTuple):
    """What the emulation counted: the rounds (assignments), the batches
    they took, the list entries the head pointers moved past
    (``advances``), and the keys each row's lists passed on to the merge
    (``merged``)."""
    rounds: int
    batches: int
    advances: int
    merged: int


def _col(key) -> int:
    return int(~np.uint32(int(key) & 0xFFFFFFFF))


def list_rounds_emulation(gt: np.ndarray, num_gt: np.ndarray, priors: np.ndarray,
                          plan: MatchPlan, chunk: int = 32) -> Tuple[np.ndarray, RoundsWork]:
    """csrc/match.cu's algorithm in numpy: per image, each row's per-part
    lists of its first L = min(n, P) keys (:func:`part_columns`), merged
    into one sorted list of L, then the rounds in batches: the live rows in
    the order of their heads (value descending, row ascending), every row
    before the first whose head column a row before it holds assigned at
    once, and the heads on dead columns moved on. The IoUs are the plain
    version's, bit for bit. Returns ``[B, G]`` int32 and the work counted."""
    tg, tp = torch.from_numpy(np.asarray(gt, np.float32)), torch.from_numpy(
        np.asarray(priors, np.float32))
    benefit = matching.compute_benefit(tg, tp).numpy()
    B, G = gt.shape[:2]
    P = priors.shape[0]
    out = np.full((B, G), -1, np.int32)
    rounds = batches = advances = merged = 0
    for b in range(B):
        n = int(np.clip(num_gt[b], 0, G))
        L = min(n, P)
        if L == 0:
            continue
        keys = cell_keys(benefit[b, :n])
        parts = part_columns(P, plan, n, chunk)
        lists = []
        for i in range(n):
            pieces = [top_keys(keys[i, cols], L) for cols in parts]
            merged += sum(len(p) for p in pieces)
            lists.append(top_keys(np.concatenate(pieces), L))
        head = [0] * n
        live = [True] * n
        dead = set()
        done = 0
        while done < L:
            order = sorted((i for i in range(n) if live[i]),
                           key=lambda i: (-int(lists[i][head[i]] >> np.uint64(32)), i))
            seen = set()
            for i in order:
                j = _col(lists[i][head[i]])
                if j in seen:
                    break  # a row before it holds its column
                seen.add(j)
                out[b, i] = j
                live[i] = False
                done += 1
            dead |= seen
            batches += 1
            if done == L:
                break  # the heads are read again only by another batch
            for r in range(n):
                while live[r] and _col(lists[r][head[r]]) in dead:
                    head[r] += 1
                    advances += 1
                    if head[r] == L:
                        raise AssertionError(f"row {r}'s list of {L} ran out")
        rounds += done
    return out, RoundsWork(rounds, batches, advances, merged)


# ---------------------------------------------------------------- wrappers

def greedy_match_plain(gt_boxes: torch.Tensor, num_gt: torch.Tensor,
                       priors: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``greedy_match(compute_benefit(...))`` over
    the batch, ``[B, G, 4]``, ``[B]``, ``[P, 4]`` → ``[B, G]`` int32."""
    return matching.greedy_match(matching.compute_benefit(gt_boxes, priors), num_gt)


def _on_16_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a 16-byte boundary (a copy where a
    view starts off one): the kernel reads boxes as float4 and the priors by
    bulk copies."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def greedy_match_cuda(gt_boxes: torch.Tensor, num_gt: torch.Tensor,
                      priors: torch.Tensor) -> torch.Tensor:
    """Batched greedy IoU matching: ``gt_boxes [B, G, 4]`` f32, ``num_gt
    [B]`` int, shared ``priors [P, 4]`` f32 → ``[B, G]`` int32 (−1 =
    unassigned). On a CUDA tensor this launches the kernel on
    :func:`device_plan`'s plan (or raises); a CPU tensor takes
    :func:`greedy_match_plain`."""
    K.require(gt_boxes.dim() == 3 and gt_boxes.shape[-1] == 4
              and priors.dim() == 2 and priors.shape[-1] == 4
              and num_gt.shape == gt_boxes.shape[:1],
              f"greedy_match: gt [B, G, 4], num_gt [B], priors [P, 4] expected, "
              f"got {tuple(gt_boxes.shape)}, {tuple(num_gt.shape)}, "
              f"{tuple(priors.shape)}")
    K.require(gt_boxes.device == priors.device == num_gt.device,
              f"greedy_match: tensors on {gt_boxes.device}, {num_gt.device}, "
              f"{priors.device}")
    if not gt_boxes.is_cuda:
        return greedy_match_plain(gt_boxes, num_gt, priors)
    B, G = gt_boxes.shape[:2]
    P = priors.shape[0]
    K.require(G <= MAX_GT, f"greedy_match: at most {MAX_GT} gt boxes, got {G}")
    K.require(gt_boxes.dtype == torch.float32 and priors.dtype == torch.float32,
              f"greedy_match: float32 boxes only, got {gt_boxes.dtype} / "
              f"{priors.dtype}")
    K.require(P < 2**31 // max(G, 1), "greedy_match: too many priors")
    out = torch.empty((B, G), dtype=torch.int32, device=gt_boxes.device)
    if B > 0 and G > 0:
        plan = device_plan(B, G, P, gt_boxes.device)
        gt_boxes, priors = _on_16_bytes(gt_boxes), _on_16_bytes(priors)
        num_gt = num_gt.to(torch.int32).contiguous()
        err = K.load_library().mbx_greedy_match(
            gt_boxes.data_ptr(), num_gt.data_ptr(), priors.data_ptr(), out.data_ptr(),
            B, G, P, plan.cluster, plan.images, plan.tile, K.current_stream_ptr())
        K.check_launch(err, "mbx_greedy_match")
        K.LAUNCHES["match"] += 1
    return out

"""The arithmetic of the ball-query kernels' scheme (K10, K11:
``csrc/ball_tile.cuh``) on the CPU, and their plan rule.

The kernels cut a cloud into ``split`` parts of whole 256-point tiles; a
warp sweeps its part 32 points at a time, keeps its center's hit count and
first k hits, and stops at the group where the k-th hit falls; the parts
are merged in index order by a prefix of their counts, the slots past the
hits padded with the first hit, and a center with no hit at all gets a
second pass for its nearest point (per lane the first strict minimum, then
the least (d², index) over the lanes).  ``split_ball_query`` below does
exactly that in numpy, and must match ``ref.ball_query_ref`` and the JAX
package's Pallas kernel in interpret mode exactly: index outputs admit no
tolerance (``repro/pointcloud/ref.py``).

``ball_plan`` and ``ball_plan_legal`` are tested against the kernels' own
limits, and the rule's picks at the swept shapes are pinned
(``chip_smoke.ball_sweep_phase`` measured them; PERF.md).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.pointcloud import kernels as jax_pck
from repro_torch.kernels import pipeline
from repro_torch.pointcloud import ref

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


def _cloud(kind: str, B: int, N: int, M: int, seed: int = 0):
    """(xyz, centers, radius) in fp32 numpy: ``normal`` (centers some of
    the points, r 0.9), ``lattice`` (integer points in [0, 6)³, many d²
    exactly on r² = 1) or ``empty`` (centers three times wider than the
    cloud, r 0.3: many empty balls)."""
    rng = np.random.default_rng(seed)
    if kind == "lattice":
        xyz = rng.integers(0, 6, size=(B, N, 3)).astype(np.float32)
        return xyz, xyz[:, rng.permutation(N)[:M] if M <= N else
                        rng.integers(0, N, M)], 1.0
    xyz = rng.normal(size=(B, N, 3)).astype(np.float32)
    if kind == "empty":
        return xyz, 3.0 * rng.normal(size=(B, M, 3)).astype(np.float32), 0.3
    return xyz, xyz[:, rng.integers(0, N, M)], 0.9


def _part_sweep(hit: np.ndarray, k: int):
    """One warp over one part: (count, first-k hits) as the kernel leaves
    them -- 32 points a group, stopping before the first group that starts
    with k or more hits, so a count of k or more may overshoot k."""
    count, first = 0, []
    for g in range(0, hit.size, 32):
        if count >= k:
            break
        idx = np.flatnonzero(hit[g:g + 32]) + g
        first.extend(idx[:max(0, k - count)].tolist())
        count += idx.size
    return count, first


def _nearest(d2: np.ndarray) -> int:
    """The empty ball's pass: lane l keeps its first strict minimum over
    points l, l + 32, ...; the warp takes the least (d², index)."""
    best = []
    for lane in range(32):
        b, i = np.inf, 0
        for j in range(lane, d2.size, 32):
            if d2[j] < b:
                b, i = d2[j], j
        best.append((b, i))
    return min(best)[1]


def split_ball_query(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
                     k: int, split: int, radius_sq: float | None = None):
    """The kernels' scheme in numpy: (B, M, k) int32."""
    d2 = ref.sqdist(centers[:, :, None, :], xyz[:, None, :, :]).numpy()
    B, M, N = d2.shape
    r2 = np.float32(ref.squared_radius(radius, radius_sq))
    per = pipeline.ball_part_points(N, split)
    out = np.empty((B, M, k), dtype=np.int32)
    for b in range(B):
        for m in range(M):
            counts, lists = [], []
            for p in range(split):
                lo, hi = min(N, p * per), min(N, (p + 1) * per)
                count, first = _part_sweep(d2[b, m, lo:hi] <= r2, k)
                counts.append(count)
                lists.append([lo + i for i in first])
            prefix = np.concatenate([[0], np.cumsum(counts)])
            some = [p for p in range(split) if counts[p] > 0]
            pad = lists[some[0]][0] if some else _nearest(d2[b, m])
            row = [pad] * k
            for s in range(min(k, int(prefix[-1]))):
                p = next(p for p in range(split)
                         if prefix[p] <= s < prefix[p] + counts[p])
                row[s] = lists[p][s - prefix[p]]
            out[b, m] = row
    return torch.from_numpy(out)


# B, N, M, k: N and M off every tile and block; k above 32 and above the
# hits; a cloud of one tile and of a part a tile
SHAPES = [(2, 600, 12, 16), (1, 777, 13, 40), (2, 1030, 9, 64),
          (1, 200, 5, 4), (1, 2100, 7, 33)]


@pytest.mark.parametrize("split", pipeline.BALL_SPLITS)
@pytest.mark.parametrize("kind", ["normal", "lattice", "empty"])
@pytest.mark.parametrize("B,N,M,k", SHAPES)
def test_split_scheme_matches_the_plain_version(B, N, M, k, kind, split):
    if split > -(-N // pipeline.BALL_TILE):
        split = -(-N // pipeline.BALL_TILE)   # no more parts than tiles
    xyz, centers, radius = _cloud(kind, B, N, M)
    x, c = torch.from_numpy(xyz), torch.from_numpy(centers)
    want = ref.ball_query_ref(x, c, radius, k)
    assert torch.equal(split_ball_query(x, c, radius, k, split), want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["normal", "lattice", "empty"])
def test_split_scheme_matches_pallas_interpret(kind, dtype):
    """N = 600 (off the 256-point tiles, three parts of 256, 256 and 88 at
    split 4 -- the fourth empty), M = 12, k = 40 above every ball's hits;
    the Pallas kernel tiles it 4 x 200."""
    B, N, M, k = 2, 600, 12, 40
    xyz, centers, radius = _cloud(kind, B, N, M, seed=3)
    tdt, jdt = DTYPES[dtype]
    x = torch.from_numpy(xyz).to(tdt)
    c = torch.from_numpy(centers).to(tdt)
    r2 = ref.squared_radius(radius)
    want = np.asarray(jax_pck.ball_query(
        jnp.asarray(x.float().numpy(), jdt), jnp.asarray(c.float().numpy(), jdt),
        radius, k, block_m=4, block_n=200, interpret=True, radius_sq=r2))
    for split in (1, 2, 4):
        got = split_ball_query(x, c, radius, k, split, radius_sq=r2)
        np.testing.assert_array_equal(got.numpy(), want)


def test_part_sweep_stops_at_the_group_of_the_kth_hit():
    hit = np.zeros(100, dtype=bool)
    hit[[3, 5, 40, 41, 42, 90]] = True
    assert _part_sweep(hit, 2) == (2, [3, 5])
    assert _part_sweep(hit, 3) == (5, [3, 5, 40])   # the group overshoots
    assert _part_sweep(hit, 10) == (6, [3, 5, 40, 41, 42, 90])


def test_nearest_is_the_first_occurrence_of_the_least():
    d2 = np.array([5.0, 2.0, 7.0] * 30 + [2.0, 1.0, 1.0], dtype=np.float32)
    assert _nearest(d2) == 91
    assert _nearest(np.full(70, np.inf, dtype=np.float32)) == 0
    assert _nearest(np.full(70, 3.0, dtype=np.float32)) == 0


# ---------------------------------------------------------------------------
# The plan rule
# ---------------------------------------------------------------------------

#: The shapes the sweep measured: (a), (b), a cloud larger than K10's
#: shared memory, and (a)'s cloud with empty balls.
SWEPT = {"a": (2, 4096, 512, 16), "b": (16, 1024, 512, 32),
         "large": (1, 65536, 1024, 32), "empty": (2, 4096, 512, 16)}


def test_ball_part_points_are_whole_tiles():
    assert pipeline.ball_part_points(4096, 8) == 512
    assert pipeline.ball_part_points(1000, 4) == 256
    assert pipeline.ball_part_points(600, 4) == 256
    assert pipeline.ball_part_points(5, 1) == 256


@pytest.mark.parametrize("plan,shape,legal", [
    ((4, 8, 8, 0), (2, 4096, 512, 16), True),
    ((4, 8, 8, 4), (2, 4096, 512, 16), True),
    ((8, 2, 1, 2), (1, 5, 3, 4), True),
    ((3, 8, 1, 0), (2, 4096, 512, 16), False),    # 3 centers a warp
    ((4, 16, 1, 0), (2, 4096, 512, 16), False),   # 16 warps
    ((4, 8, 16, 0), (1, 65536, 64, 16), False),   # a cluster of 16
    ((4, 8, 8, 0), (16, 1024, 512, 32), False),   # more parts than tiles
    ((4, 8, 1, 5), (2, 4096, 512, 16), False),    # ring of 5
    ((8, 8, 2, 0), (1, 4096, 64, 1000), False),   # 64 lists of 1000 hits
    ((8, 8, 1, 0), (1, 4096, 64, 100000), True),  # unsplit: hits in `out`
    ((4, 8, 1, 0), (65536, 256, 8, 4), False),    # B past the grid's y
])
def test_ball_plan_legal_is_what_the_kernels_take(plan, shape, legal):
    assert pipeline.ball_plan_legal(plan, *shape, 4) is legal


def test_ball_smem_bytes_is_the_kernels_layout():
    # K10: 512 fp32 points (a part of (a) split 8) and an inbox of 4
    # centers x 8 parts x (count + 16)
    assert pipeline.ball_smem_bytes((4, 8, 8, 0), 4096, 16, 4) == \
        12 * 512 + 4 * 4 * 8 * 17
    # at most 4096 points at once; no lists without a split
    assert pipeline.ball_smem_bytes((4, 8, 1, 0), 65536, 32, 2) == 12 * 4096
    # K11: slots of 256 points + a 16-byte lead, rounded to 16, + barriers
    assert pipeline.ball_smem_bytes((2, 4, 1, 3), 4096, 16, 4) == 3 * 3088 + 32
    assert pipeline.ball_smem_bytes((2, 4, 1, 3), 4096, 16, 2) == 3 * 1552 + 32
    # 2 centers over 4 parts: an inbox of one center a block, 4 parts
    assert pipeline.ball_smem_bytes((1, 2, 4, 2), 4096, 8, 4) == \
        2 * 3088 + 32 + 4 * 1 * 4 * 9


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("depth", [0, *pipeline.DEPTHS])
@pytest.mark.parametrize("B,N,M,k", [*SWEPT.values(), (1, 5, 3, 4),
                                     (3, 777, 40, 64), (1, 1000, 13, 16),
                                     (4, 300000, 16, 8), (1, 4096, 64, 5000)])
def test_ball_plan_is_legal(B, N, M, k, depth, itemsize):
    plan = pipeline.ball_plan(B, N, M, k, itemsize, depth)
    assert plan[3] == depth
    assert pipeline.ball_plan_legal(plan, B, N, M, k, itemsize)
    assert plan in pipeline.ball_plans(B, N, M, k, itemsize, depth)


@pytest.mark.parametrize("name,depth,want", [
    ("a", 0, (1, 8, 2, 0)), ("a", 4, (4, 4, 8, 4)),
    ("b", 0, (2, 8, 1, 0)), ("b", 4, (4, 4, 1, 4)),
    ("large", 0, (2, 8, 8, 0)), ("large", 4, (4, 4, 8, 4)),
    ("empty", 0, (1, 8, 2, 0)), ("empty", 4, (4, 4, 8, 4)),
])
def test_ball_plan_picks_what_the_sweep_measured(name, depth, want):
    assert pipeline.ball_plan(*SWEPT[name], 4, depth) == want

"""The arithmetic of the grouped-aggregation kernels' schemes (K12, K13:
``csrc/group_aggregate.cu``, ``csrc/group_aggregate_pipelined.cu``) on the
CPU, and their plan rule.

K13 copies a slice of ``cs`` channels of a cloud's feature rows whole into
shared memory, in tiles of ``bn`` rows, one slot a tile; the cloud's
centers are split over ``split`` blocks of a cluster, each of which copies
1/split of every tile's rows into every block.  The slots hold the slice
in row order, and each center folds its k (clamped) neighbour rows, padded
to a multiple of 4 by repeats of its first, in one pass.  The maxima stay
in the features' type.
``tiled_group_aggregate`` below does exactly that in plain torch, and must
match ``ref.group_aggregate_ref`` exactly, and where the reference's Pallas
kernels are defined (indices in range, finite features; their one-hot
matmul lets a NaN into every row of its tile) the JAX package's
``group_aggregate`` and ``group_aggregate_pipelined`` in interpret mode:
the max-pool only selects values.

K12 gives a center 32 / cpw lanes, P of them a row; load i of a lane reads
entry rs + R i of the center's list (R = 32 / (cpw P) rows a warp load)
and takes its index from register i // P of lane rs + R (i % P), where
that lane loaded entry li + (32 / cpw) q.
``test_k12_lanes_cover_each_entry_once`` checks the mapping.

``group_plan`` and ``group_plan_legal`` are tested against the kernels'
own limits, and the rule's picks at the swept shapes are pinned
(``chip_smoke.group_sweep_phase`` measured them; PERF.md).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.pointcloud import kernels as jax_pck
from repro.pointcloud import ref as jax_ref
from repro_torch.kernels import pipeline
from repro_torch.pointcloud import kernels as pck
from repro_torch.pointcloud import ops as pc_ops
from repro_torch.pointcloud import ref

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


def _pool_max(acc: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """group::max16: max.NaN element by element, in the features' type (a
    NaN wins and stays)."""
    return torch.where((v > acc) | torch.isnan(v), v, acc)


def tiled_group_aggregate(features: torch.Tensor, idx: torch.Tensor,
                          bn: int, cs: int, split: int,
                          writes: list | None = None) -> torch.Tensor:
    """K13's scheme in plain torch: features (B, N, C), idx (B, M, k) →
    (B, M, C).  Each (cloud, slice, rank) is one block.  Its slots are
    filled by the cluster's copies: rank r's 2-D box of bn / split rows of
    tile t lands at slot row t bn + r bn / split of every block, rows past
    the features' last zero-filled as a TMA box fills them; ``writes``, if
    given, gets each block's count of copies into each of its slot
    rows."""
    B, N, C = features.shape
    M, k = idx.shape[1], idx.shape[2]
    rows = ref.neighbour_rows(idx, N).tolist()
    nt, mb, part, kq = -(-N // bn), -(-M // split), bn // split, -(-k // 4)
    flat = features.reshape(B * N, C)
    out = torch.empty((B, M, C), dtype=features.dtype)
    for b in range(B):
        for s0 in range(0, C, cs):
            for rank in range(split):
                slots = torch.empty((nt * bn, cs), dtype=features.dtype)
                count = [0] * (nt * bn)
                for t in range(nt):
                    for r in range(split):   # every rank's multicast
                        for j in range(t * bn + r * part,
                                       t * bn + (r + 1) * part):
                            g = b * N + j
                            slots[j] = (flat[g, s0:s0 + cs] if g < B * N
                                        else 0)
                            count[j] += 1
                centers = range(rank * mb, min(M, (rank + 1) * mb))
                acc = torch.full((len(centers), cs), -torch.inf,
                                 dtype=features.dtype)
                for i, m in enumerate(centers):
                    entries = rows[b][m] + [rows[b][m][0]] * (4 * kq - k)
                    for r in entries:
                        acc[i] = _pool_max(acc[i], slots[r])
                out[b, rank * mb:rank * mb + len(centers), s0:s0 + cs] = acc
                if writes is not None:
                    writes.append(count)
    return out


def _features(B, N, C, dtype, seed=0, nan=False):
    f = np.random.default_rng(seed).normal(size=(B, N, C)).astype(np.float32)
    if nan:
        f[0, 3, 1] = f[-1, N - 1, C - 1] = np.nan
    return torch.from_numpy(f).to(DTYPES[dtype][0])


def _ball_lists(B, N, M, k, seed=0):
    """Ball query's indices on a normal cloud: ascending hits padded with
    the first (r 0.9, so some lists are short and padded)."""
    rng = np.random.default_rng(seed)
    xyz = torch.from_numpy(rng.normal(size=(B, N, 3)).astype(np.float32))
    return ref.ball_query_ref(xyz, xyz[:, rng.integers(0, N, M)], 0.9, k)


def _indices(kind, B, N, M, k, seed=0):
    """idx (B, M, k) int32 of one kind: ``ball`` (ball query's order),
    ``random`` (any order, repeats), ``repeated`` (a few rows named many
    times, unsorted), ``stray`` (negative and past-the-end indices)."""
    rng = np.random.default_rng(seed)
    if kind == "ball":
        return _ball_lists(B, N, M, k, seed)
    if kind == "random":
        a = rng.integers(0, N, size=(B, M, k))
    elif kind == "repeated":
        a = rng.choice([0, 5, N // 2, N - 1], size=(B, M, k))
    else:
        a = rng.integers(-2 * N, 2 * N, size=(B, M, k))
    return torch.from_numpy(a.astype(np.int32))


# (B, N, M, k): tiles of 64 rows split neighbour lists across 4-5 tiles;
# k of 13 and 40 is no multiple of any tile; N 300 leaves a ragged tile
SHAPES = [(2, 256, 16, 8), (2, 256, 16, 40), (1, 300, 12, 13)]
# (bn, cs, split)
PLANS = [(64, 8, 1), (64, 4, 2), (128, 16, 4), (256, 32, 8), (64, 32, 8)]


@pytest.mark.parametrize("bn,cs,split", PLANS)
@pytest.mark.parametrize("kind", ["ball", "random", "repeated", "stray"])
@pytest.mark.parametrize("B,N,M,k", SHAPES)
def test_tiled_scheme_matches_the_plain_version(B, N, M, k, kind, bn, cs,
                                                split):
    feats = _features(B, N, 32, "float32")
    idx = _indices(kind, B, N, M, k)
    want = ref.group_aggregate_ref(feats, idx)
    got = tiled_group_aggregate(feats, idx, bn, cs, split)
    assert torch.equal(got, want)
    jf, ji = jnp.asarray(feats.numpy()), jnp.asarray(idx.numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_ref.group_aggregate_ref(jf, ji)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("kind", ["ball", "random", "repeated"])
def test_tiled_scheme_matches_pallas_interpret(kind, dtype):
    """Every dtype, exactly, against both Pallas kernels: the tiles the
    Pallas kernels stream (64 rows, 4 of them) are K13's tiles."""
    Bc, Nc, Mc, kc, Cc = 2, 256, 16, 24, 32
    feats = _features(Bc, Nc, Cc, dtype)
    idx = _indices(kind, Bc, Nc, Mc, kc)
    for split in (1, 2):
        got = tiled_group_aggregate(feats, idx, 64, 16, split)
        assert torch.equal(got, ref.group_aggregate_ref(feats, idx))
    jf = jnp.asarray(feats.float().numpy()).astype(DTYPES[dtype][1])
    ji = jnp.asarray(idx.numpy())
    for pallas in (jax_pck.group_aggregate(jf, ji, block_n=64,
                                           interpret=True),
                   jax_pck.group_aggregate_pipelined(jf, ji, block_n=64,
                                                     depth=3,
                                                     interpret=True)):
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(pallas.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_tiled_scheme_lets_a_nan_win(dtype):
    """A NaN feature wins every max it enters, as jnp.max and torch.amax
    take it, and stays out of the others."""
    feats = _features(2, 256, 32, dtype, nan=True)
    for kind in ("ball", "random"):
        idx = _indices(kind, 2, 256, 16, 24)
        idx[0, 0, 5] = 3
        got = tiled_group_aggregate(feats, idx, 64, 8, 2)
        want = ref.group_aggregate_ref(feats, idx)
        assert torch.isnan(got[0, 0, 1])
        np.testing.assert_array_equal(got.float().numpy(),
                                      want.float().numpy())
        ji = jnp.asarray(idx.numpy())
        jf = jnp.asarray(feats.float().numpy()).astype(DTYPES[dtype][1])
        np.testing.assert_array_equal(
            got.float().numpy(),
            np.asarray(jax_ref.group_aggregate_ref(jf, ji)
                       .astype(jnp.float32)))


@pytest.mark.parametrize("bn,split", [(64, 1), (64, 8), (128, 4), (256, 2)])
def test_tiled_scheme_copies_each_row_once(bn, split):
    """The split's copies (a box of bn / split rows a rank, multicast)
    write every slot row of every block exactly once, the ragged last tile
    included."""
    writes = []
    tiled_group_aggregate(_features(2, 300, 32, "float32"),
                          _indices("stray", 2, 300, 16, 24), bn, 32, split,
                          writes)
    assert writes == [[1] * (-(-300 // bn) * bn)] * (2 * split)


@pytest.mark.parametrize("P", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("cpw", pipeline.GROUP_CPW)
def test_k12_lanes_cover_each_entry_once(cpw, P):
    """For every lane of a center, load i reads entry rs + R i of the
    chunk, found in register i // P of lane rs + R (i % P); over the R
    row slots the loads cover the chunk's R · kLoads entries once each."""
    W = 32 // cpw
    if P > W:
        return
    R, loads = W // P, pipeline.GROUP_LOADS
    nq = -(-loads // P)
    held = {li + W * q: (li, q) for li in range(W) for q in range(nq)}
    seen = []
    for rs in range(R):
        for i in range(loads):
            e = rs + R * i
            assert held[e] == (rs + R * (i % P), i // P)
            seen.append(e)
    assert sorted(seen) == list(range(R * loads))


@pytest.mark.parametrize("C,itemsize,want", [
    (64, 4, 16), (64, 2, 8), (128, 4, 32), (256, 4, 32), (4, 4, 1),
    (8, 4, 2), (6, 4, 8), (3, 4, 4), (100, 2, 32), (12, 4, 4)])
def test_group_lanes(C, itemsize, want):
    assert pipeline.group_lanes(C, itemsize) == want


@pytest.mark.parametrize("plan,shape,itemsize,legal", [
    ((256, 32, 4, 4), (16, 1024, 512, 32, 64), 4, True),
    ((256, 32, 4, 3), (16, 1024, 512, 32, 64), 4, False),   # fewer slots
    ((256, 32, 1, 3), (16, 1024, 512, 32, 64), 4, False),   # fewer slots
    ((256, 32, 1, 4), (16, 1024, 512, 32, 64), 4, False),   # 512 centers
    ((256, 64, 4, 4), (16, 1024, 512, 32, 64), 4, False),   # 256-byte rows
    ((256, 64, 4, 4), (16, 1024, 512, 32, 64), 2, True),
    ((256, 6, 1, 1), (1, 100, 8, 4, 6), 4, False),          # 24-byte rows
    ((64, 8, 8, 16), (1, 1024, 64, 8, 8), 4, True),
    ((64, 8, 16, 16), (1, 1024, 64, 8, 8), 4, False),       # cluster of 16
    ((128, 8, 8, 8), (1, 1024, 64, 8, 8), 4, True),
    ((64, 4, 8, 16), (1, 1024, 64, 8, 8), 4, True),
    ((256, 8, 1, 1), (1, 100, 8, 4, 8), 4, False),          # tile > cloud
    ((64, 8, 1, 3), (1, 100, 8, 4, 8), 4, False),           # more slots
    ((64, 8, 1, 2), (1, 100, 8, 4, 8), 4, True),
    ((64, 4, 1, 64), (1, 4096, 64, 8, 4), 4, True),
    ((64, 4, 1, 219), (1, 14000, 64, 8, 4), 4, True),       # 219 tiles
    ((64, 4, 1, 218), (1, 14000, 64, 8, 4), 4, False),      # fewer slots
    ((256, 4, 1, 55), (1, 14080, 64, 8, 4), 4, True),       # 220 KB
    ((256, 4, 1, 56), (1, 14336, 64, 8, 4), 4, False),      # 224 KB + 3.5
    ((256, 32, 1, 256), (1, 65536, 64, 8, 32), 4, False),   # 8 MB
    ((256, 32, 1, 4), (1, 65536, 64, 8, 32), 4, False),     # fewer slots
    ((1, 0, 0, 0), (16, 1024, 512, 32, 64), 4, True),
    ((2, 0, 0, 0), (16, 1024, 512, 32, 64), 4, True),
    ((4, 0, 0, 0), (16, 1024, 512, 32, 64), 4, False),      # 4 x 16 lanes
    ((8, 0, 0, 0), (16, 1024, 512, 32, 8), 4, True),
    ((3, 0, 0, 0), (16, 1024, 512, 32, 8), 4, False),
    ((1, 0, 0, 0), (1, 100, 8, 4, 6), 4, True),             # K12: any C
])
def test_group_plan_legal_is_what_the_kernels_take(plan, shape, itemsize,
                                                   legal):
    assert pipeline.group_plan_legal(plan, *shape, itemsize) == legal


def test_group_smem_bytes_is_the_kernels_layout():
    """csrc/group_aggregate_pipelined.cu Layout: the slots, each center's
    neighbour offsets in an odd count of 16-byte chunks of four, one
    mbarrier a slot."""
    assert pipeline.group_smem_bytes((256, 32, 4, 4), 512, 32, 4) == (
        4 * 256 * 128 + 16 * 128 * 9 + 8 * 4)
    assert pipeline.group_smem_bytes((64, 8, 1, 2), 13, 5, 2) == (
        2 * 64 * 16 + 16 * 13 * 3 + 8 * 2)


#: The sweep's shapes (chip_smoke.GROUP_SWEEP): B, N, M, k, C, itemsize.
SWEPT = {"a": (2, 4096, 512, 16, 64, 4), "b": (16, 1024, 512, 32, 64, 4),
         "b-bf16": (16, 1024, 512, 32, 64, 2),
         "sa2": (16, 512, 128, 64, 128, 4),
         "large": (1, 65536, 1024, 32, 64, 4)}


@pytest.mark.parametrize("depth", [0, None])
@pytest.mark.parametrize("shape", [*SWEPT.values(), (1, 5, 3, 4, 8, 4),
                                   (3, 100, 7, 9, 200, 2),
                                   (1, 50, 12, 20, 32, 4),
                                   (2, 70000, 2048, 16, 1024, 4)])
def test_group_plan_is_legal(shape, depth):
    """The rule's pick is one of the legal plans; K13 has none, and the
    rule picks none, only where no slice of the cloud fits a block."""
    B, N, M, k, C, itemsize = shape
    plan = pipeline.group_plan(*shape, depth)
    if plan is None:
        assert depth is None and pipeline.group_plans(*shape) == []
        assert N * 16 > pipeline.MAX_SMEM
        return
    assert plan in pipeline.group_plans(*shape, depth)
    assert pipeline.group_plan_legal(plan, *shape)
    if depth is None:
        assert pipeline.group_smem_bytes(plan, M, k, itemsize) <= (
            pipeline.MAX_SMEM)


@pytest.mark.parametrize("depth", [0, None])
@pytest.mark.parametrize("name", SWEPT)
def test_group_plans_are_legal_and_distinct(name, depth):
    """Every plan is legal, once; K13's hold one slot a tile.  The large
    cloud (1 MB a 16-byte slice) has no K13 plan."""
    shape = SWEPT[name]
    plans = pipeline.group_plans(*shape, depth)
    assert bool(plans) == (depth == 0 or name != "large")
    assert len(set(plans)) == len(plans)
    assert all(pipeline.group_plan_legal(p, *shape) for p in plans)
    if depth is None:
        assert all(p[3] == pipeline.group_tiles(shape[1], p[0])
                   for p in plans)


def test_group_plan_is_none_where_rows_are_not_whole_chunks():
    assert pipeline.group_plan(1, 100, 8, 4, 6, 4) is None
    assert pipeline.group_plans(1, 100, 8, 4, 6, 4) == []
    assert pipeline.group_plan(1, 100, 8, 4, 6, 4, 0) == (1, 0, 0, 0)


def test_group_plan_takes_the_cards_sms():
    """K12 packs centers into a warp only while 8 warps an SM stay busy,
    and K13 keeps its blocks to one wave, on the SMs it is given."""
    assert pipeline.group_plan(16, 1024, 512, 32, 64, 4, 0, 132)[0] == 2
    assert pipeline.group_plan(16, 1024, 512, 32, 64, 4, 0, 1024)[0] == 1
    for sms in (66, 132):
        bn, cs, split, _ = pipeline.group_plan(16, 1024, 512, 32, 64, 4,
                                               None, sms)
        assert 16 * (64 // cs) * split <= sms


@pytest.mark.parametrize("name,depth,want", [
    ("a", 0, (1, 0, 0, 0)), ("b", 0, (2, 0, 0, 0)),
    ("b-bf16", 0, (4, 0, 0, 0)), ("sa2", 0, (1, 0, 0, 0)),
    ("large", 0, (1, 0, 0, 0)),
    ("a", None, (256, 8, 4, 16)), ("b", None, (256, 16, 2, 4)),
    ("b-bf16", None, (256, 64, 4, 4)), ("sa2", None, (256, 32, 2, 2)),
    ("large", None, None),
])
def test_group_plan_picks_what_the_sweep_measured(name, depth, want):
    assert pipeline.group_plan(*SWEPT[name], depth) == want


@pytest.mark.parametrize("shape,want", [
    ((2, 4096, 512, 16, 64), 16), ((16, 1024, 512, 32, 64), 4),
    ((1, 256, 64, 8, 32), 1), ((1, 100, 8, 4, 6), 0),
    ((1, 65536, 1024, 32, 64), 0)])
def test_group_steps_are_the_plans_feature_tiles(shape, want):
    Bc, Nc, Mc, kc, Cc = shape
    feats = torch.zeros((Bc, Nc, Cc))
    idx = torch.zeros((Bc, Mc, kc), dtype=torch.int32)
    assert pc_ops.group_steps(feats, idx) == want


def test_wrappers_take_the_plain_version_on_cpu_whatever_the_plan():
    """On a CPU tensor a wrapper computes the plain version whatever
    ``_plan`` says: the plan is read only where a kernel launches."""
    feats = _features(1, 64, 8, "float32")
    idx = _indices("random", 1, 64, 4, 3)
    want = ref.group_aggregate_ref(feats, idx)
    assert torch.equal(pck.group_aggregate(feats, idx, _plan=(3, 0, 0, 0)),
                       want)
    assert torch.equal(pck.group_aggregate_pipelined(
        feats, idx, _plan=(1, 1, 1, 1)), want)

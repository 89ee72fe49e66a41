"""The port's CUDA kernels against their plain versions on the card.

Needs an NVIDIA GPU and nvcc; skips elsewhere.  Imports no JAX, so it runs
on a machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are the reference's (tests/test_kernels.py:18): fp32 atol 2e-5 /
rtol 2e-4, bf16 2e-2, and fp16 (three more mantissa bits) bf16's 2e-2.  The point-cloud kernels (K9-K13) must match their
plain versions exactly: indices, and the max-pool, which only selects.  The
SSD scan kernels (K7, K8) hold the reference's atol 5e-4 / rtol 1e-3
(tests/test_kernels.py:86).  The int8 GEMMs (K4, K5) hold, in fp32, an
atol of K ulps (2^-23) of their largest product |x|·|scale·wq| (see
``_int8_tol``) and, in bf16 and fp16, the reference's 0.5 / rtol 2e-2
(tests/test_kernels.py:69); the int8-K/V flash kernel (K6) atol 2e-5 /
rtol 1e-4 in fp32 (tests/test_kernels.py:124).
"""

import itertools

import pytest
import torch

from repro_torch.compile.config import LoweringConfig
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_int8kv)
from repro_torch.kernels.int8_matmul import INT8_MATMUL, int8_matmul
from repro_torch.kernels import paged_decode as pdk
from repro_torch.kernels import pipeline, schedule
from repro_torch.kernels.pipeline import flash_attention_pipelined
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.ssd_scan import block_fits as ssd_block_fits
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models.registry import get_model
from repro_torch.pointcloud import kernels as pck
from repro_torch.pointcloud import ops as pc_ops
from repro_torch.pointcloud import ref as pc_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


FLOATS = [torch.float32, torch.bfloat16, torch.float16]


def _tol(dtype):
    return (dict(atol=2e-5, rtol=2e-4) if dtype == torch.float32
            else dict(atol=2e-2, rtol=2e-2))


@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("R,d", [(1, 768), (8, 768), (512, 768), (3, 100),
                                 (5, 64), (9, 1032), (2048, 2560), (4, 5120),
                                 (2, 70000)])
def test_rmsnorm_kernel(gen, R, d, dtype):
    x = torch.randn((R, d), generator=gen, device="cuda").to(dtype)
    g = torch.rand((d,), generator=gen, device="cuda") + 0.5
    before = _build.KERNELS["rmsnorm"].launches
    got = rmsnorm(x, g)
    torch.cuda.synchronize()
    assert _build.KERNELS["rmsnorm"].launches == before + 1
    torch.testing.assert_close(got, ref.rmsnorm_ref(x, g), **_tol(dtype))


@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("d", [64, 768, 2560, 5120])
def test_rmsnorm_every_launch_shape_agrees(gen, d, dtype):
    """The loop shape and every register shape that covers the row give
    the plain version's answer (``plan`` picks one of them)."""
    from repro_torch.kernels import rmsnorm as k1
    x = torch.randn((37, d), generator=gen, device="cuda").to(dtype)
    g = torch.rand((d,), generator=gen, device="cuda") + 0.5
    want = ref.rmsnorm_ref(x, g)
    V = 16 // x.element_size()
    shapes = [k1.Plan(k1.LOOP, 0, k1.LOOP_THREADS)]
    for mode, top in ((k1.ROW, k1.MAX_VPT), (k1.ROWS, k1.MAX_ROWS_VPT)):
        for vpt in range(1, top + 1):
            threads = 32 * -(-d // (32 * V * vpt))
            if threads <= k1.MAX_ROW_THREADS:
                shapes.append(k1.Plan(mode, vpt, threads))
    for shape in shapes:
        torch.testing.assert_close(k1.rmsnorm(x, g, shape=shape), want,
                                   **_tol(dtype), msg=str(shape))
    if d > 32 * V:
        with pytest.raises(RuntimeError):    # a shape that misses vectors
            k1.rmsnorm(x, g, shape=k1.Plan(k1.ROW, 1, 32))


FLASH = [  # B, S, T, H, K, hd
    (1, 64, 64, 12, 12, 64), (2, 40, 100, 4, 2, 64), (1, 130, 130, 8, 1, 32),
    (1, 16, 16, 4, 4, 16), (1, 96, 200, 2, 2, 128), (3, 1, 70, 4, 4, 64),
    # head dims between and above the old widths: 80 and 96 run at 128,
    # 256 with one KV head (paligemma-3b), 20 and 6 not whole vectors
    (1, 64, 64, 12, 12, 80), (2, 40, 100, 4, 2, 96), (1, 70, 130, 8, 1, 256),
    (1, 33, 50, 2, 1, 20), (1, 17, 17, 2, 2, 6),
    # sweeps of many tiles: S = T = 512 (36 of 64 tile pairs live when
    # causal), a long T past the end of the q rows, a ragged T
    (2, 512, 512, 4, 4, 64), (1, 64, 4096, 4, 2, 64), (2, 150, 333, 4, 4, 96),
    # sweeps past one live list of 128 K/V tiles (129 tiles of 64 keys,
    # 130 of 32 at width 256): walked window by window
    (1, 64, 8256, 2, 1, 64), (1, 64, 4160, 2, 1, 256)]
#: Masks: causal (T >= S: the diagonal ending at the last key); a random
#: (B,S,T) mask whose first third of the rows is fully masked; block
#: sparse (whole 64-key tiles dead in the middle of a row, others differ
#: per batch); each live tile valid at its last key only.
MASKS = ["causal", "random", "block_sparse", "last_entry"]


def _dead_rows(S: int) -> int:
    return max(1, S // 3)


def _mask(gen, kind, B, S, T, hd):
    from repro_torch.kernels.flash_attention import block_k
    if kind == "causal":
        return torch.tril(torch.ones((S, T), dtype=torch.bool, device="cuda"),
                          diagonal=T - S)[None]
    if kind == "random":
        mask = torch.rand((B, S, T), generator=gen, device="cuda") < 0.6
        mask[:, :_dead_rows(S), :] = False    # fully-masked rows
        return mask
    bk = block_k(hd)
    tile = torch.arange(T, device="cuda") // bk
    if kind == "block_sparse":
        mask = torch.rand((B, S, T), generator=gen, device="cuda") < 0.8
        for b in range(B):                    # tiles 1, 3, 5 ... or 2, 4 ...
            mask[b, :, (tile % 2 == 1 - b % 2) & (tile > 0)] = False
        return mask
    if kind == "last_entry":                  # tiles 0, 2, 4 ... and the end
        last = ((torch.arange(T, device="cuda") % bk == bk - 1) & (tile % 2 == 0))
        last[T - 1] = True
        return last.expand(1, S, T).contiguous()
    raise ValueError(kind)


def _flash_inputs(gen, B, S, T, H, K, hd, dtype, mask_kind="causal"):
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, T, K, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, T, K, hd), generator=gen, device="cuda").to(dtype)
    return q, k, v, _mask(gen, mask_kind, B, S, T, hd)


def _zero_where_no_key(out, mask):
    """Rows with no valid key are exactly 0."""
    B, S = out.shape[:2]
    dead = ~mask.expand(B, S, mask.shape[2]).any(-1)
    if dead.any():
        assert float(out[dead].abs().max()) == 0.0


def _live_counted(name, fn, mask, B, H, hd):
    """Launch ``fn(live_count)`` once: the K/V tiles the kernel reports
    computing must be those ``live_tiles`` reads from the mask, for every
    (batch, head)."""
    from repro_torch.kernels.flash_attention import live_tiles
    count = torch.zeros(1, dtype=torch.int32, device="cuda")
    out = _launched(name, lambda: fn(count))
    assert int(count) == B // mask.shape[0] * H * live_tiles(mask, hd)[0]
    return out


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("B,S,T,H,K,hd", FLASH)
def test_flash_kernels(gen, B, S, T, H, K, hd, dtype, mask_kind):
    q, k, v, mask = _flash_inputs(gen, B, S, T, H, K, hd, dtype, mask_kind)
    want = ref.flash_attention_ref(q, k, v, mask, sm_scale=hd ** -0.5)
    outs = [_live_counted("flash_attention", lambda n: flash_attention(
        q, k, v, mask, sm_scale=hd ** -0.5, live_count=n), mask, B, H, hd)]
    for depth in (2, 3, 4):
        if (pipeline.ring_smem_bytes(hd, q.element_size(), depth)
                <= pipeline.MAX_SMEM):
            outs.append(_live_counted(
                "flash_attention_pipelined",
                lambda n: flash_attention_pipelined(
                    q, k, v, mask, sm_scale=hd ** -0.5, depth=depth,
                    live_count=n), mask, B, H, hd))
    outs.append(_launched("flash_attention", lambda: flash_attention(
        q, k, v, mask, sm_scale=hd ** -0.5)))   # and with no counter
    for got in outs:
        torch.testing.assert_close(got, want, **_tol(dtype))
        _zero_where_no_key(got, mask)


@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("hd", [16, 64, 80, 256])
def test_flash_occupancy_matches_the_ring_rule(gen, hd, dtype):
    """The blocks an SM the card reports: at the served width 64, K3 at
    ``choose_depth``'s ring keeps two (fp32 blocks are held to 128
    registers for it) and K2 as many; every kernel at least one."""
    from repro_torch.kernels.flash_attention import blocks_per_sm
    item = torch.empty((), dtype=dtype).element_size()
    depth = pipeline.choose_depth(hd, item, 8)
    k3 = blocks_per_sm("flash_attention_pipelined", dtype, hd, depth)
    k2 = blocks_per_sm("flash_attention", dtype, hd)
    assert min(k3, k2, blocks_per_sm("flash_attention_int8kv", dtype, hd)) >= 1
    if hd == 64:
        assert min(k3, k2) >= 2


def test_flash_wrappers_raise_on_what_the_kernel_does_not_take(gen):
    q, k, v, mask = _flash_inputs(gen, 1, 64, 64, 4, 4, 64, torch.float32)
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2), k, v, mask, sm_scale=0.125)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, mask.float(), sm_scale=0.125)
    wider = [t.repeat(1, 1, 1, 5) for t in (q, k, v)]    # hd 320 > 256
    with pytest.raises(ValueError):
        flash_attention(*wider, mask, sm_scale=0.125)
    wide = [t.repeat(1, 1, 1, 2) for t in (q, k, v)]
    with pytest.raises(ValueError):
        flash_attention_pipelined(*wide, mask, sm_scale=0.1, depth=4)
    with pytest.raises(ValueError):       # no ring of 3 fits at hd 256, fp32
        flash_attention_pipelined(*[t.repeat(1, 1, 1, 4) for t in (q, k, v)],
                                  mask, sm_scale=0.1, depth=3)


def _sms():
    return pipeline.sm_count("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ops_route_k2_for_one_tile_and_k3_for_more(gen, dtype):
    """The route launches the kernel its schedule names (K2 for one K/V
    tile, where K3 is not offered; above that the cost model's pick), and
    K3 where forced from two tiles up."""
    for S in (16, 64, 65, 512):
        q, k, v, mask = _flash_inputs(gen, 1, S, S, 4, 4, 64, dtype)
        sched = schedule.flash_schedule(1, S, 4, 4, S, 64, q.element_size(),
                                        _sms())
        assert (sched["pipe"] is None) is (S <= 64)
        got = _launched(sched["kernel"], lambda: ops.flash_attention_gqa(
            q, k, v, mask, sm_scale=0.125))
        torch.testing.assert_close(
            got, ref.flash_attention_ref(q, k, v, mask, sm_scale=0.125),
            **_tol(dtype))
        if sched["pipe"]:
            _launched("flash_attention_pipelined",
                      lambda: ops.flash_attention_gqa(
                          q, k, v, mask, sm_scale=0.125, pipelined=True))


def test_reduced_model_cuda_backend_matches_torch_backend(gen):
    cfg = reduced(get_config("llama110m"))
    cuda_m = get_model(cfg, lowering=LoweringConfig("cuda"))
    plain_m = get_model(cfg, lowering=LoweringConfig("torch"))
    params = cuda_m.init(0, "cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=gen,
                           device="cuda")
    got, gkv = cuda_m.prefill(params, {"tokens": tokens})
    want, wkv = plain_m.prefill(params, {"tokens": tokens})
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(gkv["k"], wkv["k"], atol=1e-5, rtol=0)


#: The families' prefill masks: the vlm prefix-LM mask (paligemma-3b's hd
#: 256 with one KV head, and a prefix that ends inside a tile), the
#: encoder's full mask and the cross attention's with S != T
#: (seamless-m4t-medium), and a full mask at hd 128 with 9 query rows.
FAMILY_FLASH = [  # B, S, T, H, K, hd, mask kind, n_prefix
    (1, 320, 320, 8, 1, 256, "prefix", 256),
    (2, 100, 100, 4, 1, 256, "prefix", 70),
    (2, 32, 1024, 4, 4, 64, "full", 0),
    (1, 1024, 1024, 4, 4, 64, "full", 0),
    (2, 9, 130, 4, 2, 128, "full", 0)]


@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("B,S,T,H,K,hd,kind,n_prefix", FAMILY_FLASH)
def test_flash_kernels_under_family_masks(gen, B, S, T, H, K, hd, kind,
                                          n_prefix, dtype):
    """K2 and K3 (every ring depth that fits) under ``layers.make_mask``'s
    prefix and full masks against the plain version, each launch counting
    the K/V tiles the mask leaves live."""
    from repro_torch.models.layers import make_mask
    q, k, v, _ = _flash_inputs(gen, B, S, T, H, K, hd, dtype)
    mask = make_mask(kind, S, T, n_prefix=n_prefix, device="cuda")
    want = ref.flash_attention_ref(q, k, v, mask, sm_scale=hd ** -0.5)
    outs = [_live_counted("flash_attention", lambda n: flash_attention(
        q, k, v, mask, sm_scale=hd ** -0.5, live_count=n), mask, B, H, hd)]
    for depth in (2, 3, 4):
        if (pipeline.ring_smem_bytes(hd, q.element_size(), depth)
                <= pipeline.MAX_SMEM):
            outs.append(_live_counted(
                "flash_attention_pipelined",
                lambda n: flash_attention_pipelined(
                    q, k, v, mask, sm_scale=hd ** -0.5, depth=depth,
                    live_count=n), mask, B, H, hd))
    for got in outs:
        torch.testing.assert_close(got, want, **_tol(dtype))


FAMILIES = ["granite-3-8b", "yi-9b", "internlm2-20b", "qwen1.5-0.5b",
            "dbrx-132b", "arctic-480b", "zamba2-1.2b", "paligemma-3b",
            "seamless-m4t-medium"]


@pytest.mark.parametrize("arch", FAMILIES)
def test_reduced_family_cuda_backend_matches_torch_backend(gen, arch):
    """A reduced prefill and one decode step of each family on backend
    cuda (the kernels) against backend torch on the same weights: logits
    and caches within 5e-5 / 1e-4 (the reference's decode-vs-prefill
    tolerance: two to four fp32 layers, zamba2's SSD on 3xTF32)."""
    cfg = reduced(get_config(arch))
    cuda_m = get_model(cfg, lowering=LoweringConfig("cuda"))
    plain_m = get_model(cfg, lowering=LoweringConfig("torch"))
    params = cuda_m.init(0, "cuda")
    S = 40
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, S), generator=gen,
                                     device="cuda")}
    P = {"vlm": cfg.n_prefix_tokens, "encdec": 24}.get(cfg.family, 0)
    if P:
        batch["prefix_embeds"] = torch.randn((2, P, cfg.d_model),
                                             generator=gen, device="cuda")
    pos = S + (P if cfg.family == "vlm" else 0)
    tol = dict(atol=5e-5, rtol=1e-4)
    before = _build.launch_counts()
    got, gc = cuda_m.prefill(params, batch, pos + 4)
    torch.cuda.synchronize()
    ran = {n for n, c in _build.launch_counts().items() if c > before[n]}
    assert "rmsnorm" in ran and ran & {"flash_attention",
                                       "flash_attention_pipelined"}, ran
    want, wc = plain_m.prefill(params, batch, pos + 4)
    torch.testing.assert_close(got, want, **tol)
    torch.testing.assert_close(gc["k"], wc["k"], **tol)
    tok = torch.argmax(want, dim=-1).to(torch.int32)
    got, _ = cuda_m.decode_step(params, tok, gc, pos)
    want, _ = plain_m.decode_step(params, tok, wc, pos)
    torch.testing.assert_close(got, want, **tol)


# ---------------------------------------------------------------------------
# Point-cloud kernels K9-K13
# ---------------------------------------------------------------------------

def _points(gen, B, N, dtype, kind="normal"):
    if kind == "lattice":      # exact ties; d² exactly on integer r²
        x = torch.randint(0, 6, (B, N, 3), generator=gen, device="cuda")
        return x.float().to(dtype)
    return torch.randn((B, N, 3), generator=gen, device="cuda").to(dtype)


def _launched(name, fn):
    before = _build.KERNELS[name].launches
    out = fn()
    torch.cuda.synchronize()
    assert _build.KERNELS[name].launches == before + 1
    return out


@pytest.mark.parametrize("kind", ["normal", "lattice"])
@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("B,N,S", [(2, 256, 64), (1, 1000, 1000), (2, 1025, 17),
                                   (2, 4096, 512), (1, 9000, 40),
                                   (1, 1, 1), (16, 1024, 512),
                                   (1, 65536, 64), (1, 100000, 64),
                                   (1, 131072, 16), (1, 140000, 40),
                                   (8, 65536, 32), (16, 65536, 32)])
def test_fps_kernel(gen, B, N, S, dtype, kind):
    """K9 under its plan rule; (1, 100000, 64) and (1, 131072, 16) take the
    largest register plan, 16 blocks of 1024 threads at 8 points,
    (1, 140000, 40) is above the register capacity: the scratch path;
    8 and 16 clouds of 65536 points halve the cluster to 8 (registers)
    and 4 (scratch)."""
    xyz = _points(gen, B, N, dtype, kind)
    got = _launched("fps", lambda: pck.fps(xyz, S))
    assert torch.equal(got, pc_ref.fps_ref(xyz, S))


FPS_FORCED = [  # B, N, S
    (2, 4096, 512),      # shape (a)
    (2, 1031, 1),        # S = 1; N not a multiple of cluster x threads
    (3, 1000, 1000),     # S = N: the lattice's later steps tie at 0
    (40, 1030, 64),      # B x cluster above 132 SMs from cluster 4 up
]


@pytest.mark.parametrize("kind", ["normal", "lattice"])
@pytest.mark.parametrize("B,N,S", FPS_FORCED)
@pytest.mark.parametrize("threads", pipeline.FPS_THREADS)
@pytest.mark.parametrize("cluster", pipeline.FPS_CLUSTERS)
def test_fps_kernel_at_every_plan(gen, cluster, threads, B, N, S, kind):
    """Every cluster size the rule can pick, at every block width, with
    the fewest points a thread that hold the block's span in registers
    (or the scratch path where 8 do not), forced through ``_plan``."""
    plan = (cluster, threads, pipeline.fps_ppt(-(-N // cluster), threads))
    xyz = _points(gen, B, N, torch.float32, kind)
    got = _launched("fps", lambda: pck.fps(xyz, S, _plan=plan))
    assert torch.equal(got, pc_ref.fps_ref(xyz, S))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("cluster", pipeline.FPS_CLUSTERS)
def test_fps_kernel_ties_in_16_bit_at_every_cluster_size(gen, cluster, dtype):
    B, N, S = 2, 4096, 512
    plan = (cluster, 512, pipeline.fps_ppt(-(-N // cluster), 512))
    xyz = _points(gen, B, N, dtype, "lattice")
    got = _launched("fps", lambda: pck.fps(xyz, S, _plan=plan))
    assert torch.equal(got, pc_ref.fps_ref(xyz, S))


def test_fps_refuses_plans_the_kernel_does_not_take(gen):
    """No fallback: a plan the kernel does not take raises in the wrapper,
    and one that reaches the C entry point is refused there and raises,
    launching nothing."""
    xyz = _points(gen, 2, 4096, torch.float32)
    for plan in ((3, 256, 8), (1, 128, 8), (1, 256, 16), (1, 256, 1)):
        with pytest.raises(ValueError):
            pck.fps(xyz, 8, _plan=plan)
    out = torch.empty((2, 8), dtype=torch.int32, device="cuda")
    before = pck.FPS.launches
    for plan in ((32, 256, 8), (1, 256, 1), (1, 256, 0)):
        with pytest.raises(RuntimeError):
            pck.FPS.launch(_build.ptr(xyz), _build.ptr(out), None, None, 2,
                           4096, 8, *plan, 0, xyz.device.index,
                           _build.stream_of(xyz))
    assert pck.FPS.launches == before


@pytest.mark.parametrize("B,N,plan", [(2, 4096, None), (16, 1024, None),
                                      (3, 1000, (16, 256, 1)),
                                      (1, 140000, None)])
def test_fps_kernel_writes_the_sm_of_every_block(gen, B, N, plan):
    """``sm_ids`` gets one SM id a block, each below the card's SM count;
    the indices are those of a call without it."""
    xyz = _points(gen, B, N, torch.float32)
    cluster = (plan or pipeline.fps_plan(B, N))[0]
    ids = torch.full((B * cluster,), -1, dtype=torch.int32, device="cuda")
    got = _launched("fps", lambda: pck.fps(xyz, 8, sm_ids=ids, _plan=plan))
    assert torch.equal(got, pc_ref.fps_ref(xyz, 8))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert bool((ids >= 0).all()) and bool((ids < sms).all())
    with pytest.raises(ValueError):
        pck.fps(xyz, 8, sm_ids=ids[:-1], _plan=plan)


def test_fps_never_takes_the_plain_version_on_the_card(gen, monkeypatch):
    """Every FPS route sends a CUDA cloud the kernel takes to the kernel,
    on the register and the scratch path alike."""
    plain = pc_ref.fps_ref
    want = {}
    for B, N, S in ((2, 4096, 512), (1, 140000, 16)):
        xyz = _points(gen, B, N, torch.float32)
        want[(B, N, S)] = (xyz, plain(xyz, S))

    def refuse(*args, **kwargs):
        raise AssertionError("fps_ref reached on the card")
    monkeypatch.setattr(pc_ref, "fps_ref", refuse)
    lw = LoweringConfig("cuda")
    for (B, N, S), (xyz, w) in want.items():
        for call in (pck.fps, pc_ops.farthest_point_sample, lw.fps):
            assert torch.equal(_launched("fps", lambda: call(xyz, S)), w)


BALL = [  # B, N, M, k, radius
    (2, 256, 64, 8, 0.9), (1, 1000, 13, 16, 0.5), (2, 4096, 512, 16, 0.9),
    (3, 777, 40, 64, 0.3), (16, 1024, 512, 32, 0.2), (1, 5, 3, 4, 10.0),
    # parts past K10's 4096 points in shared memory: its tiled path
    (1, 20000, 40, 32, 0.3)]


def _every_ball_plan(xyz, centers, radius, k, want, radius_sq=None):
    """K10 at every plan it is built for, K11 at every plan and ring depth,
    each forced through ``_plan`` and held exactly to ``want``."""
    B, N, _ = xyz.shape
    M, itemsize = centers.shape[1], xyz.element_size()
    for depth in (0, *pipeline.DEPTHS):
        plans = pipeline.ball_plans(B, N, M, k, itemsize, depth)
        assert pipeline.ball_plan(B, N, M, k, itemsize, depth) in plans
        for plan in plans:
            if depth == 0:
                got = _launched("ball_query", lambda: pck.ball_query(
                    xyz, centers, radius, k, radius_sq=radius_sq,
                    _plan=plan))
            else:
                got = _launched("ball_query_pipelined",
                                lambda: pck.ball_query_pipelined(
                                    xyz, centers, radius, k, depth=depth,
                                    radius_sq=radius_sq, _plan=plan))
            assert torch.equal(got, want), plan


@pytest.mark.parametrize("kind", ["normal", "lattice", "empty"])
@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("B,N,M,k,radius", BALL)
def test_ball_query_kernels(gen, B, N, M, k, radius, dtype, kind):
    """K10 and K11 under the plan rule (K11 at every ring depth), then at
    every plan, exactly; two calls give the same bits."""
    xyz = _points(gen, B, N, dtype, kind)
    centers = xyz[:, :M].contiguous() if M <= N else _points(gen, B, M, dtype)
    if kind == "empty":        # centers away from the cloud: empty balls
        centers = (3 * torch.randn((B, M, 3), generator=gen,
                                   device="cuda")).to(dtype)
    if kind == "lattice":
        radius = 1.0
    want = pc_ref.ball_query_ref(xyz, centers, radius, k)
    got = _launched("ball_query",
                    lambda: pck.ball_query(xyz, centers, radius, k))
    assert torch.equal(got, want)
    assert torch.equal(pck.ball_query(xyz, centers, radius, k), got)
    for depth in (2, 3, 4):
        got = _launched("ball_query_pipelined", lambda: pck.ball_query_pipelined(
            xyz, centers, radius, k, depth=depth))
        assert torch.equal(got, want), depth
        assert torch.equal(pck.ball_query_pipelined(
            xyz, centers, radius, k, depth=depth), got), depth
    _every_ball_plan(xyz, centers, radius, k, want)


def test_ball_query_kernels_take_radius_sq_and_misaligned_batches(gen):
    xyz = _points(gen, 3, 1001, torch.float32, "lattice")  # 12 * 1001 % 16 != 0
    centers = xyz[:, 500:540].contiguous()
    for r2 in (1.0, 2.0, 3.0):
        want = pc_ref.ball_query_ref(xyz, centers, 0.0, 16, radius_sq=r2)
        assert torch.equal(pck.ball_query(xyz, centers, 0.0, 16, radius_sq=r2),
                           want)
        assert torch.equal(pck.ball_query_pipelined(
            xyz, centers, 0.0, 16, depth=3, radius_sq=r2), want)
        if r2 == 2.0:
            _every_ball_plan(xyz, centers, 0.0, 16, want, radius_sq=r2)


def test_ball_query_smem_mirrors_match_the_kernels(gen):
    """``pipeline.ball_smem_bytes`` is what the libraries ask for."""
    k10, k11 = pck.BALL_QUERY, pck.BALL_QUERY_PIPELINED
    for N, k in ((5, 4), (4096, 16), (1024, 32), (65536, 32), (20000, 64)):
        for itemsize, code in ((4, 0), (2, 1)):
            for depth in (0, *pipeline.DEPTHS):
                for plan in pipeline.ball_plans(1, N, 512, k, itemsize, depth):
                    cpw, warps, split, _ = plan
                    got = (k10.query("ball_query_smem", N, k, cpw, warps, split)
                           if depth == 0 else
                           k11.query("ball_query_pipelined_smem", k, cpw,
                                     warps, split, depth, code))
                    assert got == pipeline.ball_smem_bytes(plan, N, k,
                                                           itemsize), plan


def test_ball_query_refuses_plans_the_kernels_do_not_take(gen):
    """No fallback: a plan the kernels do not take raises in the wrapper,
    and one that reaches the C entry point is refused there and raises,
    launching nothing."""
    xyz = _points(gen, 2, 1024, torch.float32)
    centers = xyz[:, :64].contiguous()
    for plan in ((3, 8, 1, 0), (4, 16, 1, 0), (4, 8, 8, 0), (4, 8, 1, 2)):
        with pytest.raises(ValueError):
            pck.ball_query(xyz, centers, 0.5, 8, _plan=plan)
    for plan in ((4, 8, 1, 0), (4, 8, 1, 5), (4, 8, 8, 2)):
        with pytest.raises(ValueError):
            pck.ball_query_pipelined(xyz, centers, 0.5, 8, _plan=plan)
    out = torch.empty((2, 64, 8), dtype=torch.int32, device="cuda")
    args = (_build.ptr(xyz), _build.ptr(centers), _build.ptr(out), 2, 1024,
            64, 8, 0.25)
    tail = (0, xyz.device.index, _build.stream_of(xyz))
    before = dict(_build.launch_counts())
    for plan in ((3, 8, 1), (4, 16, 1), (4, 8, 8), (4, 8, 16)):
        with pytest.raises(RuntimeError):
            pck.BALL_QUERY.launch(*args, *plan, *tail)
    for plan in ((4, 8, 1, 1), (4, 8, 1, 5), (4, 8, 8, 2), (5, 8, 1, 2)):
        with pytest.raises(RuntimeError):
            pck.BALL_QUERY_PIPELINED.launch(*args, *plan, *tail)
    assert _build.launch_counts() == before


GROUP = [  # B, N, M, k, C
    (2, 256, 64, 8, 32), (2, 4096, 512, 16, 64), (16, 1024, 512, 32, 64),
    (1, 300, 13, 5, 8), (2, 500, 30, 64, 128), (1, 64, 7, 33, 256),
    (1, 100, 9, 17, 4), (1, 8192, 64, 8, 4)]


def _group_plans(feats, idx, depth):
    Bc, Nc, Cc = feats.shape
    return pipeline.group_plans(Bc, Nc, idx.shape[1], idx.shape[2], Cc,
                                feats.element_size(), depth)


@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("B,N,M,k,C", GROUP)
def test_group_aggregate_kernels(gen, B, N, M, k, C, dtype):
    """Every plan of K12 and K13 (``_plan``), exactly, on indices in any
    order and in ball query's order (ascending, padded with the first)."""
    feats = torch.randn((B, N, C), generator=gen, device="cuda").to(dtype)
    rand = torch.randint(0, N, (B, M, k), generator=gen, device="cuda",
                         dtype=torch.int32)
    ball = torch.sort(rand, dim=-1).values
    ball[..., k // 2:] = ball[..., :1]
    plans = 0
    for idx in (rand, ball):
        want = pc_ref.group_aggregate_ref(feats, idx)
        got = _launched("group_aggregate",
                        lambda: pck.group_aggregate(feats, idx))
        assert got.dtype == dtype and torch.equal(got, want)
        for name, depth in (("group_aggregate", 0),
                            ("group_aggregate_pipelined", None)):
            for plan in _group_plans(feats, idx, depth):
                got = _launched(name, lambda: getattr(pck, name)(
                    feats, idx, _plan=plan))
                assert torch.equal(got, want), (name, plan)
                plans += 1
    assert plans > 0


@pytest.mark.parametrize("dtype", FLOATS)
def test_group_aggregate_kernels_clamp_stray_indices(gen, dtype):
    feats = torch.randn((2, 300, 32), generator=gen, device="cuda").to(dtype)
    idx = torch.randint(-700, 700, (2, 12, 20), generator=gen, device="cuda",
                        dtype=torch.int32)
    want = pc_ref.group_aggregate_ref(feats, idx)
    assert torch.equal(pck.group_aggregate(feats, idx), want)
    assert torch.equal(pck.group_aggregate_pipelined(feats, idx), want)
    for name, depth in (("group_aggregate", 0),
                        ("group_aggregate_pipelined", None)):
        for plan in _group_plans(feats, idx, depth):
            assert torch.equal(getattr(pck, name)(feats, idx, _plan=plan),
                               want), (name, plan)


def test_group_aggregate_cluster_plan_repeats_its_bits(gen):
    """K13 on a cluster (tiles multicast to 4 blocks) 50 times at (b)'s
    shape: every run the first run's bits, and those the plain version's."""
    feats = torch.randn((16, 1024, 64), generator=gen, device="cuda")
    idx = torch.sort(torch.randint(0, 1024, (16, 512, 32), generator=gen,
                                   device="cuda", dtype=torch.int32),
                     dim=-1).values
    plan = (256, 32, 4, 4)
    assert plan in _group_plans(feats, idx, None)
    first = pck.group_aggregate_pipelined(feats, idx, _plan=plan)
    assert torch.equal(first, pc_ref.group_aggregate_ref(feats, idx))
    for _ in range(50):
        again = pck.group_aggregate_pipelined(feats, idx, _plan=plan)
        assert torch.equal(again, first)


@pytest.mark.parametrize("dtype", FLOATS)
def test_group_aggregate_kernels_let_a_nan_win(gen, dtype):
    """Every plan of K12 and K13 on features with NaNs: a NaN wins every
    max it enters, as torch.amax takes it (group::max16's max.NaN), and
    the other maxima are the plain version's, bit for bit."""
    for B, N, M, k, C in ((2, 256, 64, 8, 32), (16, 1024, 512, 32, 64)):
        feats = torch.randn((B, N, C), generator=gen, device="cuda")
        feats[torch.rand((B, N, C), generator=gen, device="cuda") < 0.002] = (
            float("nan"))
        feats[0, 3, 1] = feats[-1, N - 1, C - 1] = float("nan")
        feats = feats.to(dtype)
        idx = torch.randint(0, N, (B, M, k), generator=gen, device="cuda",
                            dtype=torch.int32)
        idx[0, 0, k // 2] = 3
        idx[-1, -1, 0] = N - 1
        want = pc_ref.group_aggregate_ref(feats, idx)
        assert torch.isnan(want[0, 0, 1]) and not torch.isnan(want).all()
        for name, depth in (("group_aggregate", 0),
                            ("group_aggregate_pipelined", None)):
            for plan in _group_plans(feats, idx, depth):
                got = getattr(pck, name)(feats, idx, _plan=plan)
                torch.testing.assert_close(got, want, rtol=0, atol=0,
                                           equal_nan=True,
                                           msg=f"{name} {plan}")


@pytest.mark.parametrize("pipelined", [None, True])
def test_group_aggregate_routes_a_cloud_no_slice_fits_to_k12(gen,
                                                             pipelined):
    """On a cloud of 65536 rows no 16-byte slice fits a K13 block, so K13
    has no plan and the route takes K12, exactly, even when asked for
    K13."""
    feats = torch.randn((1, 65536, 64), generator=gen, device="cuda")
    idx = torch.sort(torch.randint(0, 65536, (1, 1024, 32), generator=gen,
                                   device="cuda", dtype=torch.int32),
                     dim=-1).values
    assert pipeline.group_plan(1, 65536, 1024, 32, 64, 4) is None
    assert schedule.group_schedule(1, 65536, 1024, 32, 64, 4,
                                   pipeline.sm_count("cuda"))["pipe"] is None
    got = _launched("group_aggregate", lambda: pc_ops.group_aggregate(
        feats, idx, pipelined=pipelined))
    assert torch.equal(got, pc_ref.group_aggregate_ref(feats, idx))


def test_pointcloud_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    xyz = _points(gen, 1, 64, torch.float32)
    feats = torch.randn((1, 64, 32), device="cuda")
    idx = torch.zeros((1, 8, 4), dtype=torch.int32, device="cuda")
    for call in (lambda: pck.fps(xyz, 65),
                 lambda: pck.fps(xyz.double(), 8),
                 lambda: pck.fps(xyz[..., :2].contiguous(), 8),
                 lambda: pck.ball_query(xyz, xyz[:, :8].bfloat16(), 1.0, 4),
                 lambda: pck.ball_query(xyz, xyz[:, :8], 1.0, 0),
                 lambda: pck.ball_query_pipelined(xyz, xyz[:, :8], 1.0, 4,
                                                  depth=5),
                 lambda: pck.group_aggregate(feats, idx.long()),
                 lambda: pck.group_aggregate(feats.transpose(1, 2), idx),
                 lambda: pck.group_aggregate_pipelined(
                     torch.randn((1, 64, 6), device="cuda"), idx),
                 lambda: pck.group_aggregate_pipelined(
                     feats, idx, _plan=(64, 32, 1, 2)),      # 2 slots, 1 tile
                 lambda: pck.group_aggregate_pipelined(
                     feats, idx, _plan=(2, 0, 0, 0)),        # K12's plan
                 lambda: pck.group_aggregate(feats, idx, _plan=(8, 0, 0, 0)),
                 lambda: pck.group_aggregate_pipelined(
                     torch.randn((1, 4096, 512), device="cuda"), idx,
                     _plan=(256, 32, 1, 16)),                # 512 KB slice
                 lambda: pck.group_aggregate_pipelined(   # no slice fits
                     torch.randn((1, 65536, 64), device="cuda"), idx)):
        with pytest.raises(ValueError):
            call()


def test_pointcloud_routes_raise_where_the_kernels_do_not_take_the_cloud(gen):
    """Past the reference's fallbacks nothing on the card falls back to
    the plain version: 2-d points and mixed dtypes raise."""
    xyz = _points(gen, 1, 256, torch.float32)
    flat = xyz[..., :2].contiguous()
    lw = LoweringConfig("cuda")
    for call in (lambda: pc_ops.farthest_point_sample(flat, 8),
                 lambda: lw.fps(flat, 8),
                 lambda: pc_ops.ball_query(flat, flat[:, :8], 1.0, 4),
                 lambda: lw.ball_query(flat, flat[:, :8], 1.0, 4),
                 lambda: pc_ops.ball_query(xyz, xyz[:, :8].bfloat16(), 1.0, 4),
                 lambda: pc_ops.group_aggregate(
                     xyz.double(), torch.zeros((1, 8, 4), dtype=torch.int32,
                                               device="cuda"))):
        with pytest.raises(ValueError):
            call()


def test_pointcloud_ops_route_baseline_and_pipelined(gen):
    """Each route launches the kernel its schedule names (the cost model's
    pick between K10 and K11, K12 and K13), and the pipelined one where
    forced and offered (two streamed tiles or more)."""
    xyz = _points(gen, 16, 1024, torch.float32)
    feats = torch.randn((16, 1024, 64), generator=gen, device="cuda")
    for B, N, M, k in ((2, 256, 64, 16), (16, 1024, 512, 32)):
        x = xyz[:B, :N].contiguous()
        c = xyz[:B, :M].contiguous()
        bs = schedule.ball_schedule(B, N, M, k, 4, _sms())
        idx = _launched(bs["kernel"],
                        lambda: pc_ops.ball_query(x, c, 0.9, k))
        assert torch.equal(idx, pc_ref.ball_query_ref(x, c, 0.9, k))
        f = feats[:B, :N].contiguous()
        gs = schedule.group_schedule(B, N, M, k, 64, 4, _sms())
        out = _launched(gs["kernel"], lambda: pc_ops.group_aggregate(f, idx))
        assert torch.equal(out, pc_ref.group_aggregate_ref(f, idx))
        for sched, name, call in (
                (bs, "ball_query_pipelined",
                 lambda: pc_ops.ball_query(x, c, 0.9, k, pipelined=True)),
                (gs, "group_aggregate_pipelined",
                 lambda: pc_ops.group_aggregate(f, idx, pipelined=True))):
            if sched["pipe"]:
                _launched(name, call)


@pytest.mark.parametrize("pipelined", [None, False])
def test_pointcloud_stage_cuda_backend_matches_torch_backend(gen, pipelined):
    from repro_torch.launch.pointcloud import set_abstraction
    xyz = _points(gen, 2, 4096, torch.float32)
    feats = torch.randn((2, 4096, 64), generator=gen, device="cuda")
    got = set_abstraction(LoweringConfig("cuda"), xyz, feats, 512, 0.9, 16,
                          pipelined=pipelined)
    want = set_abstraction(LoweringConfig("torch"), xyz, feats, 512, 0.9, 16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)



# ---------------------------------------------------------------------------
# SSD scan kernels K7, K8
# ---------------------------------------------------------------------------

SSD = [  # BT, H, S, P, N: small, ragged, S=1, around the 16-position chunk
    # (Q-1, Q, Q+1, 2Q+1) and around 32 and K7's first 64, BT*H well below
    # the SM count, the model's; the state split over two warps (N = 256)
    # and the head dim over two blocks (P = 128, N = 256); P = 6, N = 20
    (1, 1, 128, 8, 16), (2, 3, 100, 16, 32), (2, 2, 1, 8, 16),
    (3, 2, 40, 16, 8), (2, 8, 31, 64, 128), (2, 8, 33, 64, 128),
    (2, 8, 63, 64, 128), (2, 8, 65, 64, 128), (1, 4, 300, 64, 128),
    (4, 80, 512, 64, 128), (2, 8, 32, 64, 128), (2, 8, 64, 64, 128),
    (2, 8, 129, 64, 128), (2, 5, 200, 64, 128), (2, 8, 15, 64, 128),
    (2, 8, 16, 64, 128), (2, 8, 17, 64, 128), (1, 3, 97, 64, 128),
    (1, 3, 70, 64, 256), (1, 1, 70, 128, 256), (1, 1, 33, 6, 20)]
SSD_TOL = dict(atol=5e-4, rtol=1e-3)


def _ring_fits(P, N, depth, itemsize=4):
    return ssd_block_fits(P, N, pipeline.ssd_ring_bytes(P, N, depth, itemsize))


def _ssd_inputs(gen, BT, H, S, P, N, strong=False):
    lo, hi, alo, ahi = (3.0, 5.0, 1.5, 2.0) if strong else (0.1, 0.9, 0.5, 1.5)
    x = torch.randn((BT, H, S, P), generator=gen, device="cuda")
    dt = lo + (hi - lo) * torch.rand((BT, H, S), generator=gen, device="cuda")
    A = -(alo + (ahi - alo) * torch.rand((H,), generator=gen, device="cuda"))
    B = torch.randn((BT, S, N), generator=gen, device="cuda")
    C = torch.randn((BT, S, N), generator=gen, device="cuda")
    return x, dt, A, B, C


@pytest.mark.parametrize("strong", [False, True], ids=["decay", "strong"])
@pytest.mark.parametrize("BT,H,S,P,N", SSD)
def test_ssd_kernels(gen, BT, H, S, P, N, strong):
    args = _ssd_inputs(gen, BT, H, S, P, N, strong)
    want = ref.ssd_scan_ref(*args)
    got = _launched("ssd_scan", lambda: ssd_scan(*args))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **SSD_TOL)
    for depth in pipeline.DEPTHS:
        if not _ring_fits(P, N, depth):
            continue
        got = _launched("ssd_scan_pipelined", lambda: (
            pipeline.ssd_scan_pipelined(*args, depth=depth)))
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, want, **SSD_TOL)


# BT, H, S, P, N, dtype: bf16/fp16 I/O at the model's widths; P or N not a
# multiple of 4 (element loads, padded in the block); N = 256 (two warps
# across the state)
SSD_WIDE = [
    (2, 4, 300, 64, 128, torch.bfloat16), (2, 4, 300, 64, 128, torch.float16),
    (2, 3, 100, 6, 128, torch.float32), (2, 3, 100, 6, 128, torch.bfloat16),
    (1, 2, 70, 10, 6, torch.float32), (1, 2, 70, 12, 20, torch.float16),
    (2, 3, 100, 64, 256, torch.float32), (2, 3, 100, 64, 256, torch.bfloat16)]


@pytest.mark.parametrize("BT,H,S,P,N,dtype", SSD_WIDE)
def test_ssd_kernels_in_every_dtype_and_state(gen, BT, H, S, P, N, dtype):
    x, dt, A, B, C = _ssd_inputs(gen, BT, H, S, P, N)
    args = [t.to(dtype) for t in (x, dt)] + [A] + [t.to(dtype) for t in (B, C)]
    want = ref.ssd_scan_ref(*args)
    tol = SSD_TOL if dtype == torch.float32 else _tol(dtype)
    got = _launched("ssd_scan", lambda: ssd_scan(*args))
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, **tol)
    for depth in pipeline.DEPTHS:
        if not _ring_fits(P, N, depth, args[0].element_size()):
            continue
        got = _launched("ssd_scan_pipelined", lambda: (
            pipeline.ssd_scan_pipelined(*args, depth=depth)))
        torch.testing.assert_close(got, want, **tol)


def test_ssd_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    x, dt, A, B, C = _ssd_inputs(gen, 2, 3, 64, 16, 32)
    k8 = lambda *a: pipeline.ssd_scan_pipelined(*a, depth=2)  # noqa: E731
    for fn in (ssd_scan, k8):
        with pytest.raises(ValueError):        # x bf16, dt/B/C fp32
            fn(x.bfloat16(), dt, A, B, C)
        with pytest.raises(ValueError):        # non-contiguous x
            fn(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, B, C)
        with pytest.raises(ValueError):        # B and C do not match
            fn(x, dt, A, B, C[:, :, :16].contiguous())
        with pytest.raises(ValueError):        # B of another batch size
            fn(x, dt, A, B[:1].contiguous(), C[:1].contiguous())
        with pytest.raises(ValueError):        # a state too large to hold
            fn(*_ssd_inputs(gen, 1, 1, 8, 256, 256))
    with pytest.raises(ValueError):            # no ring fits the B/C rows
        pipeline.ssd_scan_pipelined(*_ssd_inputs(gen, 1, 1, 64, 4, 780),
                                    depth=2)


def test_ops_route_k7_for_one_chunk_and_k8_for_more(gen):
    """K7 for one 16-position chunk (K8 not offered), else the kernel the
    schedule names; ``pipelined=False`` forces K7."""
    for S in (16, 40, 64, 65, 512):
        args = _ssd_inputs(gen, 1, 2, S, 64, 128)
        sched = schedule.ssd_schedule(1, S, 2, 64, 128, 4, _sms())
        assert (sched["pipe"] is None) is (S <= 16)
        got = _launched(sched["kernel"], lambda: ops.ssd_scan(*args))
        torch.testing.assert_close(got, ref.ssd_scan_ref(*args), **SSD_TOL)
    args = _ssd_inputs(gen, 1, 2, 512, 64, 128)
    _launched("ssd_scan", lambda: ops.ssd_scan(*args, pipelined=False))


def test_reduced_mamba2_cuda_backend_matches_torch_backend(gen):
    cfg = reduced(get_config("mamba2-2.7b"))
    cuda_m = get_model(cfg, lowering=LoweringConfig("cuda"))
    plain_m = get_model(cfg, lowering=LoweringConfig("torch"))
    params = cuda_m.init(0, "cuda")
    tokens = torch.randint(0, cfg.vocab, (2, 100), generator=gen,
                           device="cuda")
    d_in = cfg.ssm.expand * cfg.d_model
    kernel = LoweringConfig("cuda").lower(
        "ssd_scan", (2, 100, d_in // cfg.ssm.head_dim, cfg.ssm.head_dim,
                     cfg.ssm.d_state), torch.float32).schedule["kernel"]
    before = _build.KERNELS[kernel].launches
    got, gc = cuda_m.prefill(params, {"tokens": tokens})
    assert _build.KERNELS[kernel].launches - before == cfg.n_layers
    want, wc = plain_m.prefill(params, {"tokens": tokens})
    torch.testing.assert_close(got, want, atol=5e-5, rtol=1e-4)
    torch.testing.assert_close(gc["state"], wc["state"], atol=5e-5, rtol=1e-4)
    tok = torch.argmax(want, dim=-1).to(torch.int32)
    got, _ = cuda_m.decode_step(params, tok, gc, 100)
    want, _ = plain_m.decode_step(params, tok, wc, 100)
    torch.testing.assert_close(got, want, atol=5e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# int8 kernels K4, K5, K6
# ---------------------------------------------------------------------------

INT8_DTYPES = [torch.float32, torch.bfloat16, torch.float16]


def _int8_tol(x, wq, scale):
    """fp32: K ulps (2^-23) of the largest product |x|·|scale·wq|, the
    rounding of a K-term fp32 sum in either version's order, which a TF32
    or bf16 rounding of x exceeds many times over; bf16 and fp16: the
    reference's 0.5 / rtol 2e-2, whose output rounding dominates."""
    if x.dtype != torch.float32:
        return dict(atol=0.5, rtol=2e-2)
    big = float(x.abs().max()) * float((scale[:, None] * wq).abs().max())
    return dict(atol=x.shape[1] * big * 2.0 ** -23, rtol=0.0)


def _int8_inputs(gen, M, N, K, dtype):
    x = torch.randn((M, K), generator=gen, device="cuda").to(dtype)
    wq = torch.randint(-127, 128, (N, K), generator=gen, device="cuda",
                       dtype=torch.int8)
    scale = 0.001 + 0.019 * torch.rand((N,), generator=gen, device="cuda")
    return x, wq, scale


# M, N, K: ragged M, N and K around the plans' tiles (K4 64/128 rows x
# 64-256 columns, K5 8-32 x 64/128, k stages of 64), one row, llama110m's
# decode and prefill projections
INT8 = [(1, 1000, 768), (7, 1000, 768), (100, 1000, 768), (8, 768, 768),
        (8, 32000, 768), (512, 2048, 768), (65, 33, 2048), (3, 5, 16),
        (130, 70, 80)]


@pytest.mark.parametrize("dtype", INT8_DTYPES)
@pytest.mark.parametrize("M,N,K", INT8)
def test_int8_matmul_kernels(gen, M, N, K, dtype):
    x, wq, scale = _int8_inputs(gen, M, N, K, dtype)
    want = ref.int8_matmul_ref(x, wq, scale)
    tol = _int8_tol(x, wq, scale)
    got = _launched("int8_matmul", lambda: int8_matmul(x, wq, scale))
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, **tol)
    for depth in pipeline.DEPTHS:
        got = _launched("int8_matmul_pipelined", lambda: (
            pipeline.int8_matmul_pipelined(x, wq, scale, depth=depth)))
        torch.testing.assert_close(got, want, **tol)


@pytest.mark.parametrize("dtype", INT8_DTYPES)
@pytest.mark.parametrize("M,N,K", [(1, 7, 5), (7, 1000, 100), (100, 1000, 100),
                                   (64, 130, 1000)])
def test_int8_matmul_k4_takes_k_off_the_16_grid(gen, M, N, K, dtype):
    x, wq, scale = _int8_inputs(gen, M, N, K, dtype)
    got = _launched("int8_matmul", lambda: int8_matmul(x, wq, scale))
    torch.testing.assert_close(got, ref.int8_matmul_ref(x, wq, scale),
                               **_int8_tol(x, wq, scale))


def test_int8_route_falls_back_to_k4_where_k5_cannot_copy(gen):
    """K off the 16-byte grid goes to K4 even when K5 is asked for (K5 has
    no plan there, and refuses it itself); an operand off 16-byte alignment
    is copied and runs the kernel the schedule names.  A single 64-wide k
    step never pipelines."""
    x, wq, scale = _int8_inputs(gen, 8, 96, 100, torch.float32)
    got = _launched("int8_matmul", lambda: ops.int8_matmul(x, wq, scale,
                                                           pipelined=True))
    torch.testing.assert_close(got, ref.int8_matmul_ref(x, wq, scale),
                               **_int8_tol(x, wq, scale))
    x, wq, scale = _int8_inputs(gen, 8, 96, 768, torch.float32)
    buf = torch.empty(x.numel() + 1, device="cuda")
    xs = buf[1:].view(8, 768)          # contiguous, 4 bytes off alignment
    xs.copy_(x)
    assert xs.is_contiguous() and xs.data_ptr() % 16
    sched = schedule.int8_schedule(8, 768, 96, 4, _sms())
    got = _launched(sched["kernel"], lambda: ops.int8_matmul(xs, wq, scale))
    torch.testing.assert_close(got, ref.int8_matmul_ref(x, wq, scale),
                               **_int8_tol(x, wq, scale))
    x64, wq64, scale64 = _int8_inputs(gen, 8, 96, 64, torch.float32)
    _launched("int8_matmul", lambda: ops.int8_matmul(x64, wq64, scale64,
                                                     pipelined=True))
    with pytest.raises(ValueError):
        pipeline.int8_matmul_pipelined(*_int8_inputs(gen, 8, 96, 100,
                                                     torch.float32))
    x, wq, scale = _int8_inputs(gen, 8, 96, 768, torch.float32)
    _launched(sched["kernel"], lambda: ops.int8_matmul(x, wq, scale))
    _launched("int8_matmul", lambda: ops.int8_matmul(x, wq, scale,
                                                     pipelined=False))
    _launched("int8_matmul_pipelined", lambda: ops.int8_matmul(
        x, wq, scale, pipelined=True))
    _launched(sched["kernel"],
              lambda: LoweringConfig("cuda").int8_matmul(x, wq, scale))


def test_int8_wrappers_raise_on_what_the_kernels_do_not_take(gen):
    x, wq, scale = _int8_inputs(gen, 8, 64, 64, torch.float32)
    k5 = lambda *a: pipeline.int8_matmul_pipelined(*a, depth=2)  # noqa: E731
    for fn in (int8_matmul, k5):
        for args in ((x.double(), wq, scale), (x, wq.float(), scale),
                     (x, wq, scale.double()), (x, wq[:, :32], scale),
                     (x, wq, scale[:10]), (x.t(), wq, scale),
                     (x[:0], wq, scale), (x.to("meta"), wq, scale)):
            with pytest.raises(ValueError):
                fn(*args)
    with pytest.raises(ValueError):
        pipeline.int8_matmul_pipelined(x, wq, scale, depth=5)


# ragged M, N and K around the plans' tiles and stages (K 100 and 2050 off
# K5's 16-byte grid)
INT8_PLAN_M = (1, 7, 100, 513)
INT8_PLAN_N = (1000, 32000)
INT8_PLAN_K = (100, 768, 2048, 2050)


def _every_plan(gen, kernel, M, N, K, dtype):
    """Every plan ``kernel`` is built for at (M, N, K) against the plain
    version at ``_int8_tol``, each launched once, twice with the same bits
    (the split-K sum is deterministic)."""
    pipelined = kernel == "int8_matmul_pipelined"
    fn = pipeline.int8_matmul_pipelined if pipelined else int8_matmul
    x, wq, scale = _int8_inputs(gen, M, N, K, dtype)
    want = ref.int8_matmul_ref(x, wq, scale)
    tol = _int8_tol(x, wq, scale)
    plans = pipeline.int8_plans(M, N, K, x.element_size(),
                                pipelined=pipelined)
    assert pipeline.int8_plan(M, N, K, x.element_size(),
                              pipelined=pipelined) in plans
    for plan in plans:
        got = _launched(kernel, lambda: fn(x, wq, scale, _plan=plan))
        torch.testing.assert_close(got, want, **tol, msg=lambda m: f"{plan}: {m}")
        again = _launched(kernel, lambda: fn(x, wq, scale, _plan=plan))
        assert torch.equal(got, again), plan
    return plans


@pytest.mark.parametrize("dtype", INT8_DTYPES)
@pytest.mark.parametrize("K", INT8_PLAN_K)
@pytest.mark.parametrize("N", INT8_PLAN_N)
@pytest.mark.parametrize("M", INT8_PLAN_M)
def test_int8_k4_every_plan(gen, M, N, K, dtype):
    plans = _every_plan(gen, "int8_matmul", M, N, K, dtype)
    assert {p[2] for p in plans} == {s for s in pipeline.INT8_SPLITS
                                     if s <= -(-K // 64)}


@pytest.mark.parametrize("dtype", INT8_DTYPES)
@pytest.mark.parametrize("K", [k for k in INT8_PLAN_K if k % 16 == 0])
@pytest.mark.parametrize("N", INT8_PLAN_N)
@pytest.mark.parametrize("M", INT8_PLAN_M)
def test_int8_k5_every_plan(gen, M, N, K, dtype):
    plans = _every_plan(gen, "int8_matmul_pipelined", M, N, K, dtype)
    assert {p[2] for p in plans} == set(pipeline.INT8_SPLITS)


def test_int8_smem_mirrors_match_the_kernels(gen):
    """``k4_smem_bytes`` / ``k5_smem_bytes`` are the bytes the libraries
    ask for, at every plan."""
    k4, k5 = INT8_MATMUL, pipeline.INT8_MATMUL_PIPELINED
    for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
        itemsize = torch.tensor([], dtype=dtype).element_size()
        for K in (768, 2048, 4096):
            for plan in pipeline.int8_plans(512, 32000, K, itemsize,
                                            pipelined=False):
                assert k4.query("int8_matmul_smem", *plan, code) == \
                    pipeline.k4_smem_bytes(*plan, itemsize)
            for plan in pipeline.int8_plans(8, 32000, K, itemsize,
                                            pipelined=True):
                assert k5.query("int8_matmul_pipelined_smem", *plan, code,
                                K) == pipeline.k5_smem_bytes(*plan, itemsize,
                                                             K)


#: The K4 repeat test: (N, K) of llama110m's square projection, and the
#: runs of each plan.
K4_REPEAT_NK = (768, 768)
K4_REPEATS = 50


def k4_repeat_m(plan, N: int, sms: int) -> int:
    """Rows of x that give K4 under ``plan`` at least two blocks an SM:
    tiles x split >= 2 x the SMs (without a split the kernel is
    persistent, one block an SM walks the tiles; two share an SM only
    where the scheduler puts them there)."""
    tile_m, tile_n, split, _ = plan
    return tile_m * -(-2 * sms // (split * -(-N // tile_n)))


@pytest.mark.parametrize("dtype", INT8_DTYPES)
def test_int8_k4_repeats_where_blocks_share_an_sm(gen, dtype):
    """K4's ring releases a stage with one arrival a warp, the pattern
    that gave wrong tiles in a K5 design where two or more blocks shared
    an SM.  Every K4 plan at which the occupancy query puts two or more
    blocks on an SM runs 50 times at an M of at least 2 x SMs blocks:
    every run gives the first run's bits, within ``_int8_tol`` of the
    plain version.  (In fp32 no plan fits two blocks an SM: every plan
    must then report one.)"""
    from repro_torch.kernels.int8_matmul import k4_blocks_per_sm
    N, K = K4_REPEAT_NK
    itemsize = torch.tensor([], dtype=dtype).element_size()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    every = pipeline.int8_plans(1, N, K, itemsize, pipelined=False)
    per_sm = {p: k4_blocks_per_sm(p, dtype) for p in every}
    assert min(per_sm.values()) >= 1
    plans = [p for p in every if per_sm[p] >= 2]
    for plan in plans:
        x, wq, scale = _int8_inputs(gen, k4_repeat_m(plan, N, sms), N, K,
                                    dtype)
        first = int8_matmul(x, wq, scale, _plan=plan)
        torch.testing.assert_close(first, ref.int8_matmul_ref(x, wq, scale),
                                   **_int8_tol(x, wq, scale),
                                   msg=lambda m: f"{plan}: {m}")
        for i in range(K4_REPEATS - 1):
            again = int8_matmul(x, wq, scale, _plan=plan)
            assert torch.equal(again, first), (plan, i + 1)


def test_int8_k5_refuses_what_its_tma_cannot_copy(gen):
    """K5 raises at K % 16 != 0 and on operands off 16-byte alignment, and
    on a plan it is not built for; K4 takes all of them."""
    for K in (100, 2050):
        x, wq, scale = _int8_inputs(gen, 8, 96, K, torch.float32)
        with pytest.raises(ValueError):
            pipeline.int8_matmul_pipelined(x, wq, scale)
        _launched("int8_matmul", lambda: int8_matmul(x, wq, scale))
    x, wq, scale = _int8_inputs(gen, 8, 96, 768, torch.float32)
    buf = torch.empty(x.numel() + 1, device="cuda")
    xs = buf[1:].view(8, 768)
    xs.copy_(x)
    wbuf = torch.empty(wq.numel() + 8, device="cuda", dtype=torch.int8)
    ws = wbuf[8:].view(96, 768)
    ws.copy_(wq)
    for args in ((xs, wq, scale), (x, ws, scale)):
        with pytest.raises(ValueError):
            pipeline.int8_matmul_pipelined(*args)
        got = _launched("int8_matmul", lambda: int8_matmul(*args))
        torch.testing.assert_close(got, ref.int8_matmul_ref(x, wq, scale),
                                   **_int8_tol(x, wq, scale))
    for plan in ((8, 32, 1, 2), (8, 64, 3, 2), (8, 64, 1, 5), (64, 64, 1, 2)):
        with pytest.raises(ValueError):
            pipeline.int8_matmul_pipelined(x, wq, scale, _plan=plan)
    for plan in ((32, 64, 1, 2), (128, 256, 1, 2), (64, 64, 16, 2),
                 (128, 128, 1, 5)):
        with pytest.raises(ValueError):
            int8_matmul(x, wq, scale, _plan=plan)


def _int8kv_cuda(gen, B, S, H, K, T, hd, dtype):
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
    kf = torch.randn((B, T, K, hd), generator=gen, device="cuda")
    vf = torch.randn((B, T, K, hd), generator=gen, device="cuda")
    ks = kf.abs().amax(dim=(0, 1, 3)) / 127.0
    vs = vf.abs().amax(dim=(0, 1, 3)) / 127.0
    k8 = torch.round(kf / ks[None, None, :, None]).clamp(-127, 127)
    v8 = torch.round(vf / vs[None, None, :, None]).clamp(-127, 127)
    return q, kf, vf, k8.to(torch.int8), v8.to(torch.int8), ks, vs


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("B,S,T,H,K,hd", FLASH)
def test_flash_int8kv_kernel(gen, B, S, T, H, K, hd, dtype, mask_kind):
    """K6 at its rule's plan and at every plan it takes (split 1/2/4), each
    with its live tiles counted."""
    q, kf, vf, k8, v8, ks, vs = _int8kv_cuda(gen, B, S, H, K, T, hd, dtype)
    mask = _mask(gen, mask_kind, B, S, T, hd)
    scale = hd ** -0.5
    want = ref.flash_attention_int8kv_ref(q, k8, v8, ks, vs, mask,
                                          sm_scale=scale)
    tol = (dict(atol=2e-5, rtol=1e-4) if dtype == torch.float32
           else _tol(dtype))
    fp = ref.flash_attention_ref(q, kf, vf, mask, sm_scale=scale)
    plans = [None, *pipeline.int8kv_plans(B, S, T, H, K, hd, dtype)]
    assert len(plans) >= 4
    for plan in plans:
        got = _live_counted(
            "flash_attention_int8kv", lambda n: flash_attention_int8kv(
                q, k8, v8, ks, vs, mask, sm_scale=scale, live_count=n,
                _plan=plan), mask, B, H, hd)
        torch.testing.assert_close(got, want, **tol)
        _zero_where_no_key(got, mask)
        if dtype == torch.float32:
            assert float((got - fp).abs().max()) < 0.1


@pytest.mark.parametrize("dtype", FLOATS)
@pytest.mark.parametrize("B,S,T,H,K,hd", [(1, 512, 512, 12, 12, 64),
                                          (1, 256, 256, 8, 1, 256),
                                          (2, 150, 333, 4, 4, 96)])
def test_flash_int8kv_split_plans_repeat_their_bits(gen, B, S, T, H, K, hd,
                                                    dtype):
    """A q tile's keys split over a cluster are combined in rank order: 50
    runs of each split plan give the first run's bits."""
    q, _, _, k8, v8, ks, vs = _int8kv_cuda(gen, B, S, H, K, T, hd, dtype)
    mask = _mask(gen, "causal", B, S, T, hd)
    for plan in pipeline.int8kv_plans(B, S, T, H, K, hd, dtype):
        if plan[0] == 1:
            continue
        def call():
            return flash_attention_int8kv(q, k8, v8, ks, vs, mask,
                                          sm_scale=hd ** -0.5, _plan=plan)
        first = call()
        assert all(torch.equal(call(), first) for _ in range(49)), plan


def test_flash_int8kv_smem_mirror_matches_the_kernel(gen):
    """``pipeline.int8kv_smem_bytes`` against the kernel's own count."""
    from repro_torch.kernels.flash_attention import (DTYPE_CODES,
                                                     FLASH_ATTENTION_INT8KV)
    for hd, dtype in itertools.product((6, 16, 32, 64, 80, 128, 256), FLOATS):
        item = torch.empty((), dtype=dtype).element_size()
        assert FLASH_ATTENTION_INT8KV.query(
            "flash_attention_int8kv_smem", hd, DTYPE_CODES[dtype]) \
            == pipeline.int8kv_smem_bytes(hd, item), (hd, dtype)


def test_flash_int8kv_wrapper_raises_on_what_the_kernel_does_not_take(gen):
    q, _, _, k8, v8, ks, vs = _int8kv_cuda(gen, 1, 64, 4, 2, 64, 64,
                                           torch.float32)
    mask = torch.ones((1, 64, 64), dtype=torch.bool, device="cuda")
    for args in ((q, k8.float(), v8.float(), ks, vs, mask),
                 (q, k8, v8, ks[:1], vs, mask),
                 (q, k8, v8, ks, vs.double(), mask),
                 (q.repeat(1, 1, 1, 5), k8.repeat(1, 1, 1, 5),
                  v8.repeat(1, 1, 1, 5), ks, vs, mask),          # hd 320
                 (q.double(), k8, v8, ks, vs, mask)):
        with pytest.raises(ValueError):
            flash_attention_int8kv(*args, sm_scale=0.125)
    # plans it is not built for: splits other than 1/2/4, rings other than 2
    for plan in ((3, 2), (8, 2), (2, 1), (2, 3), (2, 4)):
        with pytest.raises(ValueError):
            flash_attention_int8kv(q, k8, v8, ks, vs, mask, sm_scale=0.125,
                                   _plan=plan)


# ---------------------------------------------------------------------------
# The paged decode makes no host sync
# ---------------------------------------------------------------------------

def test_paged_decode_runs_under_sync_debug_error(gen):
    """One call of ``attention_decode_paged`` on the card under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises at any host
    sync, gives the same output and pools as outside it (but for the
    spare page, where the inactive slots' writes collide)."""
    from repro_torch.models import layers
    from repro_torch.models.transformer import layer_params
    from repro_torch.serve.kv_cache import PagedKVCache
    cfg = reduced(get_config("llama110m"))
    lw = LoweringConfig("cuda")
    params = get_model(cfg, lowering=lw).init(0, "cuda")
    cache = PagedKVCache(cfg, max_batch=4, page_size=16, n_pages=16,
                         max_len=64, device=torch.device("cuda"))
    for slot, n in ((0, 20), (2, 63)):
        cache.bind_slot(slot, n + 1)
        cache.seq_lens[slot] = n
    pt, sl, act = cache.device_views({0, 2})
    x = torch.randn((4, 1, cfg.d_model), generator=gen, device="cuda")
    attn = layer_params(params["blocks"], 0)["attn"]
    kp, vp = cache.k_pages[0], cache.v_pages[0]
    pools = (kp.clone(), vp.clone())
    want, _, _ = layers.attention_decode_paged(attn, x, cfg, *pools, pt, sl,
                                               act, lowering=lw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got, _, _ = layers.attention_decode_paged(attn, x, cfg, kp, vp, pt,
                                                  sl, act, lowering=lw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(kp[:-1], pools[0][:-1])
    assert torch.equal(vp[:-1], pools[1][:-1])


# ---------------------------------------------------------------------------
# The compiler on the card: routes run their records' kernels, and the
# e-graph's offloaded programs evaluate on the kernels
# ---------------------------------------------------------------------------

RECORD_KEYS = [
    ("attention", (1, 512, 12, 12, 512, 64), torch.float32),
    ("attention", (1, 256, 4, 4, 256, 64), torch.bfloat16),
    ("attention", (2, 64, 4, 2, 64, 32), torch.float16),
    ("rmsnorm", (512, 768), torch.float32),
    ("int8_matmul", (8, 768, 2048), torch.float32),
    ("int8_matmul", (512, 768, 768), torch.bfloat16),
    ("ssd_scan", (1, 100, 4, 64, 128), torch.float32),
    ("ssd_scan", (1, 16, 4, 64, 128), torch.float32),
    ("fps", (2, 4096, 512), torch.float32),
    ("ball_query", (2, 4096, 512, 16), torch.float32),
    ("ball_query", (1, 256, 64, 8), torch.float32),
    ("group_aggregate", (16, 1024, 512, 32, 64), torch.float32),
    ("group_aggregate", (2, 4096, 512, 16, 64), torch.float32),
]


def _record_inputs(gen, op, shape, dtype):
    """Inputs of one key on the card and the record's route call."""
    r = lambda *s: torch.randn(s, generator=gen, device="cuda")  # noqa: E731
    if op == "attention":
        B, S, H, K, T, hd = shape
        mask = torch.tril(torch.ones((S, T), dtype=torch.bool,
                                     device="cuda"))[None]
        return (r(B, S, H, hd).to(dtype), r(B, T, K, hd).to(dtype),
                r(B, T, K, hd).to(dtype), mask), {"sm_scale": hd ** -0.5}
    if op == "rmsnorm":
        return (r(*shape).to(dtype), r(shape[1])), {}
    if op == "int8_matmul":
        x, wq, scale = _int8_inputs(gen, shape[0], shape[2], shape[1], dtype)
        return (x, wq, scale), {}
    if op == "ssd_scan":
        return _ssd_inputs(gen, shape[0], shape[2], shape[1], shape[3],
                           shape[4]), {}
    if op == "fps":
        return (_points(gen, shape[0], shape[1], dtype), shape[2]), {}
    xyz = _points(gen, shape[0], shape[1], dtype)
    if op == "ball_query":
        return (xyz, xyz[:, :shape[2]].contiguous(), 0.5, shape[3]), {}
    B, N, M, k, C = shape
    idx = torch.randint(0, N, (B, M, k), generator=gen, device="cuda",
                        dtype=torch.int32)
    return (r(B, N, C).to(dtype), idx), {}


@pytest.mark.parametrize("op,shape,dtype", RECORD_KEYS)
def test_route_launches_the_kernel_its_record_names(gen, op, shape, dtype):
    """The record's kernel function, given the record's schedule (FPS has
    one kernel, whose wrapper takes fps_plan's plan itself), launches
    exactly the kernel the schedule names, once, and computes what the
    route computes without a schedule (the same kernel, plan and depth)."""
    rec = LoweringConfig("cuda").lower(op, shape, dtype)
    assert rec.impl == "isax", rec.note
    args, kw = _record_inputs(gen, op, shape, dtype)
    sched = {} if op == "fps" else {"schedule": rec.schedule}
    got = _launched(rec.schedule["kernel"], lambda: rec.kernel_fn(
        *args, **kw, **sched))
    again = _launched(rec.schedule["kernel"],
                      lambda: rec.kernel_fn(*args, **kw))
    assert torch.equal(got, again)


@pytest.mark.parametrize("B,N,M,k,C,dtype", [
    (2, 4096, 512, 16, 64, "float32"), (16, 1024, 512, 32, 64, "float32"),
    (16, 1024, 512, 32, 64, "bfloat16"), (16, 512, 128, 64, 128, "float32")])
def test_group_schedule_reads_the_built_kernels_registers(gen, monkeypatch, B,
                                                          N, M, k, C, dtype):
    """On the card the K12/K13 model takes each instantiation's registers
    from the build's ptxas log; at the route phase's group shapes, whose
    picks the CPU tests pin, the counts the CPU uses (GROUP_REGS) give the
    same schedule, cycles and all."""
    itemsize = torch.empty((), dtype=getattr(torch, dtype)).element_size()
    sms = pipeline.sm_count("cuda")
    built = schedule.group_schedule.__wrapped__(B, N, M, k, C, itemsize, sms)
    for kernel, part in (("group_aggregate", "base"),
                         ("group_aggregate_pipelined", "pipe")):
        if built[part] is not None:
            plan = built[part]["plan"]
            regs, _ = pck.group_ptxas(kernel, dtype, C, plan)
            assert schedule.group_regs(kernel, itemsize, C, plan) >= regs > 0
    monkeypatch.setattr(schedule, "group_regs",
                        lambda kernel, *_: schedule.GROUP_REGS[kernel])
    assert schedule.group_schedule.__wrapped__(B, N, M, k, C, itemsize,
                                               sms) == built


@pytest.mark.parametrize("kind", ["attention", "int8_matmul", "ssd_scan",
                                  "rmsnorm", "fps", "ball_query",
                                  "group_aggregate"])
def test_offloaded_program_evaluates_on_the_kernels(gen, kind):
    """Each target ISAX's trace program, compiled and evaluated with the
    intrinsics bound to the CUDA kernels, equals the software program
    under the numpy evaluators (exact for indices and the max-pool, the
    reference's atol 1e-5 / rtol 1e-4 for floats), through one kernel of
    the ISAX's pair."""
    from repro_torch.core.offload import compile_program, evaluate
    from repro_torch.kernels.ops import kernel_intrinsics
    from repro_torch.pointcloud.ops import pointcloud_intrinsics
    from repro_torch.targets import cases, default_registry
    reg = default_registry()
    isax = cases.CASES[kind][0]
    prog = reg.spec_for_kind(kind).trace_program()
    res = compile_program(prog, reg.isaxes(), case=kind)
    assert isax in res.stats.matched_isaxes
    sw = cases.environment(kind)
    hw = cases.copy_env(sw)
    evaluate(prog, sw)
    before = dict(_build.launch_counts())
    evaluate(res.program, hw, intrinsics={**kernel_intrinsics("cuda"),
                                          **pointcloud_intrinsics("cuda")})
    torch.cuda.synchronize()
    ran = {n for n, c in _build.launch_counts().items() if c > before[n]}
    assert ran and {n.removesuffix("_pipelined") for n in ran} == {
        {"flash_attention": "flash_attention", "int8_matvec": "int8_matmul",
         "ssd_step": "ssd_scan", "rmsnorm": "rmsnorm", "fps": "fps",
         "ball_query": "ball_query", "group_agg": "group_aggregate"}[isax]}
    cases.compare(kind, sw, hw)


# ---------------------------------------------------------------------------
# Training on the card: plain torch ops (backend "torch"); the kernel
# routes refuse autograd
# ---------------------------------------------------------------------------

def test_train_step_on_the_card_matches_the_cpu(gen):
    """One Trainer step of reduced llama110m on the card against the same
    step on the CPU from the same weights: loss, grad_norm and the updated
    weights at the fp32 tolerance."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import TrainConfig, Trainer
    from repro_torch.tree import tree_leaves
    cfg = reduced(get_config("llama110m"))
    tc = TrainConfig(batch=4, seq=32, total_steps=1,
                     optimizer=AdamWConfig(lr=1e-3))
    params = get_model(cfg).init(0, "cpu")
    runs = [Trainer(cfg, tc, params=params, device=d) for d in ("cpu", "cuda")]
    for tr in runs:
        tr.train(1)
    (cpu, card) = (tr.metrics_log[0] for tr in runs)
    for key in ("loss", "grad_norm"):
        assert card[key] == pytest.approx(cpu[key], rel=2e-4, abs=2e-5)
    for a, b in zip(tree_leaves(runs[1].params), tree_leaves(runs[0].params)):
        torch.testing.assert_close(a.cpu(), b, atol=2e-5, rtol=2e-4)


def test_guard_raises_at_a_real_k1_launch(gen):
    """Under autograd the K1 route raises before it launches; under
    no_grad it launches."""
    x = torch.randn((8, 768), generator=gen, device="cuda")
    g = torch.ones(768, device="cuda")
    before = _build.KERNELS["rmsnorm"].launches
    with pytest.raises(RuntimeError, match="rmsnorm: the hand-written "
                                           "kernels have no gradient"):
        ops.rmsnorm(x.requires_grad_(True), g)
    assert _build.KERNELS["rmsnorm"].launches == before
    with torch.no_grad():
        got = ops.rmsnorm(x, g)
    torch.cuda.synchronize()
    assert _build.KERNELS["rmsnorm"].launches == before + 1
    torch.testing.assert_close(got, ref.rmsnorm_ref(x.detach(), g),
                               atol=2e-5, rtol=2e-4)
    model = get_model(reduced(get_config("llama110m")),
                      lowering=LoweringConfig("cuda"))
    params = model.init(0, "cuda")
    for p in (params["final_norm"]["scale"],):
        p.requires_grad_(True)
    tokens = torch.zeros((2, 16), dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="no gradient"):
        model.loss(params, {"tokens": tokens, "labels": tokens})


# ---------------------------------------------------------------------------
# K14: paged decode attention
# ---------------------------------------------------------------------------

def _paged_inputs(gen, B, H, K, hd, page, P, dtype, lens, active,
                  shared=False):
    """Pools of B·P pages (+ the spare), each slot's table row a random
    set of them (with ``shared``, every other slot's row names the pages
    of the slot before it, in another order)."""
    N = B * P
    q = torch.randn((B, 1, H, hd), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((N + 1, page, K, hd), generator=gen,
                     device="cuda").to(dtype)
    vp = torch.randn((N + 1, page, K, hd), generator=gen,
                     device="cuda").to(dtype)
    pt = torch.randperm(N, generator=gen, device="cuda").reshape(B, P)
    if shared:
        for b in range(1, B, 2):
            pt[b] = pt[b - 1][torch.randperm(P, generator=gen,
                                             device="cuda")]
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    act = torch.tensor(active, dtype=torch.bool, device="cuda")
    return q, kp, vp, pt.int().contiguous(), sl, act


def _gather_sdpa(q, kp, vp, pt, sl):
    """The plain path (layers.attention_decode_paged on CPU tensors):
    every slot's whole page range gathered, masked, ``_sdpa_xla``."""
    from repro_torch.models import layers
    B, P = pt.shape
    page, hd = kp.shape[1], kp.shape[3]
    kg = kp[pt.long()].reshape(B, P * page, *kp.shape[2:])
    vg = vp[pt.long()].reshape(B, P * page, *vp.shape[2:])
    mask = (torch.arange(P * page, device=q.device)[None, None, :]
            <= sl[:, None, None])
    return layers._sdpa_xla(q, kg, vg, mask, hd)


def _lens(span, B, gen):
    """0, 15, 16, 17, one short of the table, the last position, past the
    table, then random lengths."""
    fixed = [0, 15, 16, 17, span - 2, span - 1, span + 40]
    rest = torch.randint(0, span, (max(0, B - len(fixed)),), generator=gen,
                         device="cuda").tolist()
    return (fixed + rest)[:B]


PAGED_CASES = [
    # name, B, H, K, hd, page, P, dtype
    ("granite-chat", 128, 32, 8, 128, 16, 96, torch.bfloat16),
    ("granite-rag", 32, 32, 8, 128, 16, 256, torch.bfloat16),
    ("llama110m", 8, 12, 12, 64, 16, 34, torch.float32),
    ("fp16-gqa", 12, 16, 2, 128, 16, 40, torch.float16),
    ("hd256-fp32", 6, 8, 1, 256, 8, 20, torch.float32),
    ("hd16-page4", 10, 4, 1, 16, 4, 9, torch.float32),
    # groups that are not a power of two run a padded group of query rows
    ("group6-bf16", 16, 48, 8, 128, 16, 40, torch.bfloat16),
    ("group3-fp32", 9, 12, 4, 64, 16, 20, torch.float32),
    ("group7-fp16", 7, 28, 4, 128, 16, 24, torch.float16),
]


@pytest.mark.parametrize("case", PAGED_CASES, ids=[c[0] for c in PAGED_CASES])
def test_paged_decode_kernel_matches_the_gather_path(gen, case):
    """K14 against the plain gather + ``_sdpa_xla`` path at the reference's
    tolerances (fp32 2e-5 / 2e-4, 16-bit 2e-2), over lengths 0, 15, 16,
    17, one short of the table and past it, table rows that name other
    slots' pages, and inactive slots, whose rows must be zero; and within
    the same tolerance of the plain version's fp32 arithmetic."""
    _, B, H, K, hd, page, P, dtype = case
    span = P * page
    lens = _lens(span, B, gen)
    active = [b % 5 != 3 for b in range(B)]
    q, kp, vp, pt, sl, act = _paged_inputs(gen, B, H, K, hd, page, P, dtype,
                                           lens, active, shared=True)
    before = pdk.PAGED_DECODE.launches
    got = pdk.paged_decode_attention(q, kp, vp, pt, sl, act,
                                     sm_scale=hd ** -0.5)
    torch.cuda.synchronize()
    assert pdk.PAGED_DECODE.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    rows = act.nonzero().flatten()
    want = _gather_sdpa(q, kp, vp, pt, sl)
    torch.testing.assert_close(got[rows], want[rows], **_tol(dtype))
    plain = ref.paged_decode_ref(q, kp, vp, pt, sl, act, sm_scale=hd ** -0.5)
    torch.testing.assert_close(got, plain, **_tol(dtype))
    assert bool((got[~act] == 0).all())


#: (name, H, K, hd, page, P, dtype) of the split-count test: a range of
#: 4096 positions, long enough for every split count the planner has.
SPLIT_CASES = [("granite", 32, 8, 128, 16, 256, torch.bfloat16),
               ("llama110m", 12, 12, 64, 16, 256, torch.float32),
               ("group6-fp16", 48, 8, 128, 16, 256, torch.float16)]


def _slots_for(splits, K, span, hd, itemsize, sms):
    """A slot count (up to 256) for which ``split_plan`` picks ``splits``
    on this card, the one next to the planner's boundary (the fewest for
    one split, else the most), or None."""
    Bs = [B for B in range(1, 257)
          if pdk.split_plan(B, K, span, hd, itemsize, sms)[0] == splits]
    return (min(Bs) if splits == 1 else max(Bs)) if Bs else None


@pytest.mark.parametrize("case", SPLIT_CASES, ids=[c[0] for c in SPLIT_CASES])
@pytest.mark.parametrize("splits", [1, 2, 4, 8, 16])
def test_paged_decode_every_split_count(gen, case, splits):
    """Every split count the planner can choose, reached by the number of
    slots alone (the planner's own chunks): right against the plain
    version, and the same bits over 20 runs (a fixed merge order, no
    atomics)."""
    from repro_torch.kernels.pipeline import sm_count
    _, H, K, hd, page, P, dtype = case
    span = P * page
    item = torch.empty((), dtype=dtype).element_size()
    B = _slots_for(splits, K, span, hd, item, sm_count(torch.device("cuda")))
    assert B is not None, f"no slot count gives {splits} splits"
    lens = _lens(span, B, gen)
    active = [b % 4 != 2 for b in range(B)]
    args = _paged_inputs(gen, B, H, K, hd, page, P, dtype, lens, active)
    first = pdk.paged_decode_attention(*args, sm_scale=hd ** -0.5)
    torch.testing.assert_close(
        first, ref.paged_decode_ref(*args, sm_scale=hd ** -0.5),
        **_tol(dtype))
    for _ in range(20):
        again = pdk.paged_decode_attention(*args, sm_scale=hd ** -0.5)
        assert torch.equal(again, first)


def test_paged_decode_planner_picks_at_the_cells(gen):
    """The plan the wrapper runs at the granite cells' shapes."""
    from repro_torch.kernels.pipeline import sm_count
    sms = sm_count(torch.device("cuda"))
    assert pdk.split_plan(128, 8, 1536, 128, 2, sms) == (1, 1536)
    assert pdk.split_plan(32, 8, 4096, 128, 2, sms)[0] > 1


def test_paged_decode_captures_in_a_cuda_graph(gen):
    """One call captured in a CUDA graph (which refuses a host sync) and
    replayed after the lengths, the table and the active set changed in
    place: the replay equals a fresh call."""
    B, H, K, hd, page, P = 32, 32, 8, 128, 16, 256
    lens = _lens(P * page, B, gen)
    q, kp, vp, pt, sl, act = _paged_inputs(
        gen, B, H, K, hd, page, P, torch.bfloat16, lens,
        [True] * B)
    pdk.paged_decode_attention(q, kp, vp, pt, sl, act, sm_scale=hd ** -0.5)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pdk.paged_decode_attention(q, kp, vp, pt, sl, act,
                                         sm_scale=hd ** -0.5)
    sl.copy_(torch.flip(sl, (0,)))
    act.copy_(torch.arange(B, device="cuda") % 3 != 0)
    pt.copy_(torch.flip(pt, (0,)))
    graph.replay()
    torch.cuda.synchronize()
    want = pdk.paged_decode_attention(q, kp, vp, pt, sl, act,
                                      sm_scale=hd ** -0.5)
    assert torch.equal(out, want)


def test_paged_decode_refuses_before_launching(gen):
    args = list(_paged_inputs(gen, 4, 8, 2, 80, 16, 4, torch.bfloat16,
                              [3, 5, 7, 9], [True] * 4))
    before = pdk.PAGED_DECODE.launches
    with pytest.raises(ValueError, match="head dim"):
        pdk.paged_decode_attention(*args, sm_scale=0.1)
    args = list(_paged_inputs(gen, 4, 8, 2, 64, 16, 4, torch.bfloat16,
                              [3, 5, 7, 9], [True] * 4))
    args[3] = args[3].long()
    with pytest.raises(ValueError, match="int32"):
        pdk.paged_decode_attention(*args, sm_scale=0.1)
    assert pdk.PAGED_DECODE.launches == before


@pytest.mark.parametrize("arch", ["llama110m", "granite-3-8b"])
def test_paged_decode_layer_routes_to_k14(gen, arch):
    """``attention_decode_paged`` on backend cuda launches K14 once and
    matches backend torch's gather path on the active slots (reduced
    widths, the config's dtype); the pools' writes are the same."""
    import dataclasses
    from repro_torch.models import layers
    from repro_torch.models.transformer import layer_params
    from repro_torch.serve.kv_cache import PagedKVCache
    cfg = reduced(get_config(arch))
    cfg = dataclasses.replace(cfg, compute_dtype="bfloat16") \
        if arch != "llama110m" else cfg
    lw = LoweringConfig("cuda")
    params = get_model(cfg, lowering=lw).init(0, "cuda")
    cache = PagedKVCache(cfg, max_batch=6, page_size=16, n_pages=24,
                         max_len=64, device=torch.device("cuda"))
    for slot, n in ((0, 0), (1, 17), (3, 63), (4, 30)):
        cache.bind_slot(slot, n + 1)
        cache.seq_lens[slot] = n
    pt, sl, act = cache.device_views({0, 1, 3, 4})
    x = torch.randn((6, 1, cfg.d_model), generator=gen, device="cuda")
    attn = layer_params(params["blocks"], 0)["attn"]
    kp, vp = cache.k_pages[0], cache.v_pages[0]
    pools = (kp.clone(), vp.clone())
    before = pdk.PAGED_DECODE.launches
    got, _, _ = layers.attention_decode_paged(attn, x, cfg, kp, vp, pt, sl,
                                              act, lowering=lw)
    torch.cuda.synchronize()
    assert pdk.PAGED_DECODE.launches == before + 1
    want, _, _ = layers.attention_decode_paged(
        attn, x, cfg, *pools, pt, sl, act, lowering=LoweringConfig("torch"))
    torch.cuda.synchronize()
    assert pdk.PAGED_DECODE.launches == before + 1
    rows = act.nonzero().flatten()
    torch.testing.assert_close(got[rows], want[rows],
                               **_tol(layers.dtype_of(cfg.compute_dtype)))
    assert torch.equal(kp[:-1], pools[0][:-1])
    assert torch.equal(vp[:-1], pools[1][:-1])

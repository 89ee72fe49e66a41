"""K14, the paged decode attention kernel, where no card is needed: its
split planner as a pure function of the shapes, the wrapper's refusals,
its plain version against a slot-by-slot loop, and
``layers.attention_decode_paged`` on CPU tensors still the gather and
``sdpa`` path, bit for bit the oracle of tests/test_torch_serve.py.  The
kernel itself is held to these on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
from test_torch_serve import _old_attention_decode_paged

from repro_torch.compile.config import LoweringConfig
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.kernels import paged_decode as pdk
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.models.registry import get_model
from repro_torch.models.transformer import layer_params

# ---------------------------------------------------------------------------
# split_plan
# ---------------------------------------------------------------------------

#: (B, K, span, hd, itemsize) → (splits, chunk): granite's chat and rag
#: cells, llama110m's serve phase (chip_smoke.py), a lone slot.
PINNED = [((128, 8, 1536, 128, 2), (1, 1536)),
          ((32, 8, 4096, 128, 2), (4, 1024)),
          ((8, 12, 544, 64, 4), (2, 288)),
          ((1, 8, 4096, 128, 2), (16, 256)),
          ((1, 1, 65536, 256, 4), (16, 4096)),
          ((4, 1, 64, 16, 4), (1, 128))]


@pytest.mark.parametrize("shape,want", PINNED)
def test_split_plan_picks(shape, want):
    assert pdk.split_plan(*shape) == want


def test_split_plan_covers_the_range_in_whole_tiles():
    """Over a grid of slots, KV heads, ranges, head dims and item sizes:
    at most 16 splits that tile the range, each a whole number of the
    kernel's tiles, none empty; one split once the blocks fill the card's
    resident ones or a split would fall under 256 keys."""
    for B in (1, 4, 32, 128):
        for K in (1, 8):
            for span in (16, 544, 1536, 4096, 65536):
                for hd in (16, 128, 256):
                    for item in (2, 4):
                        s, chunk = pdk.split_plan(B, K, span, hd, item)
                        tk = pdk.tile_keys(hd, item)
                        assert chunk % tk == 0
                        assert s * chunk >= span > (s - 1) * chunk
                        assert 1 <= s <= pdk.MAX_SPLITS
                        if (B * K >= pdk.BLOCKS_PER_SM * 132
                                or span < 2 * pdk.MIN_SPLIT_KEYS):
                            assert s == 1


def test_split_plan_reads_only_its_arguments():
    """The same shapes give the same plan whatever the card (its SM count
    is an argument) and the model's name is not one."""
    assert pdk.split_plan(32, 8, 4096, 128, 2, sms=132) == (4, 1024)
    assert pdk.split_plan(32, 8, 4096, 128, 2, sms=66) == (2, 2048)
    assert pdk.split_plan(32, 8, 4096, 128, 2, sms=16) == (1, 4096)


def test_tile_keys_fill_16_kb_of_k_and_v():
    for hd in pdk.HEAD_DIMS:
        for item in (2, 4):
            assert 2 * pdk.tile_keys(hd, item) * hd * item == 16384


# ---------------------------------------------------------------------------
# The wrapper's refusals (checked on CPU tensors; on the card they raise
# before any launch)
# ---------------------------------------------------------------------------

def _args(B=3, H=8, K=2, hd=64, page=4, P=3, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    N = B * P
    q = torch.randn((B, 1, H, hd), generator=g).to(dtype)
    kp = torch.randn((N + 1, page, K, hd), generator=g).to(dtype)
    vp = torch.randn((N + 1, page, K, hd), generator=g).to(dtype)
    pt = torch.arange(N, dtype=torch.int32).reshape(B, P)
    sl = torch.tensor([0, 5, 100][:B] + [3] * max(0, B - 3),
                      dtype=torch.int32)
    act = torch.ones(B, dtype=torch.bool)
    return [q, kp, vp, pt, sl, act]


def _bad(name):
    a = _args()
    q, kp, vp, pt, sl, act = a
    if name == "float64":
        a[:3] = [t.double() for t in a[:3]]
    elif name == "int8_pools":
        a[1], a[2] = kp.to(torch.int8), vp.to(torch.int8)
    elif name == "mixed_dtypes":
        a[1] = kp.bfloat16()
    elif name == "hd80":
        a = _args(hd=80)
    elif name == "hd512":
        a = _args(hd=512)
    elif name == "two_query_rows":
        a[0] = torch.cat([q, q], dim=1)
    elif name == "H_not_a_multiple_of_K":
        a = _args(H=6, K=4)
    elif name == "group_of_16":
        a = _args(H=16, K=1)
    elif name == "pools_differ":
        a[2] = vp[:-1]
    elif name == "pool_head_dim":
        a[1] = kp[..., :32].contiguous()
    elif name == "table_rows":
        a[3] = pt[:-1]
    elif name == "seq_lens_shape":
        a[4] = sl[:, None]
    elif name == "active_shape":
        a[5] = act[:-1]
    elif name == "int64_table":
        a[3] = pt.long()
    elif name == "int64_seq_lens":
        a[4] = sl.long()
    elif name == "uint8_active":
        a[5] = act.to(torch.uint8)
    elif name == "strided_q":
        a[0] = q.transpose(2, 3).contiguous().transpose(2, 3)
    elif name == "strided_pool":
        a[1] = kp.transpose(0, 1).contiguous().transpose(0, 1)
    elif name == "strided_table":
        a[3] = pt.t().contiguous().t()
    elif name == "misaligned_q":
        a[0] = torch.empty(q.numel() + 1)[1:].view(q.shape)
    return a


REFUSED = ["float64", "int8_pools", "mixed_dtypes", "hd80", "hd512",
           "two_query_rows", "H_not_a_multiple_of_K", "group_of_16",
           "pools_differ", "pool_head_dim", "table_rows", "seq_lens_shape",
           "active_shape", "int64_table", "int64_seq_lens", "uint8_active",
           "strided_q", "strided_pool", "strided_table", "misaligned_q"]


@pytest.mark.parametrize("name", REFUSED)
def test_check_args_refuses(name):
    with pytest.raises(ValueError, match="paged_decode"):
        pdk.check_args(*_bad(name))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("hd", pdk.HEAD_DIMS)
def test_check_args_takes_what_the_kernel_is_built_for(dtype, hd):
    pdk.check_args(*_args(hd=hd, dtype=dtype))
    pdk.check_args(*_args(H=8, K=1, hd=hd, dtype=dtype))


def test_no_kernel_for_another_device():
    a = [t.to("meta") for t in _args()]
    with pytest.raises(ValueError, match="no kernel for device"):
        pdk.paged_decode_attention(*a, sm_scale=0.125)


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _loop_ref(q, kp, vp, pt, sl, act, sm_scale):
    """Slot by slot in float64: the keys at positions 0 .. min(len, P·page
    − 1) through the table, softmax, P·V; inactive slots 0."""
    B, _, H, hd = q.shape
    page, K = kp.shape[1], kp.shape[2]
    P = pt.shape[1]
    out = torch.zeros((B, 1, H, hd), dtype=torch.float64)
    for b in range(B):
        if not act[b]:
            continue
        n = min(int(sl[b]), P * page - 1) + 1
        idx = [(int(pt[b, t // page]), t % page) for t in range(n)]
        k = torch.stack([kp[p, r] for p, r in idx]).double()    # (n, K, hd)
        v = torch.stack([vp[p, r] for p, r in idx]).double()
        for h in range(H):
            s = (k[:, h // (H // K)] @ q[b, 0, h].double()) * sm_scale
            out[b, 0, h] = torch.softmax(s, 0) @ v[:, h // (H // K)]
    return out


@pytest.mark.parametrize("H,K", [(8, 2), (4, 4), (8, 1)])
@pytest.mark.parametrize("active", [(1, 1, 1, 1, 1), (0, 1, 0, 1, 1),
                                    (0, 0, 0, 0, 0)])
def test_plain_version_against_a_loop(H, K, active):
    """Lengths 0, one short of a page, a page, past the table; slot 4's
    row points at slot 0's pages; inactive rows are zero."""
    B, hd, page, P = 5, 16, 4, 3
    g = torch.Generator().manual_seed(1)
    N = 4 * P
    q = torch.randn((B, 1, H, hd), generator=g)
    kp = torch.randn((N + 1, page, K, hd), generator=g)
    vp = torch.randn((N + 1, page, K, hd), generator=g)
    pt = torch.tensor([[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11],
                       [2, 0, 1]], dtype=torch.int32)
    sl = torch.tensor([0, 3, 4, 11, 40], dtype=torch.int32)
    act = torch.tensor(active, dtype=torch.bool)
    got = pdk.paged_decode_attention(q, kp, vp, pt, sl, act, sm_scale=0.25)
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.double(), _loop_ref(q, kp, vp, pt, sl, act,
                                                       0.25),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(got, ref.paged_decode_ref(q, kp, vp, pt, sl, act,
                                                 sm_scale=0.25))


# ---------------------------------------------------------------------------
# attention_decode_paged on CPU tensors: today's path, bit for bit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    cfg = reduced(get_config("llama110m"))
    params = get_model(cfg, lowering=LoweringConfig("torch")).init(0, "cpu")
    return cfg, layer_params(params["blocks"], 0)["attn"]


@pytest.mark.parametrize("backend", ["cuda", "torch"])
@pytest.mark.parametrize("active", [(1, 0, 1, 1, 0), (1, 1, 1, 1, 0),
                                    (0, 1, 1, 0, 0)])
def test_cpu_decode_is_the_gather_path_bit_for_bit(small, backend, active):
    """Five slots of pages of 4 over a table of 3: lengths 0, 3, 4, 11
    (the last position) and, inactive (the oracle indexes past its table
    there), 12 on slot 0's pages; output and pools equal the oracle's, and
    K14 never launches."""
    cfg, attn = small
    rng = np.random.default_rng(7)
    B, page, P, N = 5, 4, 3, 12
    K, hd = cfg.n_kv_heads, cfg.resolved_head_dim()
    x = torch.from_numpy(rng.normal(size=(B, 1, cfg.d_model))
                         .astype(np.float32))
    pools = [torch.from_numpy(rng.normal(size=(N + 1, page, K, hd))
                              .astype(np.float32)) for _ in range(2)]
    pt = torch.tensor([[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11],
                       [0, 1, 2]], dtype=torch.int32)
    sl = torch.tensor([0, 3, 4, 11, 12], dtype=torch.int32)
    act = torch.tensor(active, dtype=torch.bool)
    lw = LoweringConfig(backend)
    before = pdk.PAGED_DECODE.launches
    kp, vp = pools[0].clone(), pools[1].clone()
    out, kp2, vp2 = L.attention_decode_paged(attn, x, cfg, kp, vp, pt, sl,
                                             act, lowering=lw)
    assert kp2 is kp and vp2 is vp
    ok, ov = pools[0].clone(), pools[1].clone()
    want = _old_attention_decode_paged(attn, x, cfg, ok, ov, pt, sl, act,
                                       lowering=lw)
    assert torch.equal(out, want)
    assert torch.equal(kp[:N], ok[:N]) and torch.equal(vp[:N], ov[:N])
    assert pdk.PAGED_DECODE.launches == before

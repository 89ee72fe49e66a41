"""The port's CUDA kernels against their plain versions on the card.

Needs an NVIDIA GPU and nvcc; skips elsewhere.  Imports no JAX, so it runs
on a machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances are the reference's (tests/test_kernels.py:18): fp32 atol 2e-5 /
rtol 2e-4, bf16 2e-2.
"""

import pytest
import torch

from repro_torch.compile.config import LoweringConfig
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.pipeline import flash_attention_pipelined
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.models.registry import get_model

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


def _tol(dtype):
    return (dict(atol=2e-2, rtol=2e-2) if dtype == torch.bfloat16
            else dict(atol=2e-5, rtol=2e-4))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,d", [(1, 768), (8, 768), (512, 768), (3, 100),
                                 (5, 64)])
def test_rmsnorm_kernel(gen, R, d, dtype):
    x = torch.randn((R, d), generator=gen, device="cuda").to(dtype)
    g = torch.rand((d,), generator=gen, device="cuda") + 0.5
    before = _build.KERNELS["rmsnorm"].launches
    got = rmsnorm(x, g)
    torch.cuda.synchronize()
    assert _build.KERNELS["rmsnorm"].launches == before + 1
    torch.testing.assert_close(got, ref.rmsnorm_ref(x, g), **_tol(dtype))


FLASH = [  # B, S, T, H, K, hd
    (1, 64, 64, 12, 12, 64), (2, 40, 100, 4, 2, 64), (1, 130, 130, 8, 1, 32),
    (1, 16, 16, 4, 4, 16), (1, 96, 200, 2, 2, 128), (3, 1, 70, 4, 4, 64)]


def _dead_rows(S: int) -> int:
    return max(1, S // 3)


def _flash_inputs(gen, B, S, T, H, K, hd, dtype, per_batch_mask):
    q = torch.randn((B, S, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, T, K, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, T, K, hd), generator=gen, device="cuda").to(dtype)
    if per_batch_mask:
        mask = torch.rand((B, S, T), generator=gen, device="cuda") < 0.6
        mask[:, :_dead_rows(S), :] = False    # fully-masked rows
    else:
        mask = torch.tril(torch.ones((S, T), dtype=torch.bool, device="cuda"),
                          diagonal=T - S)[None]
    return q, k, v, mask


@pytest.mark.parametrize("per_batch_mask", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,K,hd", FLASH)
def test_flash_kernels(gen, B, S, T, H, K, hd, dtype, per_batch_mask):
    q, k, v, mask = _flash_inputs(gen, B, S, T, H, K, hd, dtype,
                                  per_batch_mask)
    want = ref.flash_attention_ref(q, k, v, mask, sm_scale=hd ** -0.5)
    outs = [flash_attention(q, k, v, mask, sm_scale=hd ** -0.5)]
    for depth in (2, 3, 4):
        if depth == 2 or hd < 128 or dtype == torch.bfloat16:
            outs.append(flash_attention_pipelined(
                q, k, v, mask, sm_scale=hd ** -0.5, depth=depth))
    torch.cuda.synchronize()
    for got in outs:
        torch.testing.assert_close(got, want, **_tol(dtype))
    if per_batch_mask:
        for got in outs:
            assert float(got[:, :_dead_rows(S)].abs().max()) == 0.0


def test_flash_wrappers_raise_on_what_the_kernel_does_not_take(gen):
    q, k, v, mask = _flash_inputs(gen, 1, 64, 64, 4, 4, 64, torch.float32,
                                  False)
    with pytest.raises(ValueError):
        flash_attention(q.transpose(1, 2), k, v, mask, sm_scale=0.125)
    with pytest.raises(ValueError):
        flash_attention(q, k, v, mask.float(), sm_scale=0.125)
    with pytest.raises(ValueError):
        flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                        v[..., :48].contiguous(), mask, sm_scale=0.125)
    wide = [t.repeat(1, 1, 1, 2) for t in (q, k, v)]
    with pytest.raises(ValueError):
        flash_attention_pipelined(*wide, mask, sm_scale=0.1, depth=4)


def test_ops_route_k2_for_one_tile_and_k3_for_more(gen):
    counts = {n: _build.KERNELS[n].launches for n in _build.KERNELS}
    for S in (16, 64, 65, 512):
        q, k, v, mask = _flash_inputs(gen, 1, S, S, 4, 4, 64, torch.float32,
                                      False)
        got = ops.flash_attention_gqa(q, k, v, mask, sm_scale=0.125)
        torch.testing.assert_close(
            got, ref.flash_attention_ref(q, k, v, mask, sm_scale=0.125),
            **_tol(torch.float32))
    after = {n: _build.KERNELS[n].launches for n in _build.KERNELS}
    assert after["flash_attention"] - counts["flash_attention"] == 2
    assert (after["flash_attention_pipelined"]
            - counts["flash_attention_pipelined"]) == 2


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

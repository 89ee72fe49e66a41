"""A/B of K6 (int8-K/V flash attention) against an earlier tree's sources,
and of K2 beside the earlier K2 it shares a header with, on one card in one
process.

The earlier sources are ``common.cuh``, ``flash_tile.cuh``,
``flash_attention_int8kv.cu`` and ``flash_attention.cu`` of one commit (the
parent of K6's redesign: K6 on K2's fp32 CUDA-core tile) in one
directory; ``--extract COMMIT DIR`` writes them there with ``git show``
(run it in a checkout: the card's machine has no git).  They are built
beside this tree's kernels (the earlier headers found first), with the
entry points ``flash_attention_int8kv_launch(q, k8, v8, k_scale, v_scale,
mask, out, B, S, T, H, K, hd, mask_b, sm_scale, live, dtype, device,
stream)`` and ``flash_attention_launch(q, k, v, mask, out, B, S, T, H, K,
hd, mask_b, sm_scale, live, dtype, device, stream)``.

K6: at ``chip_smoke.py``'s ten K6 rows (``INT8KV_SHAPES``) both sides are
held to ``flash_attention_int8kv_ref`` at ``INT8KV_TOL``, then timed on the
same inputs in turns, A B B A five times (10 timings a side): warm
(``chip_smoke.device_ms``, 20 calls) and cold (``chip_smoke.cold_ms``,
inputs rotated past 4x the L2).  The new side runs its plan rule's pick.
K2: at its main case (S = T = 64, H = K = 12, hd 64, fp32, causal) and at
S = T = 512 in fp32, bf16 and fp16 the two sides' outputs must be the same
bits; the main case is timed the same way.  Prints one JSON line a case
(median and min-max µs of each side, warm and cold, the ratio of the
medians) and exits non-zero if a side fails its tolerance or K2's bits
differ.  Needs a Hopper card and nvcc:

    python tools/int8kv_ab.py --extract <commit> <ignored dir>/old_k6
    PYTHONPATH=src python tools/int8kv_ab.py <ignored dir>/old_k6
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OLD_SOURCES = ("common.cuh", "flash_tile.cuh", "flash_attention_int8kv.cu",
               "flash_attention.cu")
#: K2's main case (chip_smoke.kernel_summary), and its bit checks.
K2_MAIN = (64, 12, 12, 64, "float32")
K2_BITS = ((512, 12, 12, 64, "float32"), (512, 12, 12, 64, "bfloat16"),
           (512, 12, 12, 64, "float16"))


def extract(commit: str, out_dir: pathlib.Path) -> None:
    """The earlier sources of ``commit`` into ``out_dir``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    for f in OLD_SOURCES:
        text = subprocess.run(
            ["git", "show", f"{commit}:src/repro_torch/kernels/csrc/{f}"],
            cwd=ROOT, check=True, capture_output=True, text=True).stdout
        (out_dir / f).write_text(text)


def build_old(src_dir: pathlib.Path) -> dict:
    """The earlier K6 and K2 entry points, built from ``src_dir``."""
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    argtypes = {"flash_attention_int8kv": [P] * 7 + [I] * 7 + [F, P, I, I, P],
                "flash_attention": [P] * 5 + [I] * 7 + [F, P, I, I, P]}
    procs = {}
    for name in argtypes:
        lib = _build.BUILD_DIR / f"lib{name}_ab_old.so"
        procs[name] = (lib, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS[:-1], "-shared", "-I",
             str(src_dir), "-I", str(_build.CSRC), "-o", str(lib),
             str(src_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc refused the earlier {name}.cu:\n{out}")
        fn = getattr(ctypes.CDLL(str(lib)), f"{name}_launch")
        fn.argtypes = argtypes[name]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def turns(sides: dict, args, warm_iters: int = 20) -> dict:
    """Warm and cold µs of each side (``sides[name](*args)``), A B B A five
    times: median, min-max and the ratio of the medians (old / new)."""
    from chip_smoke import cold_ms, device_ms
    us = {f"{s}_{t}": [] for s in sides for t in ("warm", "cold")}
    for side in ("old", "new", "new", "old") * 5:
        fn = sides[side]
        us[f"{side}_warm"].append(device_ms(lambda: fn(*args), warm_iters,
                                            spin=20_000_000) * 1e3)
        us[f"{side}_cold"].append(cold_ms(fn, args) * 1e3)
    row = {}
    for key, v in us.items():
        row[f"{key}_us_median"] = statistics.median(v)
        row[f"{key}_us_min_max"] = [min(v), max(v)]
    for t in ("warm", "cold"):
        row[f"speedup_{t}"] = (row[f"old_{t}_us_median"]
                               / row[f"new_{t}_us_median"])
    return row


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--extract":
        extract(sys.argv[2], pathlib.Path(sys.argv[3]))
        return 0
    import torch
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("int8kv_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import (INT8KV_SHAPES, INT8KV_TOL, TOL, _check, card_line,
                            flash_mask, int8kv_case_name, int8kv_inputs)
    from repro_torch.kernels import _build, pipeline, ref
    from repro_torch.kernels.flash_attention import (DTYPE_CODES,
                                                     flash_attention,
                                                     flash_attention_int8kv)
    old_fns = build_old(pathlib.Path(sys.argv[1]))
    card = card_line()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)

    for S, H, K, dtype, kind, hd in INT8KV_SHAPES:
        q, _, _, k8, v8, ks, vs, mask = int8kv_inputs(S, H, K, dtype, gen,
                                                      kind, hd)
        scale = hd ** -0.5

        def old(q, k8, v8):
            out = torch.empty_like(q)
            err = old_fns["flash_attention_int8kv"](
                _build.ptr(q), _build.ptr(k8), _build.ptr(v8), _build.ptr(ks),
                _build.ptr(vs), _build.ptr(mask), _build.ptr(out), 1, S, S, H,
                K, hd, 1, scale, None, DTYPE_CODES[q.dtype], q.device.index,
                _build.stream_of(q))
            if err:
                raise RuntimeError(f"earlier K6: CUDA error {err}")
            return out

        def new(q, k8, v8):
            return flash_attention_int8kv(q, k8, v8, ks, vs, mask,
                                          sm_scale=scale)
        case = int8kv_case_name(S, H, K, dtype, kind, hd)
        want = ref.flash_attention_int8kv_ref(q, k8, v8, ks, vs, mask,
                                              sm_scale=scale)
        for side, fn in (("old", old), ("new", new)):
            _check(f"int8kv_ab {side} {case}", fn(q, k8, v8), want, dtype,
                   INT8KV_TOL)
        row = {"kernel": "flash_attention_int8kv", "case": case,
               "plan": pipeline.int8kv_plan(1, S, S, H, K, hd, q.dtype,
                                            pipeline.sm_count(q.device)),
               "card": card}
        row.update(turns({"old": old, "new": new}, (q, k8, v8)))
        print(json.dumps(row))

    def k2_inputs(S, H, K, hd, dtype):
        dt = getattr(torch, dtype)
        return [torch.randn((1, S, n, hd), generator=gen,
                            device="cuda").to(dt) for n in (H, K, K)]

    def k2_sides(S, H, K, hd):
        mask = flash_mask("causal", S, S)

        def old(q, k, v):
            out = torch.empty_like(q)
            err = old_fns["flash_attention"](
                _build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(mask),
                _build.ptr(out), 1, S, S, H, K, hd, 1, hd ** -0.5, None,
                DTYPE_CODES[q.dtype], q.device.index, _build.stream_of(q))
            if err:
                raise RuntimeError(f"earlier K2: CUDA error {err}")
            return out

        def new(q, k, v):
            return flash_attention(q, k, v, mask, sm_scale=hd ** -0.5)
        return {"old": old, "new": new}, mask

    bad = 0
    for S, H, K, hd, dtype in (K2_MAIN, *K2_BITS):
        sides, mask = k2_sides(S, H, K, hd)
        args = k2_inputs(S, H, K, hd, dtype)
        outs = {s: fn(*args) for s, fn in sides.items()}
        _check(f"int8kv_ab K2 S={S} {dtype}", outs["new"],
               ref.flash_attention_ref(*args, mask, sm_scale=hd ** -0.5),
               dtype, TOL)
        same = torch.equal(outs["old"], outs["new"])
        bad += not same
        row = {"kernel": "flash_attention",
               "case": f"S={S} T={S} H={H} K={K} hd={hd} {dtype} causal",
               "bits_equal_to_earlier": same, "card": card}
        if (S, H, K, hd, dtype) == K2_MAIN:
            row.update(turns(sides, tuple(args)))
            row["within_5pct"] = all(
                abs(row[f"speedup_{t}"] - 1) <= 0.05 for t in ("warm", "cold"))
        print(json.dumps(row))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""What K4's promotion buys: the fp32 error of ``csrc/int8_matmul.cu`` with
and without it, on the card.

K4 sums each 64-k stage of its tensor-core products into a fresh
accumulator and adds that into an fp32 total on the CUDA cores
(promotion).  This probe builds a second copy of the committed source with
promotion switched off by a text edit (``kPromote = false``, and 256-wide
fp32 tiles, which only the freed registers allow), into
``src/repro_torch/kernels/_build/probe/``, and runs both at
(M, K, N) = (512, 768, 32000), (512, 2048, 768), (512, 8192, 768) and
(512, 32768, 256) in fp32, on normal inputs and on all-positive ones (a
one-signed sum, where a truncating adder drifts).  Each error is printed
as a ratio to ``chip_smoke.int8_tol``'s atol (K ulps, 2^-23, of the
largest product) against the exact product in fp64, beside the plain
version's ratio, and with the kernel's warm µs.

    python tools/int8_accum_probe.py
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
SHAPES = ((512, 768, 32000), (512, 2048, 768), (512, 8192, 768),
          (512, 32768, 256))


def build(nvcc, flags, out_dir: pathlib.Path) -> dict:
    """The committed K4 and a copy without promotion, as ctypes entry
    points by name."""
    csrc = ROOT / "src/repro_torch/kernels/csrc"
    src = (csrc / "int8_matmul.cu").read_text()
    edits = {"  static constexpr bool kPromote = kF32;":
             "  static constexpr bool kPromote = false;",
             "  if constexpr (!std::is_same<T, float>::value) {":
             "  if constexpr (true) {"}
    off = src
    for old, new in edits.items():
        if old not in off:
            raise SystemExit(f"int8_accum_probe: {old.strip()!r} not in the "
                             f"source")
        off = off.replace(old, new)
    out_dir.mkdir(parents=True, exist_ok=True)
    fns = {}
    for name, text in (("promote", src), ("no_promote", off)):
        cu = out_dir / f"k4_{name}.cu"
        cu.write_text(text)
        so = out_dir / f"libk4_{name}.so"
        subprocess.run([nvcc, *flags, "-shared", "-I", str(csrc), "-o",
                        str(so), str(cu)], check=True, capture_output=True)
        fn = ctypes.CDLL(str(so)).int8_matmul_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("int8_accum_probe: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    fns = build(_build.find_nvcc(), _build.NVCC_FLAGS,
                _build.BUILD_DIR / "probe")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def warm_us(call, iters=10):
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(iters):
            call()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters * 1e3

    for M, K, N in SHAPES:
        for dist in ("normal", "positive"):
            x = torch.randn((M, K), generator=gen, device="cuda")
            wq = torch.randint(-127, 128, (N, K), generator=gen,
                               device="cuda", dtype=torch.int8)
            if dist == "positive":
                x, wq = x.abs(), wq.abs()
            scale = 0.001 + 0.019 * torch.rand((N,), generator=gen,
                                               device="cuda")
            exact = (x.double() @ wq.double().T * scale.double()).float()
            big = (float(x.abs().max())
                   * float((scale[:, None] * wq).abs().max()))
            atol = K * big * 2.0 ** -23
            plain = ref.int8_matmul_ref(x, wq, scale)
            rec = {"M": M, "K": K, "N": N, "inputs": dist,
                   "plain_ratio": float((plain - exact).abs().max()) / atol}
            for name, fn in fns.items():
                for plan in ((128, 128, 1, 2), (128, 256, 1, 2)):
                    if name == "promote" and plan[1] == 256:
                        continue
                    out = torch.empty((M, N), device="cuda")

                    def call(fn=fn, plan=plan, out=out):
                        err = fn(x.data_ptr(), wq.data_ptr(),
                                 scale.data_ptr(), out.data_ptr(), M, N, K,
                                 *plan, 0, x.get_device(), stream)
                        if err:
                            raise RuntimeError(f"{name} {plan}: CUDA {err}")
                    call()
                    torch.cuda.synchronize()
                    rec[f"{name} {plan}"] = {
                        "ratio": float((out - exact).abs().max()) / atol,
                        "us": warm_us(call)}
            print(json.dumps({**rec, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Measure the terms of the H100's memory interfaces that the data sheet
does not give: the lead-off latency (cycles of the SM clock) of a load that
hits L2, of one that goes to HBM and of a shared-memory load, the bytes a
cycle one SM pulls alone from L2 and from HBM, the device's read rates
from L2 and HBM with every SM pulling, and the SM clock under load.

These are the constants of ``repro_torch.core.interface_model``'s Hopper
instance (``hopper_interfaces``) that are not data-sheet values.

* Latency: one thread chases a random cycle of pointers, one 128-byte line
  a hop, with ``ld.global.cg`` (past L1): over 8 MB (warm: L2 hits) and
  over 1 GB (HBM; past the 50 MB L2), and in shared memory.  ``clock64``
  around 4096 dependent hops gives cycles a hop.
* Rate: blocks of 1024 threads read 16-byte vectors, eight in flight a
  thread, with CUDA events around the launch: one block (one SM) and one
  block an SM, from a warm 16 MB span (L2; every block reads all of it)
  and from a cold span of a 1 GB buffer (HBM).
* Clock: a kernel that spins 2^27 cycles of ``clock64``, timed by events.

Prints one JSON line a measurement and a last line with all of them.
Needs a Hopper card and nvcc; builds into
``src/repro_torch/kernels/_build/``.

    PYTHONPATH=src python tools/hopper_interface_probe.py
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void chase_global(const unsigned* __restrict__ next, int hops,
                             unsigned start, long long* out) {
  unsigned p = start;
  long long t0 = clock64();
  for (int i = 0; i < hops; ++i) {
    unsigned v;
    asm volatile("ld.global.cg.u32 %0, [%1];" : "=r"(v) : "l"(next + p) : "memory");
    p = v;
  }
  long long t1 = clock64();
  out[0] = t1 - t0;
  out[1] = p;
}

__global__ void chase_shared(int hops, int n, long long* out) {
  extern __shared__ unsigned s[];
  for (int i = threadIdx.x; i < n; i += blockDim.x) s[i] = (i + 37u) % n;
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* vs = s;
    unsigned p = 0;
    long long t0 = clock64();
    for (int i = 0; i < hops; ++i) p = vs[p];
    long long t1 = clock64();
    out[0] = t1 - t0;
    out[1] = p;
  }
}

// Each block reads `per_block` 16-byte vectors from src + (blockIdx.x *
// per_block) % wrap, eight loads in flight a thread; the xor of what it read goes
// to sink so that no load is dropped.
__global__ void __launch_bounds__(1024) stream_read(const int4* __restrict__ src,
                                                    long long per_block, long long wrap,
                                                    int* sink) {
  const int4* base = src + (blockIdx.x * per_block) % wrap;
  int acc = 0;
  for (long long i = threadIdx.x; i < per_block; i += 8 * 1024) {
    int4 v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      long long j = i + u * 1024;
      if (j < per_block)
        asm volatile("ld.global.cg.v4.s32 {%0,%1,%2,%3}, [%4];"
                     : "=r"(v[u].x), "=r"(v[u].y), "=r"(v[u].z), "=r"(v[u].w)
                     : "l"(base + j));
      else
        v[u] = make_int4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
  }
  if (acc == 0x7fffffff) sink[0] = acc;
}

__global__ void spin(long long cycles, long long* out) {
  long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
  out[0] = clock64() - t0;
}

extern "C" int launch_chase_global(const void* next, int hops, unsigned start,
                                   void* out, void* stream) {
  chase_global<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const unsigned*)next, hops, start, (long long*)out);
  return cudaGetLastError();
}

extern "C" int launch_chase_shared(int hops, int n, void* out, void* stream) {
  int bytes = n * 4;
  cudaError_t e = cudaFuncSetAttribute(
      chase_shared, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  chase_shared<<<1, 256, bytes, (cudaStream_t)stream>>>(hops, n, (long long*)out);
  return cudaGetLastError();
}

extern "C" int launch_stream_read(const void* src, int blocks, long long per_block,
                                  long long wrap, void* sink, void* stream) {
  stream_read<<<blocks, 1024, 0, (cudaStream_t)stream>>>(
      (const int4*)src, per_block, wrap, (int*)sink);
  return cudaGetLastError();
}

extern "C" int launch_spin(long long cycles, void* out, void* stream) {
  spin<<<1, 1, 0, (cudaStream_t)stream>>>(cycles, (long long*)out);
  return cudaGetLastError();
}
"""

LINE = 128
HOPS = 4096
SPIN = 1 << 27


def build():
    from repro_torch.kernels import _build
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = _build.BUILD_DIR / "hopper_interface_probe.cu"
    lib = _build.BUILD_DIR / "libhopper_interface_probe.so"
    src.write_text(SOURCE)
    subprocess.run([_build.find_nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
                   check=True)
    dll = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    sigs = {"launch_chase_global": [P, I, ctypes.c_uint, P, P],
            "launch_chase_shared": [I, I, P, P],
            "launch_stream_read": [P, I, ctypes.c_longlong, ctypes.c_longlong, P,
                                   P],
            "launch_spin": [ctypes.c_longlong, P, P]}
    for name, args in sigs.items():
        getattr(dll, name).argtypes = args
        getattr(dll, name).restype = ctypes.c_int
    return dll


def _check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what}: CUDA error {err}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("hopper_interface_probe: no CUDA device", file=sys.stderr)
        return 2
    dll = build()
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.zeros(2, dtype=torch.int64, device="cuda")
    gen = torch.Generator().manual_seed(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    res = {"device": torch.cuda.get_device_name(0),
           "nvidia_smi": smi.stdout.strip()}

    def timed(fn) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e-3

    # the SM clock under load: cycles of clock64 over event seconds
    ms = [timed(lambda: _check(dll.launch_spin(SPIN, out.data_ptr(), stream),
                               "spin")) for _ in range(3)]
    res["sm_clock_hz"] = float(out[0].item()) / min(ms)

    def chase(span: int, cold: bool) -> float:
        """Cycles a hop of a random cycle over ``span`` bytes of lines:
        warm, the second pass over the same lines (L2 hits); cold, a pass
        over lines of the cycle the first pass did not touch."""
        lines = span // LINE
        order = torch.randperm(lines, generator=gen).cuda()
        words = LINE // 4
        nxt = torch.zeros(lines * words, dtype=torch.int32, device="cuda")
        nxt[order * words] = (torch.roll(order, -1) * words).int()
        for start in (order[0], order[lines // 2] if cold else order[0]):
            _check(dll.launch_chase_global(nxt.data_ptr(), HOPS,
                                           int(start) * words,
                                           out.data_ptr(), stream), "chase")
            torch.cuda.synchronize()
        return out[0].item() / HOPS

    res["l2_latency_cycles"] = chase(8 << 20, cold=False)
    res["hbm_latency_cycles"] = chase(1 << 30, cold=True)
    _check(dll.launch_chase_shared(HOPS, 16384, out.data_ptr(), stream),
           "chase_shared")
    torch.cuda.synchronize()
    res["smem_latency_cycles"] = out[0].item() / HOPS

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    big = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
    big.random_(generator=torch.Generator("cuda").manual_seed(0))
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    clock = res["sm_clock_hz"]

    def rate(blocks: int, per_block: int, span: int, cold: bool) -> float:
        """Bytes a second that ``blocks`` blocks read, ``per_block`` bytes
        each, over a ``span`` of the buffer (warm: read once before; cold:
        a part of the buffer not read since the last pass)."""
        per_block //= 16
        best = float("inf")
        for rep in range(3):
            offset = (rep + 1) * (256 << 20) if cold else 0
            src = big.data_ptr() + offset
            if not cold:
                _check(dll.launch_stream_read(src, 1, span // 16, span // 16,
                                              sink.data_ptr(), stream), "warm")
            best = min(best, timed(lambda: _check(dll.launch_stream_read(
                src, blocks, per_block, span // 16, sink.data_ptr(), stream),
                "read")))
        return blocks * per_block * 16 / best

    for name, blocks, per_block, span, cold in (
            ("one_sm_l2", 1, 16 << 20, 16 << 20, False),
            ("one_sm_hbm", 1, 64 << 20, 64 << 20, True),
            ("all_sms_l2", sms, 16 << 20, 16 << 20, False),
            ("all_sms_hbm", sms, (192 << 20) // sms // 16 * 16, 192 << 20,
             True)):
        bw = rate(blocks, per_block, span, cold)
        res[f"{name}_bytes_per_s"] = bw
        res[f"{name}_bytes_per_cycle_per_sm"] = bw / blocks / clock
    for key, value in res.items():
        print(json.dumps({key: value}))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())

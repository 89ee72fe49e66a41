"""Quickstart on the PyTorch port: the Aquas pipeline in one script, on one
H100.

1. Hardware side (§4): model the memory interfaces and synthesize a DMA
   schedule (device-independent: the reference's cycles and decisions),
   then the H100 cost model's pick for flash attention at the reference's
   two shapes (``kernels/schedule.flash_schedule``: K2 or K3, the ring
   depth and the predicted µs) where the reference shows its TPU tiles.
2. Software side (§5): e-graph-compile a syntactically divergent attention
   loop onto the flash-attention ISAX and evaluate it through the kernel
   intrinsics (K2 on the card).
3. System side: train llama110m for 5 steps (backend ``torch``: the kernel
   routes raise under autograd), then generate 6 tokens from its int8
   weights through ``ServeEngine`` on backend ``cuda`` (K1, K2/K3).  Full
   width on the card; ``--smoke`` takes ``reduced()``, as the reference
   does.

    PYTHONPATH=src python examples/torch/quickstart.py
    PYTHONPATH=src python examples/torch/quickstart.py --smoke --device cpu
"""

import argparse
import math

import numpy as np
import torch

from repro_torch.compile.config import LoweringConfig
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.core import aquas_ir as ir
from repro_torch.core.expr import arr, const, for_, var
from repro_torch.core.interface_model import (H100_CLOCK_HZ,
                                              paper_example_interfaces)
from repro_torch.core.offload import compile_program, evaluate
from repro_torch.core.synthesis import synthesize
from repro_torch.kernels import schedule
from repro_torch.kernels.ops import register_kernel_intrinsics, resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.targets import isax_library
from repro_torch.train.trainer import TrainConfig, Trainer

#: The reference's two flash-attention shapes (S, T, head dim): a
#: compute-bound 4k x 4k prefill and a memory-bound 64-row query over 4k
#: keys, at batch 1 and llama110m's 12 heads, fp32 as llama110m serves.
FLASH_SHAPES = (("prefill 4k x 4k", 4096, 4096, 128),
                ("decode-ish 64 x 4k", 64, 4096, 64))


def fir7_program() -> ir.FunctionalProgram:
    """The paper's fir7 example: a cold 108-element and a warm 28-element
    load into scratchpads."""
    return ir.FunctionalProgram("fir7", [
        ir.FuncOp("transfer", "src", 108, ir.Space.GLOBAL,
                  ir.Space.SCRATCHPAD, "load", ir.CacheHint.COLD),
        ir.FuncOp("transfer", "bias", 28, ir.Space.GLOBAL,
                  ir.Space.SCRATCHPAD, "load", ir.CacheHint.WARM,
                  scratchpad="bias")],
        {"bias": ir.ScratchpadDecl("bias", 28, ir.CacheHint.WARM,
                                   compute_cycles_per_elem=8.0)})


def hardware_side() -> dict:
    print("== 1. Interface-aware synthesis (paper §4) ==")
    t = synthesize(fir7_program(), paper_example_interfaces())
    print(f"  fir7 schedule: {t.total_cycles:.0f} cycles; decisions:")
    for k, v in sorted(t.decisions.items()):
        print(f"    {k} = {v}")
    heads = get_config("llama110m").n_heads
    flash = {}
    for label, S, T, hd in FLASH_SHAPES:
        s = schedule.flash_schedule(1, S, heads, heads, T, hd, 4)
        us = {k: s[c] / H100_CLOCK_HZ * 1e6 for k, c in
              (("base", "est_serial_cycles"), ("pipe", "est_pipe_cycles"))
              if s[c] is not None}
        flash[label] = dict(kernel=s["kernel"], depth=s["depth"],
                            predicted_us=us[("pipe" if s["pipelined"]
                                             else "base")],
                            predicted_us_each=us)
        pair = (f"K2 {us['base']:.1f}, K3 {us['pipe']:.1f}" if "pipe" in us
                else f"K2 {us['base']:.1f}; no K3 for one tile")
        print(f"  flash attention [{label}, hd {hd}, B 1, {heads} heads, "
              f"fp32] on the H100 model: {'K3' if s['pipelined'] else 'K2'} "
              f"({s['kernel']}), ring depth {s['depth']}, predicted "
              f"{flash[label]['predicted_us']:.1f} µs ({pair})")
    print()
    return {"fir7_cycles": t.total_cycles, "fir7_decisions": t.decisions,
            "flash": flash}


def attention_program():
    """A deliberately divergent attention loop: the scale inside the
    matvec, no max-shift softmax."""
    i = var("i")
    q = ("load", arr("Q"), i)
    s = ("/", ("exp", ("matvec", arr("K"), ("*", var("scale"), q))),
         ("rowsum", ("exp", ("matvec", arr("K"), ("*", var("scale"), q)))))
    return for_("i", const(0), var("n_q"), const(1),
                ("store", arr("P"), i, s),
                ("store", arr("O"), i,
                 ("matvec", ("transpose", arr("V")), ("load", arr("P"), i))))


def software_side(device) -> dict:
    print("== 2. E-graph retargetable compiler (paper §5) ==")
    register_kernel_intrinsics(device)
    sw = attention_program()
    res = compile_program(sw, isax_library(), case="quickstart")
    s = res.stats
    print(f"  matched ISAXs: {s.matched_isaxes}")
    print(f"  rewrites: {s.internal_rewrites} internal / "
          f"{s.external_rewrites} external; "
          f"e-nodes {s.initial_enodes} -> {s.saturated_enodes}")
    rng = np.random.default_rng(0)
    nq, nk, d = 8, 16, 32
    env = dict(Q=rng.normal(size=(nq, d)), K=rng.normal(size=(nk, d)),
               V=rng.normal(size=(nk, d)), scale=d ** -0.5, n_q=nq,
               P=np.zeros((nq, nk)), O=np.zeros((nq, d)))
    env2 = {k: (v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in env.items()}
    evaluate(sw, env)
    evaluate(res.program, env2)
    ok = bool(np.allclose(env["O"], env2["O"], atol=1e-6))
    print(f"  offloaded == original: {ok}\n")
    if not ok:
        raise AssertionError("the offloaded attention program differs from "
                             "the software program")
    return {"matched": list(s.matched_isaxes),
            "internal": s.internal_rewrites, "external": s.external_rewrites,
            "enodes": [s.initial_enodes, s.saturated_enodes],
            "offloaded_equal": ok}


def system_side(device, smoke: bool) -> dict:
    width = "reduced" if smoke else "full-width"
    print(f"== 3. Train + serve ({width} llama110m, {device}) ==")
    cfg = get_config("llama110m")
    if smoke:
        cfg = reduced(cfg)
    tr = Trainer(cfg, TrainConfig(batch=4, seq=32, total_steps=5,
                                  optimizer=AdamWConfig(lr=1e-3)),
                 device=device)
    last = tr.train(5)
    first = tr.metrics_log[0]["loss"]
    print(f"  5 train steps, loss: {first:.3f} -> {last['loss']:.3f}")
    eng = ServeEngine(cfg, params=tr.params, max_len=48, quantize=True,
                      lowering=LoweringConfig("cuda"), device=device)
    prompt = torch.ones((2, 8), dtype=torch.int32)
    toks, stats = eng.generate({"tokens": prompt}, 6)
    print(f"  generated {tuple(toks.shape)} tokens, "
          f"TTFT {stats.ttft_s * 1e3:.1f} ms, ITL {stats.itl_s * 1e3:.1f} ms")
    if not (math.isfinite(first) and math.isfinite(last["loss"])
            and tuple(toks.shape) == (2, 6)
            and bool(((toks >= 0) & (toks < cfg.vocab)).all())):
        raise AssertionError(f"system side: losses {first}, "
                             f"{last['loss']}, tokens {tuple(toks.shape)}")
    return {"loss_first": first, "loss_last": last["loss"],
            "tokens_shape": list(toks.shape), "ttft_ms": stats.ttft_s * 1e3,
            "itl_ms": stats.itl_s * 1e3,
            "serve": {"engine": eng, "prompt": prompt, "tokens": toks}}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced llama110m (the reference's size)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"device": str(device), **hardware_side(),
           "attention": software_side(device),
           **system_side(device, args.smoke)}
    print("\nquickstart OK")
    return out


if __name__ == "__main__":
    main()

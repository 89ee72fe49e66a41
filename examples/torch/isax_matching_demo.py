"""Compiler-robustness demo on the PyTorch port (paper §6.2/§6.3 "Compiler
Support"): the same int8-GEMV ISAX is recovered from five deliberately
mangled software variants — tiling, unrolling, non-affine index
arithmetic, moved scaling and the plain loop — printing Table-3-style
stats.  Each offloaded program is evaluated through the kernel
intrinsics: on the card ``int8_matvec`` runs the int8 GEMM route
(``kernels/ops.int8_matmul``; this 8 x 7 x 5 shape takes K4's path for K
off the 16-byte grid), and its output is held to the plain loop's.

    PYTHONPATH=src python examples/torch/isax_matching_demo.py
    PYTHONPATH=src python examples/torch/isax_matching_demo.py --device cpu
"""

import argparse

import numpy as np

from repro_torch.core.expr import arr, const, for_, var
from repro_torch.core.offload import compile_program, evaluate
from repro_torch.kernels.ops import register_kernel_intrinsics, resolve_device
from repro_torch.targets.llm import isax_int8_matvec


def body(iexpr):
    return ("store", arr("C"), iexpr,
            ("*", var("s_w"), ("matvec", arr("Wq"),
                               ("load", arr("X"), iexpr))))


VARIANTS = {
    "plain": for_("i", const(0), const(8), const(1), body(var("i"))),
    "unrolled(2)": for_("i", const(0), const(8), const(2),
                        body(var("i")), body(("+", var("i"), const(1)))),
    "tiled(4)": for_("it", const(0), const(8), const(4),
                     for_("j", var("it"), ("+", var("it"), const(4)),
                          const(1), body(var("j")))),
    "nonaffine-index": for_("i", const(0), const(8), const(1),
                            ("store", arr("C"), var("i"),
                             ("*", var("s_w"),
                              ("matvec", arr("Wq"),
                               ("load", arr("X"),
                                (">>", ("<<", var("i"), const(1)),
                                 const(1))))))),
    "scale-moved": for_("i", const(0), const(8), const(1),
                        ("store", arr("C"), var("i"),
                         ("matvec", arr("Wq"),
                          ("*", var("s_w"), ("load", arr("X"),
                                             var("i")))))),
}


def _copy(env: dict) -> dict:
    return {k: (v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in env.items()}


def rows(device) -> list[dict]:
    """One row a variant: rewrites, e-nodes before and after saturation,
    whether int8_matvec matched, and whether the offloaded program's C
    equals the plain loop's (np.allclose, atol 1e-6)."""
    register_kernel_intrinsics(device)
    ix = isax_int8_matvec()
    rng = np.random.default_rng(0)
    base_env = dict(Wq=rng.integers(-127, 127, size=(5, 7)).astype(np.int8),
                    X=rng.normal(size=(8, 7)), s_w=0.02, n=8,
                    C=np.zeros((8, 5)))
    ref_env = _copy(base_env)
    evaluate(VARIANTS["plain"], ref_env)
    out = []
    for name, sw in VARIANTS.items():
        res = compile_program(sw, [ix], case=name)
        s = res.stats
        env = _copy(base_env)
        evaluate(res.program, env)
        out.append(dict(variant=name, internal=s.internal_rewrites,
                        external=s.external_rewrites,
                        enodes=[s.initial_enodes, s.saturated_enodes],
                        matched="int8_matvec" in s.matched_isaxes,
                        allclose=bool(np.allclose(env["C"], ref_env["C"],
                                                  atol=1e-6))))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    table = rows(device)
    print(f"{'variant':18s} {'int':>4s} {'ext':>4s} {'e-nodes':>12s} "
          f"{'matched':>8s} {'allclose':>9s}")
    for r in table:
        print(f"{r['variant']:18s} {r['internal']:4d} {r['external']:4d} "
              f"{r['enodes'][0]:5d}->{r['enodes'][1]:<5d} "
              f"{str(r['matched']):>8s} {str(r['allclose']):>9s}")
    bad = [r["variant"] for r in table if not (r["matched"] and r["allclose"])]
    if bad:
        raise AssertionError(f"int8_matvec not recovered or not equal to the "
                             f"plain loop on {device}: {bad}")
    print(f"\nisax matching demo OK ({device})")
    return {"device": str(device), "rows": table}


if __name__ == "__main__":
    main()

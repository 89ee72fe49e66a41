"""Seeded environments in which to evaluate each target ISAX's software
program and its offloaded form (``core.offload.evaluate``).

``compile_program`` turns a trace program into one that calls an
``isax:`` intrinsic; evaluating both in equal environments and comparing
the outputs checks the e-graph's extraction end to end, and, with the
intrinsics bound to the kernels (``kernels/ops.kernel_intrinsics``,
``pointcloud/ops.pointcloud_intrinsics`` on ``"cuda"``), the kernels
behind it.  Inputs are fp32 values held in float64 arrays, so the numpy
evaluators and the kernels see the same numbers.

``CASES`` maps each trace kind to its ISAX and the outputs compared:
exactly (indices, and the max-pool, which only selects) or at the
tolerance of the reference's ``tests/test_offload.py`` (``FLOAT_TOL``).
"""

from __future__ import annotations

import numpy as np

#: atol / rtol of floating outputs (``tests/test_offload.py:_run_both``).
FLOAT_TOL = {"atol": 1e-5, "rtol": 1e-4}

#: trace kind → (target ISAX, outputs compared exactly, outputs compared
#: at FLOAT_TOL)
CASES = {
    "attention": ("flash_attention", (), ("O", "P")),
    "int8_matmul": ("int8_matvec", (), ("C",)),
    "ssd_scan": ("ssd_step", (), ("Y", "H")),
    "rmsnorm": ("rmsnorm", (), ("On",)),
    "fps": ("fps", ("Sp",), ("Dp",)),
    "ball_query": ("ball_query", ("Gq",), ()),
    "group_aggregate": ("group_agg", ("Ag",), ()),
}


def _f32(rng, *shape, scale=1.0) -> np.ndarray:
    return (rng.normal(size=shape) * scale).astype(np.float32).astype(
        np.float64)


def environment(kind: str, seed: int = 0) -> dict:
    """A fresh environment for trace kind ``kind`` (arrays the programs
    read and the output arrays they write, zeroed)."""
    rng = np.random.default_rng(seed)
    if kind == "attention":
        nq, nk, d = 16, 24, 16
        return dict(Q=_f32(rng, nq, d), K=_f32(rng, nk, d),
                    V=_f32(rng, nk, d), scale=0.25, n_q=nq,
                    P=np.zeros((nq, nk)), O=np.zeros((nq, d)))
    if kind == "int8_matmul":
        n, m, k = 8, 40, 32
        return dict(Wq=rng.integers(-127, 127, size=(m, k)).astype(np.int8),
                    X=_f32(rng, n, k), s_w=0.015625, n=n,
                    C=np.zeros((n, m)))
    if kind == "ssd_scan":
        T, n, p = 20, 16, 8
        return dict(A=rng.uniform(0.2, 0.9, size=(T,)),
                    B=_f32(rng, T, n), C=_f32(rng, T, n), X=_f32(rng, T, p),
                    T=T, H=np.zeros((1, n, p)), Y=np.zeros((T, p)))
    if kind == "rmsnorm":
        n, d = 6, 64
        return dict(Xn=_f32(rng, n, d), G=_f32(rng, d), eps=1e-6, n=n,
                    On=np.zeros((n, d)))
    if kind == "fps":
        n, n_s = 300, 24
        return dict(Xp=_f32(rng, n, 3), n_s=n_s, Dp=np.full((1, n), 1e30),
                    Sp=np.zeros(n_s, np.int64))
    if kind == "ball_query":
        n, m, k = 300, 16, 8
        X = _f32(rng, n, 3)
        return dict(Xp=X, Cn=X[:m].copy(), r2=1.0, kk=k, n_c=m,
                    Gq=np.zeros((m, k), np.int64))
    if kind == "group_aggregate":
        n, m, k, c = 300, 16, 8, 32
        return dict(Fg=_f32(rng, n, c),
                    Gq=rng.integers(0, n, size=(m, k)).astype(np.int64),
                    n_c=m, Ag=np.zeros((m, c)))
    raise ValueError(f"no evaluation case for trace kind {kind!r}")


def copy_env(env: dict) -> dict:
    """An equal environment with its own copies of the arrays."""
    return {k: v.copy() if isinstance(v, np.ndarray) else v
            for k, v in env.items()}


def compare(kind: str, want: dict, got: dict) -> dict:
    """Largest deviation of each compared output (0 where exact), raising
    AssertionError on an exact output that differs or a floating one past
    FLOAT_TOL."""
    _, exact, floats = CASES[kind]
    out = {}
    for name in exact:
        if not np.array_equal(want[name], got[name]):
            raise AssertionError(f"{kind}: {name} differs")
        out[name] = 0.0
    for name in floats:
        np.testing.assert_allclose(got[name], want[name], **FLOAT_TOL,
                                   err_msg=f"{kind}: {name}")
        out[name] = float(np.max(np.abs(got[name] - want[name])))
    return out

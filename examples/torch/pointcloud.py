"""Point-cloud set abstraction through the port's co-design stack.

The paper's second application domain, end to end, on one H100:

1. Software side (§5): the divergently-spelled FPS / ball-query /
   group-aggregate loops e-graph-compile onto the point-cloud ISAXes, and
   the offloaded FPS program, evaluated through the point-cloud
   intrinsics (K9 on the card), gives the software program's indices.
2. Hardware side (§4): the H100 cost model schedules the gathers at the
   reference's three shapes (``kernels/schedule.ball_schedule``,
   ``group_schedule``: K10 or K11, K12 or K13, each with its plan, ring
   depth and predicted µs), where the reference shows its TPU tiles.
3. System side: one PointNet++-style set-abstraction stage (sample →
   group → aggregate) through a fresh dispatcher on backend ``cuda``,
   held to ``pointcloud/ref.py`` exactly (indices and the max-pool).  On
   the card at PointNet++ SSG SA1 size (batch 16, 1024 points, 512
   centers, r 0.2, k 32, 64 channels; K9, K10 or K11, K12 or K13);
   ``--smoke`` runs the reference's size (1, 128, 32, r 1.2, k 8, 16).

    PYTHONPATH=src python examples/torch/pointcloud.py
    PYTHONPATH=src python examples/torch/pointcloud.py --smoke --device cpu
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.compile import Dispatcher, LoweringConfig
from repro_torch.compile.trace import trace_term
from repro_torch.core.interface_model import H100_CLOCK_HZ
from repro_torch.core.offload import compile_program, evaluate
from repro_torch.kernels import schedule
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.pointcloud import set_abstraction
from repro_torch.pointcloud import ref
from repro_torch.pointcloud.ops import register_pointcloud_intrinsics
from repro_torch.targets import isax_library

#: (batch, points, centers, k, channels, radius) of the stage: PointNet++
#: SSG ModelNet40 SA1 (Qi et al., NeurIPS 2017) at batch 16 with 64
#: channels, and the reference example's size for --smoke.
SA1 = (16, 1024, 512, 32, 64, 0.2)
SMOKE = (1, 128, 32, 8, 16, 1.2)
#: The reference's three gather shapes: (label, op, centers, points, k,
#: channels).
GATHERS = (("ball_query 256c/4096pts/k16", "ball_query", 256, 4096, 16, 0),
           ("group_agg 64c/4096pts/k8/c64", "group_aggregate", 64, 4096, 8,
            64),
           ("group_agg 512c/512pts/k64/c256", "group_aggregate", 512, 512,
            64, 256))


def software_side(device) -> dict:
    print("== 1. E-graph compilation of the point-cloud loops (§5) ==")
    register_pointcloud_intrinsics(device)
    stats = {}
    for kind in ("fps", "ball_query", "group_aggregate"):
        res = compile_program(trace_term(kind), isax_library(), case=kind)
        s = res.stats
        stats[kind] = dict(matched=list(s.matched_isaxes),
                           internal=s.internal_rewrites,
                           enodes=[s.initial_enodes, s.saturated_enodes])
        print(f"  {kind:16s} matched={s.matched_isaxes} "
              f"(int={s.internal_rewrites} rewrites, "
              f"e-nodes {s.initial_enodes} -> {s.saturated_enodes})")

    # offloaded fps program == software program (the numpy evaluator)
    rng = np.random.default_rng(0)
    n, n_s = 64, 8
    env = dict(Xp=rng.normal(size=(n, 3)), n_s=n_s, Dp=np.full((1, n), 1e30),
               Sp=np.zeros(n_s, np.int64))
    env2 = {k: (v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in env.items()}
    res = compile_program(trace_term("fps"), isax_library(), case="fps")
    evaluate(trace_term("fps"), env)
    evaluate(res.program, env2)
    ok = bool((env["Sp"] == env2["Sp"]).all())
    print(f"  offloaded fps == original: {ok}\n")
    if not ok:
        raise AssertionError("the offloaded fps program's indices differ "
                             "from the software program's")
    return {"match": stats, "fps_equal": ok}


def hardware_side() -> dict:
    print("== 2. H100 schedules for the gather shapes (§4) ==")
    out = {}
    for label, op, M, N, k, C in GATHERS:
        s = (schedule.ball_schedule(1, N, M, k, 4) if op == "ball_query"
             else schedule.group_schedule(1, N, M, k, C, 4))
        us = s["est_cycles"] / H100_CLOCK_HZ * 1e6
        out[label] = dict(kernel=s["kernel"], plan=s["plan"],
                          depth=s["depth"], pipelined=s["pipelined"],
                          gain=s["pipeline_gain"], predicted_us=us)
        print(f"  {label}: {s['kernel']} plan={s['plan']} "
              f"depth={s['depth']} (pipeline gain {s['pipeline_gain']:.2f}x"
              f", predicted {us:.2f} µs)")
    print()
    return out


def stage_inputs(smoke: bool):
    """(xyz, features) as numpy float32 and the stage's (M, k, radius):
    normal(0, 1) from numpy's seed 1, as ``launch/pointcloud.py`` makes
    them."""
    B, N, M, k, C, r = SMOKE if smoke else SA1
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(B, N, 3)).astype(np.float32)
    feats = rng.normal(size=(B, N, C)).astype(np.float32)
    return xyz, feats, M, k, r


def system_side(device, smoke: bool) -> dict:
    print("== 3. Set abstraction through compile dispatch ==")
    xyz_np, feats_np, M, K, r = stage_inputs(smoke)
    xyz = torch.from_numpy(xyz_np).to(device)
    feats = torch.from_numpy(feats_np).to(device)
    disp = Dispatcher()
    lw = LoweringConfig.from_registry("cuda", dispatcher=disp)
    sel, centers, idx, agg = set_abstraction(lw, xyz, feats, M, r, K)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    set_abstraction(lw, xyz, feats, M, r, K)
    if device.type == "cuda":
        torch.cuda.synchronize()
    stage_ms = (time.perf_counter() - t0) * 1e3
    checks = {
        "fps": torch.equal(sel, ref.fps_ref(xyz, M)),
        "ball_query": torch.equal(idx, ref.ball_query_ref(xyz, centers, r, K)),
        "group_aggregate": torch.equal(agg,
                                       ref.group_aggregate_ref(feats, idx))}
    B, N, C = feats.shape
    ok = all(checks.values())
    print(f"  sample({M} of {N}) -> group(k={K}, r={r}) -> aggregate({C}ch), "
          f"batch {B} on {device}: parity={'OK' if ok else 'FAIL'}, stage "
          f"{stage_ms:.3f} ms (host clock, warm)")
    records = {}
    for rec in disp.records.values():
        sched = rec.schedule or {}
        records[rec.key.op] = dict(impl=rec.impl, kernel=sched.get("kernel"),
                                   pipelined=sched.get("pipelined", False),
                                   gain=sched.get("pipeline_gain", 1.0))
        print(f"  {rec.key.op:16s} impl={rec.impl} "
              f"kernel={sched.get('kernel')} "
              f"pipelined={sched.get('pipelined', False)} "
              f"(gain={sched.get('pipeline_gain', 1.0):.2f}x)")
    if not ok:
        raise AssertionError(f"point-cloud stage differs from pointcloud/"
                             f"ref.py: {checks}")
    return {"shape": [B, N, M, K, C, r], "checks": checks,
            "stage_ms": stage_ms, "records": records,
            "indices": (sel, idx), "aggregate": agg}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; fails without a card) or 'cpu'")
    ap.add_argument("--smoke", action="store_true",
                    help="the reference example's stage size")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = {"device": str(device), **software_side(device),
           "schedules": hardware_side(),
           "stage": system_side(device, args.smoke)}
    print("\npointcloud example OK")
    return out


if __name__ == "__main__":
    main()

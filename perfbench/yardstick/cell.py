"""One run of one cell: find its files by name, set the program up, drive
the window, check the served tokens against the reference, and reduce
everything to the cell's metrics.

Files, found from the names in ``BENCHMARK.json``:

* ``workloads/<cell>.json``: the engine's settings, the fixed rate, the
  ramp before the window, and the check (sample size, limits; a
  ``kv_error_limit`` turns on the KV cache's check);
* ``configs/<config>.json``: the model as it is run (``port``: the
  program's ``ModelConfig`` fields), beside the source's own keys;
* ``traffic/<mix>.json``: the mix, read by ``traffic``;
* ``metrics/<metric>.py``: a reader ``read(run) -> float | None`` for each
  metric; None leaves the metric out of the line;
* ``kernel_ops/<op>.json``: the kernel names that implement an op.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import pathlib
import time
from typing import Optional

from . import check, drivers, traffic, weights
from .tracing import Tracer

HERE = pathlib.Path(__file__).resolve().parent.parent   # perfbench/
REFERENCES = {"dense": "reference.granite", "ssm": "reference.mamba2"}
#: Seconds of the window's end that a ``--trace 1`` run profiles
TRACE_S = 5.0
#: Requests whose KV cache a cell with a ``kv_error_limit`` checks
KV_SAMPLE = 2


@dataclasses.dataclass
class Spec:
    """A cell's entry in ``BENCHMARK.json`` and its files."""

    name: str
    chips: int
    cell: dict
    config: dict
    mix: dict
    end_to_end: list
    per_layer: list


def load_spec(bench: dict, name: str) -> Spec:
    """The cell ``name`` of ``bench`` (``BENCHMARK.json``'s content)."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def here(m):
        return "workloads" not in m or name in m["workloads"]

    def read(*parts):
        return json.loads(HERE.joinpath(*parts).read_text())

    return Spec(name, int(entry["chips"]), read("workloads", f"{name}.json"),
                read("configs", f"{entry['config']}.json"),
                read("traffic", f"{entry['traffic']}.json"),
                [m for m in bench["end_to_end"] if here(m)],
                [m for m in bench["per_layer"] if here(m)])


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_patterns(op: str) -> list[str]:
    """Substrings of the kernel names that implement ``op``."""
    return json.loads((HERE / "kernel_ops" / f"{op}.json").read_text())[
        "kernels"]


@dataclasses.dataclass
class Run:
    """What a run's metric readers read."""

    model: dict
    cell: dict
    seconds: float
    t_open: float
    t_close: float
    spans_end: float          # the window's untraced part ends here
    setup_s: float
    requests: list
    steps: list = dataclasses.field(default_factory=list)
    batches: list = dataclasses.field(default_factory=list)
    trace: Optional[object] = None
    traced_host: Optional[tuple] = None

    def due_in_window(self) -> list:
        return [r for r in self.requests
                if self.t_open <= r.due <= self.t_close]

    def untraced(self, t0: float, t1: float) -> bool:
        """Whether [t0, t1] lies in the window's untraced part."""
        return t0 >= self.t_open and t1 <= self.spans_end

    def traced(self, t0: float, t1: float) -> bool:
        """Whether [t0, t1] lies in the traced slice."""
        return (self.traced_host is not None and t0 >= self.traced_host[0]
                and t1 <= self.traced_host[1])

    def kv_live_shares(self) -> list:
        """For each decode step of the window's untraced part, the % of
        the paged pool's positions (slots × ``max_len``) that hold a live
        token's K/V: the keys that step attended."""
        e = self.cell["engine"]
        pool = e["max_batch"] * e["max_len"]
        return [100.0 * s.decode[2] / pool for s in self.steps
                if s.decode is not None and self.untraced(s.t0, s.t1)]

    def kernel_time_s(self, op: str) -> Optional[float]:
        """Device seconds of the traced kernels that implement ``op``
        (None where none ran)."""
        pats = kernel_patterns(op)
        hits = [e - s for n, s, e in self.trace.device
                if any(p in n for p in pats)]
        return sum(hits) if hits else None


def model_config(m: dict):
    """The program's ``ModelConfig`` for the configuration's ``port``."""
    from repro_torch.configs.base import ModelConfig, SSMConfig
    kw = dict(m)
    if kw.get("ssm"):
        kw["ssm"] = SSMConfig(**kw["ssm"])
    return ModelConfig(**kw)


def build_engine(spec: Spec, cfg, params, device):
    """The program's engine for the cell, warmed on every shape its
    traffic uses."""
    import numpy as np
    from repro_torch.compile.config import LoweringConfig
    from repro_torch.serve.engine import ContinuousEngine, ServeEngine
    from repro_torch.serve.scheduler import Request
    e = spec.cell["engine"]
    lowering = LoweringConfig("cuda")
    if e["kind"] == "continuous":
        eng = ContinuousEngine(cfg, params, max_batch=e["max_batch"],
                               page_size=e["page_size"], max_len=e["max_len"],
                               prompt_buckets=tuple(e["prompt_buckets"]),
                               lowering=lowering, device=device)
        # a prompt that fills each bucket, as far as max_len leaves room
        eng.run([Request(-1 - j, np.zeros(min(b, eng.max_len - 2), np.int32),
                         2) for j, b in enumerate(eng.prompt_buckets)])
        return eng
    if e["kind"] == "static":
        mix = spec.mix
        S = traffic.max_length(mix["prompt_len"])
        n = traffic.max_length(mix["output_len"])
        eng = ServeEngine(cfg, params, max_len=S + n, lowering=lowering,
                          device=device)
        eng.generate({"tokens": np.zeros((int(mix["batch"]), S), np.int32)},
                     n)
        return eng
    raise ValueError(f"unknown engine kind {e['kind']!r}")


def run_cell(spec: Spec, seed: int, seconds: float, trace: bool,
             t_begin: float, device="cuda", model: Optional[dict] = None,
             quant_control: bool = False) -> dict:
    """One run.  ``t_begin`` is when the process began (set-up counts from
    there); ``model`` replaces the configuration's ``port`` (tests at a
    tiny size); ``quant_control`` also reads the fp8 control's gap.
    Returns the result's fields and ``checks``."""
    import torch
    dev = torch.device(device)
    m = dict(model or spec.config["port"])
    cfg = model_config(m)
    t_w = time.perf_counter()
    params = weights.draw(m, seed, dev)
    drivers.sync(dev)
    t_e = time.perf_counter()
    eng = build_engine(spec, cfg, params, dev)
    tracer = Tracer(trace, dev)
    tracer.warm()
    drivers.sync(dev)
    t_start = time.perf_counter()
    setup_s = t_start - t_begin
    parts = (f"set-up {setup_s:.3f} s: imports {t_w - t_begin:.3f}, "
             f"weights {t_e - t_w:.3f}, engine and warm-up "
             f"{t_start - t_e:.3f}")
    cell = spec.cell
    vocab = m["vocab"]
    trace_s = min(TRACE_S, seconds / 2)
    if spec.mix["loop"] == "open":
        ramp = cell["ramp_s"]
        t_open = t_start + ramp
        t_close = t_open + seconds
        plan = traffic.open_schedule(spec.mix, cell["rate_per_s"], ramp,
                                     seconds, seed, vocab)
        reqs, steps = drivers.serve_open(eng, plan, t_start, t_close, tracer,
                                         t_close - trace_s,
                                         sync_prefill=trace)
        batches = []
    else:
        t_open, t_close = t_start, t_start + seconds
        gen = traffic.ClosedBatches(spec.mix, seed, vocab)
        reqs, batches = drivers.serve_batches(eng, gen, t_close, tracer,
                                              t_close - trace_s)
        steps = []
        # a closed loop's window is whole batches: it closes when the
        # batch running at --seconds ends
        t_close = max(t_close, batches[-1].t1)
    drivers.sync(dev)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if trace and tracer.host[1] is None:
        raise RuntimeError("the traced slice caught no step")
    tr = tracer.reduce() if trace else None
    kv = (check.kv_snapshot(eng, KV_SAMPLE, seed)
          if "kv_error_limit" in cell["check"] else None)
    run = Run(m, cell, t_close - t_open, t_open, t_close,
              tracer.host[0] if tr is not None else t_close, setup_s, reqs,
              steps, batches, tr, tracer.host if tr is not None else None)
    report = window_report(run)
    del eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_c = time.perf_counter()
    checks, control = served_check(spec, m, params, reqs, seed, dev,
                                   quant_control, kv)
    report += [parts, f"check {time.perf_counter() - t_c:.3f} s"]
    return {"run": run, "checks": checks, "control": control,
            "report": report, "memory_peak_bytes": int(peak),
            "attempted": len(run.due_in_window()),
            "failed": sum(r.failed for r in run.due_in_window())}


def window_report(run: Run) -> list[str]:
    """Lines for standard error: requests due, finished, unfinished,
    failed, and how late the open loop's submissions ran."""
    due = run.due_in_window()
    fin = sum(r.done and r.times[-1] <= run.t_close for r in due)
    failed = sum(r.failed for r in due)
    late = [r.t_submit - r.due for r in run.requests
            if r.t_submit is not None]
    lines = [f"window {run.seconds:g} s: requests due {len(due)}, finished "
             f"{fin}, unfinished {len(due) - fin - failed}, failed "
             f"{failed}"]
    if late and run.steps:
        late.sort()
        lines.append(f"generator lateness (submission after due): mean "
                     f"{1e3 * sum(late) / len(late):.3f} ms, p50 "
                     f"{1e3 * late[len(late) // 2]:.3f} ms, max "
                     f"{1e3 * late[-1]:.3f} ms over {len(late)} requests")
    return lines


def served_check(spec: Spec, m: dict, params, reqs, seed: int, dev,
                 quant_control: bool, kv: Optional[list] = None):
    """``logit_gap`` of a sample of the finished requests against the
    reference, ``kv_error`` of the cache snapshot ``kv`` where the cell
    checks one, and the fp8 control's readings of both when asked."""
    import torch
    ref = importlib.import_module(REFERENCES[m["family"]])
    want = spec.cell["check"]
    checks = {"logit_gap": {"value": None, "limit": want["logit_gap_limit"]},
              "sampled_tokens": {"value": 0, "limit": 1}}
    control = {}
    if kv is not None:
        checks["kv_error"] = {"value": None, "limit": want["kv_error_limit"]}
    if kv:
        seqs = [torch.as_tensor(t, device=dev) for _, t, _, _ in kv]
        lens = [p for p, _, _, _ in kv]
        ref_kv = ref.kv_at(params, m, seqs)
        checks["kv_error"]["value"] = check.kv_error(
            ref_kv, [(k, v) for _, _, k, v in kv], lens)
        if quant_control:
            control["kv_error"] = check.kv_error(
                ref_kv, ref.kv_at(params, m, seqs, quant="fp8"), lens)
        del ref_kv
    picked = check.sample(reqs, want["sample"], seed)
    if picked:
        seqs, wanted, served = check.sequences(picked, dev)
        ref_logits = ref.logits_at(params, m, seqs, wanted)
        checks["logit_gap"]["value"] = check.widest_gap(ref_logits, served)
        checks["sampled_tokens"]["value"] = sum(len(s) for s in served)
        if quant_control:
            control["logit_gap"] = check.control_gap(
                ref_logits, ref.logits_at(params, m, seqs, wanted,
                                          quant="fp8"))
    return checks, (control or None)


def passed(checks: dict) -> bool:
    """Every number within its limit: a gap or an error at or under it,
    at least the least number of sampled tokens."""
    return all(
        c["value"] is not None and (c["value"] >= c["limit"]
                                    if name == "sampled_tokens"
                                    else c["value"] <= c["limit"])
        for name, c in checks.items())


def metrics(spec: Spec, run: Run, trace: bool) -> dict:
    """The cell's end-to-end metrics (``--trace 0``) or per-layer metrics
    (``--trace 1``) that its readers find."""
    out = {}
    for m in (spec.per_layer if trace else spec.end_to_end):
        v = reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out

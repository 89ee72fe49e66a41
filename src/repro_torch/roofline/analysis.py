"""Three-term roofline and the overlap bound of a pipelined kernel, with the
machine's peaks as an argument.

    compute term    = FLOPs / (chips × peak FLOP/s)
    memory term     = bytes / (chips × memory rate)
    collective term = collective wire bytes a chip / link rate

The port's copy of ``repro.roofline.analysis``.  The reference fixes a
TPU v5e's peaks as module constants; here they are a ``Peaks`` the caller
passes: ``TPU_V5E`` (for parity with the reference's schedules) or
``H100`` (NVIDIA's data sheet, SXM part, dense rates at 700 W).

``parse_collectives`` walks XLA's HLO text in the reference; here
``CostRecorder``, a ``TorchDispatchMode``, sees every collective that
DTensor (or the code) issues on local tensors as it runs: its kind, result
bytes and group size, with the reference's ring formulas for wire bytes
(``collective_stats``).  It lets DTensor ops pass (``NotImplemented``) and
counts their local ops, so its FLOPs (by ``torch.utils.flop_counter``'s
formulas) and bytes are a device's, as ``cost_analysis`` gives them.
The port's layers are a Python loop, so a collective inside a layer is
recorded once for every execution: ``counts`` are executions and
``result_bytes`` already total over them, and ``in_loop_counts`` stays
zero (nothing is counted once for a loop body).
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode


@dataclasses.dataclass(frozen=True)
class Peaks:
    """A machine's peak rates: FLOP/s by arithmetic type, memory and link
    bytes/s."""

    name: str
    flops: dict[str, float]
    hbm_bw: float
    link_bw: float

    def flop_rate(self, kind: str) -> float:
        """Peak FLOP/s of arithmetic ``kind`` (a key of ``flops``)."""
        return self.flops[kind]


#: The reference's constants (``repro/roofline/analysis.py``): 197 TFLOP/s
#: bf16, 819 GB/s HBM, ~50 GB/s a link.
TPU_V5E = Peaks("tpu_v5e", {"bf16": 197e12}, 819e9, 50e9)
#: NVIDIA's H100 SXM data sheet: 67 TFLOP/s fp32 on the CUDA cores, 495
#: TF32, 989 bf16/fp16 on the tensor cores (dense), 3.35 TB/s HBM3, NVLink
#: 900 GB/s, 450 each way.
H100 = Peaks("h100_sxm", {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12},
             3.35e12, 450e9)


def pipeline_speedup(flops: float, hbm_bytes: float, n_chips: int = 1, *,
                     peaks: Peaks, kind: str = "bf16") -> float:
    """Roofline-level speedup bound for overlapping memory streaming with
    compute: serialized execution pays ``compute_s + memory_s``, a
    perfectly overlapped pipeline ``max(compute_s, memory_s)``; the ratio is
    the best any ring depth can reach.  ``core.kernel_synth`` takes the
    minimum of this bound and its interface-model estimate, so a pipelined
    kernel is never picked on a predicted loss.  ``kind`` names the
    arithmetic whose peak ``flops`` run at."""
    compute_s = flops / (n_chips * peaks.flop_rate(kind))
    memory_s = hbm_bytes / (n_chips * peaks.hbm_bw)
    overlapped = max(compute_s, memory_s)
    if overlapped <= 0:
        return 1.0
    return (compute_s + memory_s) / overlapped


@dataclasses.dataclass
class Roofline:
    flops: float
    hbm_bytes: float
    wire_bytes: float
    n_chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float

    def row(self) -> dict:
        return dataclasses.asdict(self)


def roofline(flops: float, hbm_bytes: float, wire_bytes_per_chip: float,
             n_chips: int, model_flops: float = 0.0, *,
             peaks: Peaks, kind: str = "bf16") -> Roofline:
    """The three terms and the one that bounds, at ``peaks``."""
    compute_s = flops / (n_chips * peaks.flop_rate(kind))
    memory_s = hbm_bytes / (n_chips * peaks.hbm_bw)
    collective_s = wire_bytes_per_chip / peaks.link_bw
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    useful = model_flops / flops if flops else 0.0
    return Roofline(flops, hbm_bytes, wire_bytes_per_chip, n_chips,
                    compute_s, memory_s, collective_s, bottleneck,
                    model_flops, useful)


COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")

# op name (functional and c10d) → the reference's collective kind
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "allreduce_": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "allgather_": "all-gather",
    "_allgather_base_": "all-gather", "all_gather_into_tensor_out":
        "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute",  # its recv is the same permute
}
_NAMESPACES = ("_c10d_functional", "c10d", "_c10d_functional_autograd")


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    result_bytes: dict
    wire_bytes_per_chip: float
    in_loop_counts: dict | None = None

    def total_result_bytes(self) -> float:
        return sum(self.result_bytes.values())


def wire_bytes(kind: str, result_bytes: float, group: int) -> float:
    """Ring-algorithm bytes a chip sends for one collective (the
    reference's formulas)."""
    g = max(group, 1)
    if kind == "all-reduce":
        return 2 * result_bytes * (g - 1) / g
    if kind in ("all-gather", "all-to-all"):
        return result_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)
    return result_bytes  # collective-permute


def collective_stats(records) -> CollectiveStats:
    """``CollectiveStats`` of (kind, result bytes, group size) records."""
    counts = {k: 0 for k in COLLECTIVE_OPS}
    rbytes = {k: 0.0 for k in COLLECTIVE_OPS}
    wire = 0.0
    for kind, r, g in records:
        counts[kind] += 1
        rbytes[kind] += r
        wire += wire_bytes(kind, r, g)
    return CollectiveStats(counts, rbytes, wire,
                           {k: 0 for k in COLLECTIVE_OPS})


def _tensors(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _group_size(func, args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in args:
        if isinstance(a, str):
            try:
                return _resolve_process_group(a).size()
            except (ValueError, RuntimeError, KeyError):
                continue
        if type(a).__name__ == "ScriptObject":
            try:
                return torch.distributed.ProcessGroup.unbox(a).size()
            except (TypeError, RuntimeError, AttributeError):
                continue
    return 1


class CostRecorder(TorchDispatchMode):
    """Records a device's collectives, FLOPs and bytes while a step runs.

    DTensor ops are let through (``NotImplemented``) so that DTensor runs
    them as local ops and collectives, which come back here.  ``flops``
    sums ``torch.utils.flop_counter``'s formulas over the local ops;
    ``bytes`` sums the inputs and outputs of every local op that is not a
    view (no fusion: an upper bound on memory traffic).  DTensor runs an
    op once more on fake tensors of the global shapes to propagate its
    metadata, inside ``ShardingPropagator._fake_mode_lock`` (a null
    context by default); while recording, that lock is this recorder's
    marker, and the ops run under it are not counted."""

    def __init__(self):
        super().__init__()
        self._propagating = 0
        from torch.utils.flop_counter import FlopCounterMode
        self._flop_registry = FlopCounterMode().flop_registry
        self.records: list = []
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not isinstance(func, torch._ops.OpOverload) or self._propagating:
            return out
        name = func._overloadpacket.__name__
        if func.namespace in _NAMESPACES:
            kind = _KINDS.get(name)
            if kind is not None:
                res = (_tensors(args[0]) if name.endswith("_")
                       or name == "send" else _tensors(out))
                self.records.append((kind, _nbytes(res),
                                     _group_size(func, args)))
            return out
        fc = self._flop_registry.get(func._overloadpacket)
        if fc is not None:
            self.flops += fc(*args, **kwargs, out_val=out)
        if not func.is_view:
            self.bytes += _nbytes(_tensors(args) + _tensors(
                list(kwargs.values())) + _tensors(out))
        return out

    def stats(self) -> CollectiveStats:
        return collective_stats(self.records)

    def __enter__(self):
        prop = _sharding_propagator()
        self._lock = prop._fake_mode_lock
        prop._fake_mode_lock = _Marker(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _sharding_propagator()._fake_mode_lock = self._lock
        return super().__exit__(*exc)


def _sharding_propagator():
    """DTensor's ``ShardingPropagator`` class, whose ``_fake_mode_lock``
    ``CostRecorder`` swaps for its marker; raises where this torch has no
    such lock (the recorder would count the propagation's ops)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    if not hasattr(ShardingPropagator, "_fake_mode_lock"):
        raise RuntimeError(
            "CostRecorder: this torch's ShardingPropagator has no "
            "_fake_mode_lock, so DTensor's metadata propagation cannot be "
            "told apart from the ops it runs")
    return ShardingPropagator


class _Marker:
    """Context that marks a ``CostRecorder`` as inside DTensor's metadata
    propagation."""

    def __init__(self, rec):
        self.rec = rec

    def __enter__(self):
        self.rec._propagating += 1

    def __exit__(self, *exc):
        self.rec._propagating -= 1

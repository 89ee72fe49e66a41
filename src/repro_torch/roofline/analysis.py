"""Three-term roofline and the overlap bound of a pipelined kernel, with the
machine's peaks as an argument.

    compute term    = FLOPs / (chips × peak FLOP/s)
    memory term     = bytes / (chips × memory rate)
    collective term = collective wire bytes a chip / link rate

The port's copy of ``repro.roofline.analysis`` without
``parse_collectives``, which parses XLA's HLO text and has no counterpart
until the port distributes work across cards.  The reference fixes a TPU
v5e's peaks as module constants; here they are a ``Peaks`` the caller
passes: ``TPU_V5E`` (for parity with the reference's schedules) or
``H100`` (NVIDIA's data sheet, SXM part, dense rates at 700 W).
"""

from __future__ import annotations

import dataclasses


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

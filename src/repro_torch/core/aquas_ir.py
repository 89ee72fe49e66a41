"""Aquas-IR: the three-level intermediate representation of paper §4.2.

Levels (Table 1):

  Functional     — access-mechanism-agnostic ops: ``transfer``, ``fetch``,
                   ``read_smem``.  μ-arch feature exposed: transfer size m.
  Architectural  — ops bound to one physical ``!memitfc<>`` symbol: ``copy``
                   (bulk) / ``load`` (scalar); legality now subject to the
                   chosen interface's constraints (W, M); latency estimable
                   via (I, L, E); cache penalties via C.
  Temporal       — asynchronous ``copy_issue``/``copy_wait`` pairs whose order
                   is pinned by ``after`` attributes; exposes in-flight-aware
                   ordering and hierarchy/phase order.

Here the IR is a set of plain dataclasses.  ``Program`` holds a
flat op list plus scratchpad declarations and loop-context annotations used by
scratchpad-buffer elision.  ``synthesis.py`` lowers Functional → Architectural
→ Temporal; ``kernel_synth.py`` interprets the temporal program as a kernel's
copy schedule.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

from repro_torch.core.interface_model import MemInterface


class CacheHint(enum.Enum):
    """§4.1 cache_hint labels: cold data goes straight to DRAM-level paths,
    warm data favours higher (closer) hierarchy levels."""

    COLD = "cold"
    WARM = "warm"
    NONE = "none"


class Space(enum.Enum):
    GLOBAL = "global"       # main memory (H100: HBM, through L2)
    SCRATCHPAD = "smem"     # explicit local buffer (H100: shared memory)
    REG = "reg"             # register/vreg destination


@dataclasses.dataclass
class ScratchpadDecl:
    name: str
    size_bytes: int
    cache_hint: CacheHint = CacheHint.NONE
    # Elision-analysis context (§4.3): elision is disabled for scratchpads
    # accessed within unrolled regions, outside pipelined loops, or used
    # purely as local temporaries.
    accessed_in_unrolled_region: bool = False
    inside_pipelined_loop: bool = True
    purely_local_temp: bool = False
    # Affine reuse factor: how many times each element is re-read per staging.
    # reuse > 1 means elision would multiply global traffic by `reuse`.
    reuse_factor: int = 1
    # Per-element access can be hidden behind this many cycles of compute
    # (paper: bias[i] latency "effectively hidden by the accumulation").
    compute_cycles_per_elem: float = 0.0
    elem_bytes: int = 4


# ---------------------------------------------------------------------------
# Functional level
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FuncOp:
    """Functional-level memory op: mechanism-agnostic."""

    kind: str                  # "transfer" | "fetch" | "read_smem" | "write_smem"
    name: str                  # ssa-ish identifier of the moved value
    size_bytes: int
    src_space: Space
    dst_space: Space
    direction: str             # "load" | "store" (w.r.t. the ISAX datapath)
    cache_hint: CacheHint = CacheHint.NONE
    scratchpad: Optional[str] = None   # set for read_smem/write_smem
    base_align: int = 4096     # assumed base address alignment


@dataclasses.dataclass
class FunctionalProgram:
    name: str
    ops: list[FuncOp]
    scratchpads: dict[str, ScratchpadDecl] = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# Architectural level
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ArchOp:
    """Architectural-level op bound to exactly one interface (``copy # bulk``
    or ``load # scalar``), already canonicalized into one legal transfer."""

    kind: str                  # "copy" | "load" | "store"
    name: str                  # originating functional op name
    size_bytes: int            # legal for `itfc`
    itfc: MemInterface
    direction: str             # "load" | "store"
    seq_index: int             # position within the originating op's split
    cache_hint: CacheHint = CacheHint.NONE

    def __post_init__(self) -> None:
        if not self.itfc.is_legal_transaction(self.size_bytes):
            raise ValueError(
                f"{self.kind} {self.name}[{self.seq_index}]: {self.size_bytes}B "
                f"is not a legal transaction on {self.itfc.name} "
                f"(W={self.itfc.W}, M={self.itfc.M})")


@dataclasses.dataclass
class ArchitecturalProgram:
    name: str
    ops: list[ArchOp]
    scratchpads: dict[str, ScratchpadDecl] = dataclasses.field(default_factory=dict)
    # synthesis log: which functional decisions were taken
    decisions: dict[str, str] = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# Temporal level
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TemporalOp:
    """Asynchronous issue/wait pair; ordering guaranteed by ``after``."""

    kind: str                  # "copy_issue" | "copy_wait" | "load_issue" | ...
    op_id: int
    name: str
    size_bytes: int
    itfc: MemInterface
    direction: str
    after: Optional[int] = None    # op_id this one is ordered after
    issue_cycle: float = -1.0      # model-estimated
    complete_cycle: float = -1.0


@dataclasses.dataclass
class TemporalProgram:
    name: str
    ops: list[TemporalOp]
    total_cycles: float = 0.0
    scratchpads: dict[str, ScratchpadDecl] = dataclasses.field(default_factory=dict)
    decisions: dict[str, str] = dataclasses.field(default_factory=dict)

    def schedule_table(self) -> list[tuple[str, float, float]]:
        issues = [o for o in self.ops if o.kind.endswith("_issue")]
        return [(o.name, o.issue_cycle, o.complete_cycle) for o in issues]

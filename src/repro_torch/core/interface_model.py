"""Core-ISAX memory interface model (Aquas paper §4.1), with a TPU instance
(the reference's, for parity) and an H100 instance (the port's card).

Each memory interface ``k`` is a 6-tuple ``(W_k, M_k, I_k, L_k, E_k, C_k)``:

    W_k : interface width in bytes (per beat)
    M_k : maximum beat count of one transaction
    I_k : maximum in-flight transactions
    L_k : read lead-off latency (cycles/beats)
    E_k : write completion cost
    C_k : cache-line size visible to that interface (bytes)

Microarchitectural constraints: a transaction of size ``m`` is legal iff
``m / W_k == 2**t <= M_k`` for some nonnegative integer ``t`` and the starting
address is aligned to ``m``.  Reads and writes pipeline independently up to
``I_k`` outstanding transactions.

The latency recurrences (paper, verbatim):

    a_j      = 1 + max(a_{j-1}, b_{j-I_k})
    b_j^ld   = m_j / W_k + max(b_{j-1}, a_j + L_k - 1)
    b_j^st   = m_j / W_k + E_k + max(b_{j-1}, a_j - 1)

with ``a_j = b_j = -1`` for ``j <= 0``.  ``b_N`` is the estimated latency of a
sequence of N same-direction transactions on interface ``k``.

On TPU, "cycles" are DMA beats: one ``hbm_vmem`` beat is 512 B at HBM bandwidth
(~819 GB/s / 1.6 GHz ≈ 512 B/cycle), in-flight transactions are concurrently
outstanding DMA copies (double/triple buffering), and C_k is the HBM burst
granularity.  The model's *decisions* (path choice, split, order) transfer; the
constants are v5e-flavoured.

On the H100 (``hopper_interfaces``) a cycle is one of the SM clock and an
interface is one SM's port: HBM → shared memory (``cp.async`` and TMA),
L2 → shared memory (operands that the 50 MB L2 holds), shared memory →
registers.  ``W`` is the SM's share of the device's rate over the SMs a
grid keeps busy, at most what one SM pulls alone; ``L`` the lead-off
latency.  Each constant names its source: NVIDIA's data sheet, the probe
``tools/hopper_interface_probe.py``, or a chip run the repository records.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Literal, Sequence


@dataclasses.dataclass(frozen=True)
class MemInterface:
    """One memory interface ``k`` as the paper's 6-tuple (plus identity/hints)."""

    name: str
    W: int  # width (bytes per beat)
    M: int  # max beats per transaction
    I: int  # max in-flight transactions
    L: int  # read lead-off latency
    E: int  # write completion cost
    C: int  # visible cache-line size (bytes)
    # TPU extension: which level of the memory hierarchy this interface reaches.
    # Smaller = closer to compute.  Used by transaction grouping (§4.3) and the
    # cache_hint machinery ("warm" data favours low levels).
    hierarchy_level: int = 1

    def __post_init__(self) -> None:
        if self.W <= 0 or self.M <= 0 or self.I <= 0:
            raise ValueError(f"interface {self.name}: W, M, I must be positive")
        if self.M & (self.M - 1):
            raise ValueError(f"interface {self.name}: M must be a power of two")

    # ---- microarchitectural constraints -------------------------------------

    def max_transaction_bytes(self) -> int:
        return self.W * self.M

    def is_legal_transaction(self, m: int, addr: int = 0) -> bool:
        """A transaction of m bytes is legal iff m/W == 2^t <= M and addr % m == 0."""
        if m <= 0 or m % self.W:
            return False
        beats = m // self.W
        if beats & (beats - 1):  # power of two
            return False
        if beats > self.M:
            return False
        return addr % m == 0

    def legal_sizes(self) -> list[int]:
        """All legal transaction sizes in decreasing order."""
        return [self.W * (1 << t) for t in range(int(math.log2(self.M)), -1, -1)]

    def decompose(self, m: int, addr: int = 0) -> list[int]:
        """Greedily split an ``m``-byte request into legal transfers, decreasing
        (paper §4.3 "greedily splits the request into legal transfer sizes of
        interface k in decreasing order").  Requests smaller than W are padded
        to one beat (hardware always moves whole beats)."""
        if m <= 0:
            return []
        # pad to beat multiple
        m = ((m + self.W - 1) // self.W) * self.W
        out: list[int] = []
        cursor = addr
        remaining = m
        for size in self.legal_sizes():
            while remaining >= size and (cursor % size == 0 or cursor == addr):
                # natural alignment: after the first (base-aligned) chunk,
                # subsequent cursors stay aligned because sizes decrease.
                if cursor % size:
                    break
                out.append(size)
                cursor += size
                remaining -= size
        if remaining:
            # fall back: emit single beats
            while remaining > 0:
                out.append(self.W)
                remaining -= self.W
        return out


Direction = Literal["load", "store"]


def sequence_latency(
    itfc: MemInterface,
    sizes: Sequence[int],
    direction: Direction = "load",
) -> int:
    """Exact latency recurrence from §4.1 for N same-direction transactions.

    Returns b_N, the completion cycle of the last transaction (cycles, with
    cycle 0 being the first issue opportunity; a_j=b_j=-1 for j<=0).
    """
    n = len(sizes)
    if n == 0:
        return 0
    a = [-1.0] * (n + 1)
    b = [-1.0] * (n + 1)
    for j in range(1, n + 1):
        m_j = sizes[j - 1]
        beats = m_j / itfc.W
        b_wait = b[j - itfc.I] if j - itfc.I >= 1 else -1.0
        a[j] = 1 + max(a[j - 1], b_wait)
        if direction == "load":
            b[j] = beats + max(b[j - 1], a[j] + itfc.L - 1)
        else:
            b[j] = beats + itfc.E + max(b[j - 1], a[j] - 1)
    return int(math.ceil(b[n]))


def approx_latency(
    itfc: MemInterface,
    op_sizes_decomposed: Sequence[Sequence[int]],
    direction: Direction = "load",
) -> float:
    """Approximation model T_k from §4.3 used inside interface selection.

        T_k^ld = L_k - 1 + Σ_q Σ_p max(L_k / I_k, m_{q,p} / W_k)
        T_k^st = Σ_q Σ_p (m_{q,p} / W_k + E_k) - 1

    where ``op_sizes_decomposed[q]`` is the legal decomposition {m_{q,p}}_p of
    operation q on this interface.  L_k/I_k simulates bubbles from the limited
    in-flight window.
    """
    if not op_sizes_decomposed:
        return 0.0
    if direction == "load":
        total = itfc.L - 1.0
        for chunks in op_sizes_decomposed:
            for m in chunks:
                total += max(itfc.L / itfc.I, m / itfc.W)
        return total
    total = -1.0
    for chunks in op_sizes_decomposed:
        for m in chunks:
            total += m / itfc.W + itfc.E
    return total


def cache_sync_penalty(itfc: MemInterface, m_q: int) -> float:
    """Second objective term of §4.3: ⌈m_q / C_k⌉ · C_k / W_k — the beat count
    needed to synchronize the touched cache lines on a hierarchy mismatch."""
    return math.ceil(m_q / itfc.C) * (itfc.C / itfc.W)


# ---------------------------------------------------------------------------
# Interface libraries
# ---------------------------------------------------------------------------

def paper_example_interfaces() -> dict[str, MemInterface]:
    """The two interfaces of the paper's Figure 2 example.

    @itfc1: instruction-extension port — low latency, 32-bit, no burst, one
            in-flight transaction.
    @itfc2: system bus — 64-bit datapath with 4-byte granularity, burst up to
            64 B, two in-flight, higher latency.  (W=4, M=16 reproduces the
            paper's Figure 4(b) canonicalization of a 108-byte request into
            64-, 32-, 8-, and 4-byte legal transfers.)
    """
    return {
        "cpuitfc": MemInterface("cpuitfc", W=4, M=1, I=1, L=2, E=1, C=64,
                                hierarchy_level=0),
        "busitfc": MemInterface("busitfc", W=4, M=16, I=2, L=6, E=2, C=64,
                                hierarchy_level=1),
    }


# v5e-flavoured constants (see DESIGN.md §3.1).
TPU_PEAK_FLOPS_BF16 = 197e12      # per chip
TPU_HBM_BW = 819e9                # bytes/s per chip
TPU_ICI_BW_PER_LINK = 50e9        # bytes/s per link (~)
TPU_VMEM_BYTES = 128 * 1024 * 1024
TPU_VMEM_BUDGET = 64 * 1024 * 1024  # usable per kernel invocation (conservative)
TPU_CLOCK_HZ = 1.6e9
MXU_DIM = 128
VPU_LANES = 8  # sublane granularity for f32


def tpu_interfaces() -> dict[str, MemInterface]:
    """TPU v5e memory-path instances of the 6-tuple model.

    hbm_vmem:  one beat = 512 B (819 GB/s / 1.6 GHz); DMA lead-off ~450 ns
               ≈ 700 cycles; up to 4 outstanding DMA copies; burst up to 512 KiB.
    vmem_vreg: on-chip load path, effectively immediate.
    ici_link:  one beat = 32 B (50 GB/s / 1.6 GHz); high lead-off (~1.25 us);
               big bursts; 4 outstanding sends.
    """
    return {
        "hbm_vmem": MemInterface("hbm_vmem", W=512, M=1024, I=4, L=700, E=64,
                                 C=512, hierarchy_level=1),
        "vmem_vreg": MemInterface("vmem_vreg", W=512, M=8, I=8, L=2, E=1,
                                  C=512, hierarchy_level=0),
        "ici_link": MemInterface("ici_link", W=32, M=4096, I=4, L=2000, E=64,
                                 C=512, hierarchy_level=2),
    }


def effective_bandwidth(
    itfc: MemInterface,
    transfer_bytes: int,
    direction: Direction = "load",
    clock_hz: float = TPU_CLOCK_HZ,
) -> float:
    """Model-predicted effective bytes/s for a single decomposed transfer —
    used by kernel_synth to compare staging strategies."""
    chunks = itfc.decompose(transfer_bytes)
    cyc = sequence_latency(itfc, chunks, direction)
    if cyc <= 0:
        return float("inf")
    return transfer_bytes * clock_hz / cyc


# ---------------------------------------------------------------------------
# The H100 instance
# ---------------------------------------------------------------------------

#: SMs and L2 of an H100 SXM (data sheet); the schedules take the device's
#: own (``torch.cuda.get_device_properties``) where a card is at hand.
H100_SMS = 132
H100_L2_BYTES = 50 * 1024 * 1024
#: Shared memory a block may use (data sheet: 227 KB; the kernels' build,
#: ``kernels/_build.MAX_SMEM``) and an SM's, with what the SM keeps back a
#: resident block (``kernels/pipeline.SM_SMEM``, ``BLOCK_RESERVED_SMEM``).
H100_SMEM_BLOCK = 232_448
H100_SMEM_SM = 233_472
H100_SMEM_RESERVED = 1024
#: Threads and registers of an SM (data sheet).
H100_SM_THREADS = 2048
H100_SM_REGS = 65_536
#: Device read rates (bytes/s): HBM3 from the data sheet; L2 from a chip
#: run (``chip_smoke.l2_read_rate``: a warm 16 MB ``torch.sum``; PERF.md).
H100_HBM_BW = 3.35e12
H100_L2_BW = 8.93e12
#: Shared memory → registers: 32 banks of 4 bytes a cycle an SM (Hopper
#: architecture white paper).
H100_SMEM_BYTES_PER_CYCLE = 128
#: Measured by ``tools/hopper_interface_probe.py`` (two runs on an NVIDIA
#: H100 80GB HBM3 at 700 W): the SM clock under load (1.994 and 1.978
#: GHz); lead-off latencies in its cycles of a load that hits L2 (292,
#: 283), one that goes to HBM (705, 694) and a shared-memory load (28.6);
#: the bytes a cycle one SM pulls alone from L2 (114) and from HBM (69).
H100_CLOCK_HZ = 1.986e9
H100_L2_LATENCY = 287
H100_HBM_LATENCY = 700
H100_SMEM_LATENCY = 29
H100_SM_L2_BYTES_PER_CYCLE = 114
H100_SM_HBM_BYTES_PER_CYCLE = 69
#: Copies a block keeps in flight at most: the deepest ring the kernels
#: are built for (``kernels/pipeline.DEPTHS``).
H100_COPIES_IN_FLIGHT = 4
#: Largest transfer one copy instruction makes: a TMA box of 256 rows of
#: 256 bytes (the CUDA programming guide's box limits).
H100_MAX_COPY_BYTES = 65_536


def hopper_interfaces(active_sms: int = H100_SMS,
                      clock_hz: float = H100_CLOCK_HZ
                      ) -> dict[str, MemInterface]:
    """One SM's memory interfaces on an H100 when ``active_sms`` SMs pull at
    once: each gets its share of the device's rate, at most what one SM
    pulls alone.  Beats are cycles of the SM clock.

    hbm_smem:  HBM → shared memory by ``cp.async``/TMA; lead-off the HBM
               latency; lines of 128 bytes (L2's).
    l2_smem:   L2 → shared memory (or registers) for operands L2 holds;
               lead-off the L2 hit latency.
    smem_reg:  shared memory → registers: 128 bytes a cycle, one 128-byte
               wavefront a transaction, the shared-memory latency.
    """
    active = max(1, active_sms)

    def port(rate: float, alone: float) -> int:
        return max(1, round(min(alone, rate / (active * clock_hz))))

    def beats(w: int) -> int:   # a power of two covering the largest copy
        return 1 << max(0, math.ceil(math.log2(H100_MAX_COPY_BYTES / w)))

    w_hbm = port(H100_HBM_BW, H100_SM_HBM_BYTES_PER_CYCLE)
    w_l2 = port(H100_L2_BW, H100_SM_L2_BYTES_PER_CYCLE)
    return {
        "hbm_smem": MemInterface("hbm_smem", W=w_hbm, M=beats(w_hbm),
                                 I=H100_COPIES_IN_FLIGHT, L=H100_HBM_LATENCY,
                                 E=H100_L2_LATENCY, C=128, hierarchy_level=2),
        "l2_smem": MemInterface("l2_smem", W=w_l2, M=beats(w_l2),
                                I=H100_COPIES_IN_FLIGHT, L=H100_L2_LATENCY,
                                E=H100_L2_LATENCY, C=128, hierarchy_level=1),
        "smem_reg": MemInterface("smem_reg", W=H100_SMEM_BYTES_PER_CYCLE, M=1,
                                 I=H100_COPIES_IN_FLIGHT,
                                 L=H100_SMEM_LATENCY, E=1, C=128,
                                 hierarchy_level=0),
    }

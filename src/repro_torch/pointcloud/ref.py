"""Plain PyTorch versions of the point-cloud ops: the oracles of the CPU
tests and the yardsticks of the CUDA kernels on the card.

The port of ``repro/pointcloud/ref.py``, with its semantics:

* ``fps_ref`` starts at index 0 and computes squared distances in fp32
  whatever the input dtype; ``argmax`` takes the first occurrence.
* ``ball_query_ref`` returns the first ``k`` in-radius indices per center in
  ascending order (``d² ≤ r²``), padded with the first hit; a center with an
  empty ball gets its nearest point (first occurrence of the ``argmin``).
* ``group_aggregate_ref`` gathers the neighbour rows and takes their max.

Squared distances sum the squared differences left to right, each step
rounded on its own, as the reference does; index outputs must match it
exactly.
"""

from __future__ import annotations

import numpy as np
import torch


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distance over the last axis of ``a - b`` in fp32, summed left
    to right: ``(dx·dx + dy·dy) + dz·dz`` for 3-d points."""
    diff = a.float() - b.float()
    sq = diff * diff
    out = sq[..., 0]
    for j in range(1, sq.shape[-1]):
        out = out + sq[..., j]
    return out


def squared_radius(radius: float, radius_sq: float | None = None) -> float:
    """r² as the reference compares it: ``float32(r) · float32(r)`` rounded
    to fp32, or ``radius_sq`` as given (rounded to fp32)."""
    if radius_sq is not None:
        return float(np.float32(radius_sq))
    return float(np.float32(radius) * np.float32(radius))


def fps_ref(xyz: torch.Tensor, n_samples: int) -> torch.Tensor:
    """Farthest-point sampling: xyz (B, N, d) → indices (B, n_samples) i32."""
    pts = xyz.float()
    B, N, _ = pts.shape
    d = torch.full((B, N), 1e30, dtype=torch.float32, device=pts.device)
    last = torch.zeros(B, dtype=torch.long, device=pts.device)
    rows = torch.arange(B, device=pts.device)
    out = torch.empty((B, n_samples), dtype=torch.int32, device=pts.device)
    for s in range(n_samples):
        out[:, s] = last
        d = torch.minimum(d, sqdist(pts, pts[rows, last][:, None, :]))
        last = torch.argmax(d, dim=1)
    return out


def ball_query_ref(xyz: torch.Tensor, centers: torch.Tensor, radius: float,
                   k: int, radius_sq: float | None = None) -> torch.Tensor:
    """Ball query: xyz (B, N, d), centers (B, M, d) → indices (B, M, k) i32.

    ``radius_sq`` gives r² exactly where the caller holds it.
    """
    d2 = sqdist(centers[:, :, None, :], xyz[:, None, :, :])       # (B, M, N)
    B, M, N = d2.shape
    mask = d2 <= squared_radius(radius, radius_sq)
    rank = torch.cumsum(mask.to(torch.int32), dim=-1)              # (B, M, N)
    count = rank[..., -1]
    # hit number r (1-based) goes to slot r-1; later hits and misses go to a
    # spare slot k that is dropped
    slot = torch.where(mask & (rank <= k), rank - 1, k).long()
    sel = torch.zeros((B, M, k + 1), dtype=torch.long, device=d2.device)
    sel.scatter_(-1, slot, torch.arange(N, device=d2.device).expand(B, M, N))
    first = torch.argmax(mask.to(torch.int32), dim=-1)
    nearest = torch.argmin(d2, dim=-1)
    pad = torch.where(count > 0, first, nearest)
    ks = torch.arange(k, device=d2.device)
    out = torch.where(count[..., None] > ks, sel[..., :k], pad[..., None])
    return out.to(torch.int32)


def neighbour_rows(idx: torch.Tensor, n: int) -> torch.Tensor:
    """The rows that ``idx`` names as the reference's gather takes them: a
    negative index counts from the end, anything still outside [0, n) is
    clamped."""
    i = idx.long()
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def group_aggregate_ref(features: torch.Tensor,
                        idx: torch.Tensor) -> torch.Tensor:
    """Grouped max-pool: features (B, N, C), idx (B, M, k) → (B, M, C)."""
    B, N, _ = features.shape
    rows = torch.arange(B, device=features.device)[:, None, None]
    gathered = features[rows, neighbour_rows(idx, N)]             # (B, M, k, C)
    return gathered.amax(dim=2)

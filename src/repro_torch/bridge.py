"""Bring a ``repro`` param tree into the port.

The reference's params are nested dicts of ``jax.Array``; a caller turns
them into numpy first (``jax.tree.map(np.asarray, params)``) so that this
module needs no JAX.  Names, shapes and the stacked ``(L, ...)`` block
layout carry over unchanged; bf16 leaves (numpy's ``ml_dtypes.bfloat16``)
become ``torch.bfloat16``.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_numpy(tree, device="cpu"):
    """Nested dict of numpy arrays → the same dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _leaf(tree, device)

"""Tiling arithmetic shared by the kernel wrappers, the schedulers and the
dispatcher (the port's copy of ``repro.core.tiling``)."""

from __future__ import annotations

import numpy as np


def down_pow2(n: int, cap: int) -> int:
    """Largest power-of-two divisor of ``n``, at most ``cap``.

    Always divides ``n``, degrading toward 1-wide tiles when ``n`` has a
    large odd factor.
    """
    d = 1
    while n % (d * 2) == 0 and d * 2 <= cap:
        d *= 2
    return d


def dtype_itemsize(dtype) -> int:
    """Itemsize in bytes of a dtype: a ``torch.dtype``, a numpy dtype or a
    name such as ``"float32"``, ``"torch.bfloat16"`` or ``"bfloat16"``.

    Names numpy does not know (``bfloat16`` without ml_dtypes) take the
    width their suffix says, as the reference's schedulers do, so that the
    schedule a dispatcher records from the dtype name is the one a kernel
    wrapper derives from the tensor.
    """
    itemsize = getattr(dtype, "itemsize", None)
    if isinstance(itemsize, int):
        return itemsize
    name = str(dtype).removeprefix("torch.")
    try:
        return np.dtype(name).itemsize
    except TypeError:
        return 2 if name.endswith("16") else 4

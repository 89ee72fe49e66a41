"""Tile-rounding arithmetic shared by the kernel wrappers."""

from __future__ import annotations


def down_pow2(n: int, cap: int) -> int:
    """Largest power-of-two divisor of ``n``, at most ``cap``.

    Always divides ``n``, degrading toward 1-wide tiles when ``n`` has a
    large odd factor.
    """
    d = 1
    while n % (d * 2) == 0 and d * 2 <= cap:
        d *= 2
    return d

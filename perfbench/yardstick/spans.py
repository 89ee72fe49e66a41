"""The program's own spans (``repro_torch.obs``) as the per-layer readers
take them: None where the program has no recorder (a commit before it),
or where its ring pushed out spans that end at or after ``since``."""

from __future__ import annotations

import sys


def program_spans(since: float):
    """Every span the program recorded, or None (said on standard error
    where the ring lost spans from ``since`` on)."""
    try:
        from repro_torch import obs
    except ImportError:
        return None
    spans = obs.spans()
    lost = obs.dropped()
    if lost and (not spans or spans[0].t1 >= since):
        print(f"the program's span ring dropped {lost} spans, some of them "
              f"of the part read: no reading", file=sys.stderr)
        return None
    return spans


def children(spans) -> dict:
    """Each span's index → the spans it encloses directly."""
    out: dict = {}
    for s in spans:
        if s.parent is not None:
            out.setdefault(s.parent, []).append(s)
    return out


def pure_decode_steps(run, spans, part=None) -> list:
    """(step, its children) of the ``serve.step`` spans that decoded and
    admitted nothing, in the window's untraced part or where ``part``
    (``run.traced``) holds."""
    part = part or run.untraced
    kids = children(spans)
    out = []
    for s in spans:
        if s.name == "serve.step" and part(s.t0, s.t1):
            names = {c.name for c in kids.get(s.idx, ())}
            if "serve.decode.enqueue" in names and "serve.admit" not in names:
                out.append((s, kids[s.idx]))
    return out

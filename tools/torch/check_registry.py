"""Registry lint of the port: every registered ISAX is checked on the card
and tested against the reference.

Asserts, for every spec of ``repro_torch.targets.default_registry()``:

* it resolves end to end (kernel route, scheduler, trace program,
  evaluator — ``IsaxSpec.validate``),
* its bridging rewrites exist in ``repro_torch.core.rewrites.internal_rules``,

and, for every dispatchable spec (an ``isax`` and at least one dispatch
op), by spec name or by one of its ops:

* it is named in ``chip_smoke.py``, which holds every kernel route on the
  card (the counterpart of the reference's ``bench_compile_stats.py``
  sweep until the port has a benchmark; the check moves there then),
* it is named in some ``tests/test_torch_*.py``.

Run: ``PYTHONPATH=src python tools/torch/check_registry.py`` (exit 1 with
the violations).  Imports neither ``jax`` nor ``repro``.
"""

from __future__ import annotations

import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]


def main() -> None:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.rewrites import internal_rules
    from repro_torch.targets import default_registry

    reg = default_registry()
    smoke_src = (ROOT / "chip_smoke.py").read_text()
    test_srcs = [p.read_text() for p in (ROOT / "tests").glob("test_torch_*.py")]
    rule_names = {r.name for r in internal_rules()}
    errors: list[str] = []
    for spec in reg.specs():
        try:
            spec.validate()
        except ValueError as e:
            errors.append(f"{spec.name}: {e}")
            continue
        missing = set(spec.rewrites) - rule_names
        if missing:
            errors.append(f"{spec.name}: declares unknown bridging rewrites "
                          f"{sorted(missing)}")
        if spec.isax is None or not spec.ops:
            continue  # negative controls / library-only specs
        mentions = (spec.name,) + spec.ops
        if not any(m in smoke_src for m in mentions):
            errors.append(f"{spec.name}: chip_smoke.py names none of "
                          f"{mentions}, so no card run holds it")
        if not any(m in src for src in test_srcs for m in mentions):
            errors.append(f"{spec.name}: no tests/test_torch_*.py names "
                          f"{mentions}")

    if errors:
        print("registry lint FAILED:", file=sys.stderr)
        for e in errors:
            print(f"  - {e}", file=sys.stderr)
        raise SystemExit(1)
    n = sum(1 for s in reg.specs() if s.isax is not None and s.ops)
    print(f"registry lint OK: {n} dispatchable ISAXes across "
          f"{len(reg.domains())} domains, all on the card and tested")


if __name__ == "__main__":
    main()

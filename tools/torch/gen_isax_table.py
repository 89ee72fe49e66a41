"""Generate the op → ISAX coverage table from the port's registry
(``repro_torch.targets``).

The table in README.md's port section is generated, not hand-written:
every dispatch op, its target ISAX, the bound kernel routes (baseline and
pipelined) and the bridging rewrites come from the registered
``IsaxSpec`` entries.  Entry points are printed without the
``repro_torch.`` prefix.  Its marker block is the port's own; the
reference's table (``tools/gen_isax_table.py``) lives in
``docs/ARCHITECTURE.md``.

Usage:
    PYTHONPATH=src python tools/torch/gen_isax_table.py                  # print the table
    PYTHONPATH=src python tools/torch/gen_isax_table.py --write PATH...  # update marker blocks
    PYTHONPATH=src python tools/torch/gen_isax_table.py --check PATH...  # fail on drift
"""

from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2] / "src"))

BEGIN = ("<!-- BEGIN GENERATED: op-isax-table-torch "
         "(tools/torch/gen_isax_table.py) -->")
END = "<!-- END GENERATED: op-isax-table-torch -->"


def _entry_point(fn) -> str:
    if fn is None:
        return "—"
    mod = fn.__module__.removeprefix("repro_torch.")
    return f"`{mod}.{fn.__qualname__}`"


def render_table() -> str:
    """The markdown table, one row per registered dispatch op."""
    from repro_torch.targets import default_registry
    reg = default_registry()
    rows = [
        "| op (dispatch key) | domain | ISAX matched | kernel entry point "
        "| burst-pipelined variant | bridging rewrites | notes |",
        "|---|---|---|---|---|---|---|",
    ]
    for op in reg.ops():
        spec = reg.op_spec(op)
        target = f"`{spec.target}`" if spec.target else "— (negative ctrl)"
        rewrites = ", ".join(f"`{r}`" for r in spec.rewrites) or "—"
        rows.append(
            f"| `{op}` | {spec.domain} | {target} "
            f"| {_entry_point(spec.kernel)} "
            f"| {_entry_point(spec.kernel_pipelined)} "
            f"| {rewrites} | {dict(spec.op_notes).get(op, '')} |")
    lib = ", ".join(f"`{s.name}`" for s in reg.specs()
                    if s.isax is not None and not s.ops)
    footer = (f"\nLibrary-only ISAXes (matchable, no dispatch key yet): "
              f"{lib or '—'}.\n")
    return "\n".join(rows) + "\n" + footer


def _splice(text: str, table: str, path: str) -> str:
    try:
        head, rest = text.split(BEGIN, 1)
        _, tail = rest.split(END, 1)
    except ValueError:
        raise SystemExit(f"{path}: marker block "
                         f"'{BEGIN}' … '{END}' not found") from None
    return f"{head}{BEGIN}\n{table}{END}{tail}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paths", nargs="*", help="markdown files with the "
                                             "generated-table marker block")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--write", action="store_true",
                      help="rewrite the marker blocks in place")
    mode.add_argument("--check", action="store_true",
                      help="exit 1 if any marker block is stale")
    args = ap.parse_args(argv)

    table = render_table()
    if not args.paths:
        print(table, end="")
        return
    stale = []
    for p in args.paths:
        text = pathlib.Path(p).read_text()
        new = _splice(text, table, p)
        if args.write:
            pathlib.Path(p).write_text(new)
            print(f"updated {p}")
        elif new != text:
            stale.append(p)
    if args.check and stale:
        raise SystemExit(
            f"generated op→ISAX table is stale in: {stale} — run "
            f"'PYTHONPATH=src python tools/torch/gen_isax_table.py --write "
            f"{' '.join(stale)}'")
    if args.check:
        print(f"op→ISAX table up to date in {args.paths}")


if __name__ == "__main__":
    main()

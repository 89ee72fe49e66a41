"""The port's registry tools (``tools/torch/{check_registry,
gen_isax_table}.py``) on this tree, held to the reference's.

The lint passes here and counts what the reference's registry counts; it
fails, naming the spec, when ``chip_smoke.py`` or the port's tests stop
naming one.  README's generated table is current, and each of its rows
is the reference's ``render_table()`` row with ``repro.`` read as
``repro_torch.``, except the point-cloud ops, whose records bind the
kernel routes (``pointcloud/ops.kernel_*``, where the reference binds its
fallback-aware entry points).
"""

import importlib.util
import pathlib
import shutil

import pytest

from repro.targets import default_registry as jregistry

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(path: pathlib.Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


lint = _load(ROOT / "tools" / "torch" / "check_registry.py",
             "torch_check_registry")
table = _load(ROOT / "tools" / "torch" / "gen_isax_table.py",
              "torch_gen_isax_table")
jtable = _load(ROOT / "tools" / "gen_isax_table.py", "gen_isax_table")

#: op → (the reference's kernel entry point, the port's): the deviations.
KERNEL_DEVIATIONS = {
    "fps": ("`pointcloud.ops.farthest_point_sample`",
            "`pointcloud.ops.kernel_fps`"),
    "ball_query": ("`pointcloud.ops.ball_query`",
                   "`pointcloud.ops.kernel_ball_query`"),
    "group_aggregate": ("`pointcloud.ops.group_aggregate`",
                        "`pointcloud.ops.kernel_group_aggregate`"),
}


def test_registry_lint_passes_and_counts_as_the_reference(capsys):
    lint.main()
    jreg = jregistry()
    n = sum(1 for s in jreg.specs() if s.isax is not None and s.ops)
    assert (f"registry lint OK: {n} dispatchable ISAXes across "
            f"{len(jreg.domains())} domains") in capsys.readouterr().out


@pytest.mark.parametrize("where,spec", [("chip_smoke.py", "rmsnorm"),
                                        ("tests", "ball_query")])
def test_registry_lint_names_a_spec_its_sources_drop(tmp_path, monkeypatch,
                                                     capsys, where, spec):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    (tmp_path / "tests").mkdir()
    for p in (ROOT / "tests").glob("test_torch_*.py"):
        shutil.copy(p, tmp_path / "tests" / p.name)
    for p in ([tmp_path / "chip_smoke.py"] if where == "chip_smoke.py"
              else (tmp_path / "tests").glob("*.py")):
        p.write_text(p.read_text().replace(spec, "x" * len(spec)))
    monkeypatch.setattr(lint, "ROOT", tmp_path)
    with pytest.raises(SystemExit) as exc:
        lint.main()
    assert exc.value.code == 1
    err = capsys.readouterr().err
    assert f"- {spec}: " in err
    assert err.count("\n  - ") == 1


def test_readme_table_is_current(capsys):
    table.main(["--check", str(ROOT / "README.md")])
    assert "up to date" in capsys.readouterr().out


def _rows(text: str) -> dict:
    rows = {}
    for line in text.splitlines():
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if line.startswith("| `"):
            rows[cells[0].strip("`")] = cells
    return rows


def test_table_rows_equal_the_reference():
    ours, theirs = _rows(table.render_table()), _rows(jtable.render_table())
    assert list(ours) == list(theirs)
    for op, want in theirs.items():
        got = list(ours[op])
        if op in KERNEL_DEVIATIONS:
            assert (want[3], got[3]) == KERNEL_DEVIATIONS[op]
            got[3] = want[3]
        assert got == want, op
    assert table.render_table().splitlines()[-1] == \
        jtable.render_table().splitlines()[-1]

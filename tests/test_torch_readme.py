"""README.md's port commands, run on the CPU.

The repo's docs job installs the package without its ``torch`` extra, so
every README command that needs torch carries ``# docs-ci: skip``
(``tools/run_doc_snippets.py`` would fail it with ``ModuleNotFoundError``).
This suite has torch, so it runs those of them that need no card — the
ones that name the port (``repro_torch``, ``examples/torch/``,
``tools/torch/``) and pass ``--device cpu``, the dry run's perf variant
and the registry tools — each with ``bash -c``, as the docs job does, and
checks that no command that needs torch lacks the skip mark.  The
commands run in README's order whatever order the cases are scheduled
in: a case first runs every earlier command not yet run (the serve
example reads the train example's checkpoint under ``runs/``), from a
root of this process's own that links every entry of the repo but
``runs/``, so no other process's run prunes or writes the checkpoints
it reads.
"""

import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
from run_doc_snippets import _SKIP, _SKIP_MARK, shell_blocks  # noqa: E402

PORT = re.compile(r"repro_torch|examples/torch/|tools/torch/")
NO_CARD = re.compile(r"--device cpu|repro_torch\.launch\.perf|tools/torch/")
SCRIPT = re.compile(r"(?:^|\s)((?:examples|tools)/[\w/]+\.py)")


def commands() -> list[str]:
    """README's bash command lines (no comments, no blank lines)."""
    lines = (ln.strip() for ln in shell_blocks((ROOT / "README.md")
                                               .read_text()))
    return [ln for ln in lines if ln and not ln.startswith("#")]


def needs_torch(cmd: str) -> bool:
    """The command runs the port, ``chip_smoke.py`` or a script that
    imports torch."""
    if PORT.search(cmd) or "chip_smoke.py" in cmd:
        return True
    return any(re.search(r"^\s*(import torch|from repro_torch)",
                         (ROOT / s).read_text(), re.M)
               for s in SCRIPT.findall(cmd) if (ROOT / s).exists())


CPU_COMMANDS = [c for c in commands() if PORT.search(c) and NO_CARD.search(c)
                and not any(p.search(c) for p in _SKIP)]


def test_readme_torch_commands_carry_the_skip_mark():
    """The docs job runs nothing that imports torch."""
    assert len(CPU_COMMANDS) >= 15
    unmarked = [c for c in commands() if needs_torch(c)
                and not c.endswith(_SKIP_MARK)
                and not any(p.search(c) for p in _SKIP)]
    assert unmarked == []


@pytest.fixture(scope="module")
def readme_run(tmp_path_factory):
    """Runs README's CPU commands in order, each once, up to the one
    asked for; returns (exit code, output tail) of that one."""
    root = tmp_path_factory.mktemp("readme_root")
    for entry in ROOT.iterdir():
        if entry.name not in ("runs", ".git"):
            (root / entry.name).symlink_to(entry)
    done: dict[str, tuple[int, str]] = {}

    def run(cmd: str) -> tuple[int, str]:
        for c in CPU_COMMANDS[:CPU_COMMANDS.index(cmd) + 1]:
            if c not in done:
                out = subprocess.run(["bash", "-c", c], cwd=root,
                                     capture_output=True, text=True,
                                     timeout=300)
                done[c] = (out.returncode,
                           out.stdout[-2000:] + out.stderr[-4000:])
        return done[cmd]
    return run


@pytest.mark.parametrize("cmd", CPU_COMMANDS)
def test_readme_cpu_command_runs(cmd, readme_run):
    rc, tail = readme_run(cmd)
    assert rc == 0, tail

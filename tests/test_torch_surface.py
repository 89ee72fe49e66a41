"""The port covers the reference: every module of ``src/repro`` has its
counterpart in ``src/repro_torch`` with each public top-level name (a
function, class or assigned name not starting with ``_``), and every
example and registry tool of the reference has its counterpart under
``examples/torch/`` or ``tools/torch/``, unless the name or file is on
an allowlist below with its reason.  Parsed with ``ast``: nothing is
imported.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

#: (module, name) of the reference with no counterpart, and why.
ALLOWED_NAMES = {
    ("core/offload.py", "isax_library"):
        "deprecation shim; targets.isax_library is the call",
    ("models/layers.py", "get_attention_impl"):
        "deprecation shim of the module-global backend; LoweringConfig "
        "replaces it",
    ("models/layers.py", "set_attention_impl"):
        "deprecation shim of the module-global backend; LoweringConfig "
        "replaces it",
    ("kernels/pipeline.py", "BurstPipeline"):
        "the TPU's VMEM ring of async copies; the port's routes take the "
        "cost model's pick and choose_depth",
    ("kernels/pipeline.py", "DEFAULT_DEPTH"):
        "the TPU ring's default depth; the port's routes take choose_depth",
    ("kernels/pipeline.py", "use_pipeline"):
        "the TPU ring's on/off rule; the port's routes take the cost "
        "model's pick",
    ("kernels/flash_attention.py", "NEG_INF"):
        "a constant of the Pallas kernel's masking",
    ("pointcloud/kernels.py", "NEG_INF"):
        "a constant of the Pallas kernels' masking",
    ("pointcloud/ops.py", "pc_tiles"):
        "the TPU's (8, 128) tiling; the port's counterpart is tileable",
    ("models/transformer.py", "init_block"):
        "jax.vmap initialisation of one block; the port draws the stacked "
        "weights directly",
    ("launch/dryrun.py", "build_lowered"):
        "XLA lowering; the port traces on a fake process group",
    ("roofline/analysis.py", "HBM_BW"):
        "the TPU's peak; the port has H100",
    ("roofline/analysis.py", "LINK_BW"):
        "the TPU's peak; the port has H100",
    ("roofline/analysis.py", "PEAK_FLOPS"):
        "the TPU's peak; the port has H100",
    ("roofline/analysis.py", "parse_collectives"):
        "parses XLA's HLO; the port records collectives with CostRecorder",
}

#: Reference files under examples/, tools/ and benchmarks/ with no port
#: counterpart.
ALLOWED_FILES = {
    "tools/run_doc_snippets.py":
        "the docs job's runner; it runs both packages' README commands",
    "benchmarks/":
        "a slice of the port adds no benchmark: the port's counterpart "
        "comes with the PR that gives it its first cell",
}


def public_names(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                elts = target.elts if isinstance(target, ast.Tuple) \
                    else [target]
                names.update(e.id for e in elts if isinstance(e, ast.Name))
        elif isinstance(node, ast.AnnAssign) and \
                isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


@pytest.mark.parametrize("module", MODULES)
def test_module_has_its_counterpart(module):
    port = PORT / module
    assert port.exists(), f"src/repro_torch/{module} is missing"
    missing = {n for n in public_names(REF / module) - public_names(port)
               if (module, n) not in ALLOWED_NAMES}
    assert not missing, f"{module}: no counterpart for {sorted(missing)}"


def test_allowlist_names_only_what_is_missing():
    """Each allowlisted name exists in the reference and not in the port,
    and has its reason."""
    for (module, name), reason in ALLOWED_NAMES.items():
        assert name in public_names(REF / module), (module, name)
        assert name not in public_names(PORT / module), (module, name)
        assert reason


def _is_port_tool(path: pathlib.Path) -> bool:
    """One of the port's own measuring tools, which live beside the
    reference's in tools/ and need no counterpart."""
    text = path.read_text()
    return "repro_torch" in text or "import torch" in text


def test_examples_and_tools_have_their_counterparts():
    missing = []
    for path in sorted((ROOT / "examples").glob("*.py")):
        if not (ROOT / "examples" / "torch" / path.name).exists():
            missing.append(f"examples/{path.name}")
    for path in sorted((ROOT / "tools").glob("*.py")):
        rel = f"tools/{path.name}"
        if rel in ALLOWED_FILES or _is_port_tool(path):
            continue
        if not (ROOT / "tools" / "torch" / path.name).exists():
            missing.append(rel)
    for path in sorted((ROOT / "benchmarks").glob("*.py")):
        if "benchmarks/" not in ALLOWED_FILES:
            missing.append(f"benchmarks/{path.name}")
    assert missing == []
    assert {"check_registry.py", "gen_isax_table.py"} <= {
        p.name for p in (ROOT / "tools" / "torch").glob("*.py")}
    for rel in ALLOWED_FILES:
        assert (ROOT / rel).exists(), rel

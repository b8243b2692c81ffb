"""The benchmark's files: nothing of JAX or the JAX package is imported
(judged by whole top-level names), the reference imports nothing of the
program, and every name in ``BENCHMARK.json`` finds its file."""
import ast
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = json.loads((HERE.parent / "BENCHMARK.json").read_text())
SOURCES = sorted(HERE.rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                names.add(arg.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "torch", "numpy", "math"}


def test_the_check_of_loaded_modules_compares_whole_names():
    from port_bench import run
    assert run.forbidden_modules(["repro_torch", "repro_torch.serving", "reproducible", "torch"]) == []
    assert run.forbidden_modules(["repro_torch", "repro.core.stack"]) == ["repro"]
    assert run.forbidden_modules(["jax.numpy", "flax", "jaxlib.xla_client"]) == ["flax", "jax", "jaxlib"]


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_finds_its_files():
    for c in BENCH["configs"]:
        conf = json.loads((HERE.parent / c["file"]).read_text())
        assert conf["source"] == c["source"] and conf["reduced"] == c["reduced"]
        assert (HERE / "families" / f"{conf['family']}.py").exists()
        assert (HERE / "reference" / f"{conf['family']}.py").exists()
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (HERE / "limits" / f"{w['name']}.json").exists()
    for m in BENCH["end_to_end"]:
        assert (HERE / "e2e" / f"{m['name']}.py").exists()
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    from port_bench.cell import load_cell
    for w in BENCH["workloads"]:
        c = load_cell(w["name"])
        assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2 and c.per_layer
        # each per-layer metric moves an end-to-end metric its cell reports
        moves = {m["name"]: m["moves"] for m in BENCH["per_layer"]}
        assert all(moves[m] in c.end_to_end for m in c.per_layer)

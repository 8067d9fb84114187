"""No module of the benchmark imports JAX or the JAX package, and the plain
references import nothing of the program.  Names are compared by their whole
top-level part: ``repro_torch`` begins with ``repro`` and is another package."""
import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "repro"}


def _imported(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f.relative_to(BENCH)): sorted(set(_imported(f)) & NEVER) for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_the_references_import_nothing_of_the_program():
    for f in sorted((BENCH / "reference").glob("*.py")):
        assert "repro_torch" not in set(_imported(f)), f


def test_the_names_are_compared_whole():
    assert "repro_torch" not in NEVER and "repro_torch".split(".")[0] != "repro"

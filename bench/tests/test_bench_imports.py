"""What a run imports: never JAX, jaxlib, flax or the JAX package (top-level
names compared whole), and the reference imports nothing of the port."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((ROOT / "bench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_bench_file_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "bench/reference")
                                        .glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in _imports(path)


def test_a_run_loads_no_forbidden_module():
    # every module a run imports, the port's entry points included
    code = (
        "import sys, json; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src']\n"
        "import bench.run, bench.entries.serve, bench.entries.train\n"
        "from bench import harness\n"
        "for m in harness.benchmark()['per_layer']:\n"
        "    harness.metric_reader(m['name'])\n"
        "import repro_torch.serve, repro_torch.models, repro_torch.train\n"
        "import repro_torch.exec.plan, repro_torch.models.moe\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, check=True)
    assert not set(json.loads(out.stdout)) & FORBIDDEN

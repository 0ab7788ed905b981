"""Nothing under benchmark/ imports JAX or the JAX package, comparing
top-level module names whole (``gslidar_tpu_torch`` begins with
``gslidar_tpu``); the reference imports nothing of the port."""

import ast
import glob
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "gslidar_tpu"}


def imported(path):
    """Top-level names of every module a file imports."""
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def sources(sub=""):
    return sorted(glob.glob(os.path.join(BENCH, sub, "**", "*.py"),
                            recursive=True))


def test_nothing_imports_jax_or_the_jax_package():
    bad = {p: imported(p) & FORBIDDEN for p in sources()}
    assert not {p: b for p, b in bad.items() if b}


def test_the_span_table_names_no_jax_module():
    import json
    for p in glob.glob(os.path.join(BENCH, "spans", "*.json")):
        mod = json.load(open(p))["module"].split(".")[0]
        assert mod not in FORBIDDEN


def test_the_reference_imports_nothing_of_the_port():
    for p in sources("reference"):
        names = imported(p)
        assert "gslidar_tpu_torch" not in names, p
        assert not names & FORBIDDEN, p
        assert names <= {"__future__", "benchmark", "dataclasses", "math",
                         "typing", "torch", "numpy"}, (p, names)


def test_the_reference_loads_with_the_port_and_jax_blocked():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
        "                'gslidar_tpu', 'gslidar_tpu_torch'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import benchmark.reference.step, benchmark.counts, benchmark.checks\n"
        "print('ok')\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "ok"

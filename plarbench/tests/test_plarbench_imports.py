"""Nothing the benchmark runs loads JAX or the JAX package (``repro``),
compared by whole top-level module names; the reference loads nothing of the
program; the command refuses to run without a CUDA card."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

_PROBE = """
import importlib.util, json, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path[:0] = [str(root / "src"), str(root)]
for name in sys.argv[2].split(","):
    if name:
        __import__(name)
for f in sorted((root / "plarbench" / "traffic").glob("*.py")) + sorted(
        (root / "plarbench" / "metrics").glob("*.py")):
    if sys.argv[3] == "all":
        spec = importlib.util.spec_from_file_location("m_" + f.stem.replace(".", "_"), f)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _loaded(modules, files="all"):
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}
    out = subprocess.run([sys.executable, "-c", _PROBE, str(REPO), ",".join(modules), files],
                         capture_output=True, text=True, env=env, timeout=120, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_run_loads_no_jax():
    names = _loaded(["plarbench.run", "plarbench.harness", "plarbench.tools.control",
                     "plarbench.tools.check_spans", "repro_torch.core.reduction",
                     "repro_torch.service", "repro_torch.kernels.contingency.ops"])
    assert "repro_torch" in names and "plarbench" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    names = _loaded(["plarbench.reference.plar", "plarbench.reference.compare",
                     "plarbench.tables", "plarbench.counts"], files="none")
    assert not names & (FORBIDDEN | {"repro_torch"})
    for f in (REPO / "plarbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = [a.name for a in node.names] if isinstance(node, ast.Import) else [
                    node.module or ""]
                assert not {m.split(".")[0] for m in mods} & (FORBIDDEN | {"repro_torch"}), f


def test_no_card_no_result(tmp_path):
    if __import__("torch").cuda.is_available():
        return
    for root in (REPO, tmp_path):
        if root is tmp_path:        # a directory with only BENCHMARK.json and the paths
            import shutil
            shutil.copy(REPO / "BENCHMARK.json", tmp_path)
            for p in json.loads((REPO / "BENCHMARK.json").read_text())["paths"]:
                shutil.copytree(REPO / p, tmp_path / p,
                                ignore=shutil.ignore_patterns("__pycache__"))
        out = subprocess.run([sys.executable, "plarbench/run.py", "--workload", "kdd99.batch",
                              "--seed", "1", "--seconds", "1", "--trace", "0"],
                             cwd=root, capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and out.stdout.strip() == ""

"""The port stands alone: ntcard_tpu_torch, chip_smoke.py and
tools/kernel_ab.py import nothing of the JAX package (ntcard_tpu), not even
its jax-free modules, and nothing of jax. An AST scan of every file, and a
run of every module and all three CLIs in a process where neither can be
imported."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
DATA = REPO / "tests" / "data"
GOLD = REPO / "tests" / "golden"
FILES = sorted((REPO / "ntcard_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tools" / "kernel_ab.py"]
FORBIDDEN = ("ntcard_tpu", "jax")


def _imported(path: Path):
    """Every absolute module name an import statement of ``path`` names."""
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_the_jax_package(path):
    bad = [m for m in _imported(path) if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


RUN = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax or of the JAX package now raises
sys.modules["ntcard_tpu"] = None
import ntcard_tpu_torch
for m in pkgutil.walk_packages(ntcard_tpu_torch.__path__, "ntcard_tpu_torch."):
    importlib.import_module(m.name)
from ntcard_tpu_torch import cli, cli_hll
from ntcard_tpu_torch.tools import merge_sketches
out, data = sys.argv[1], sys.argv[2]
assert cli.main(["-k12", "-c1000", "-r16", "-p", out + "/a", data + "/reads.fq"], device="cpu") == 0
assert cli.main(["-k12", "-c1000", "-r16", "-g2", "-p", out + "/g", data + "/reads.fq"],
                device="cpu") == 0
for name, src in (("s1", "reads.fq"), ("s2", "contig.fa")):
    assert cli.main(["-k12", "-c1000", "-r16", "--save-sketch", f"{out}/{name}.npz",
                     "-p", f"{out}/{name}", f"{data}/{src}"], device="cpu") == 0
assert merge_sketches.main(["-p", out + "/m", out + "/s1.npz", out + "/s2.npz"], device="cpu") == 0
assert cli_hll.main(["-k25", data + "/reads.fq"], device="cpu") == 0
loaded = [m for m, mod in sys.modules.items() if mod is not None
          and any(m == f or m.startswith(f + ".") for f in ("ntcard_tpu", "jax"))]
assert not loaded, loaded
print("MODULES", sum(1 for m in sys.modules if m.startswith("ntcard_tpu_torch")), file=sys.stderr)
"""


def test_port_runs_with_the_jax_package_unimportable(tmp_path):
    """Every module imports and the CLIs byte-match the goldens (reads k12
    r16, -g2, nthll k25, and the merge of two port sketches) with jax and
    ntcard_tpu made unimportable; nothing of either is loaded."""
    r = subprocess.run(
        [sys.executable, "-c", RUN, str(tmp_path), str(DATA)],
        capture_output=True, text=True, cwd=str(REPO), timeout=600,
        env=dict(os.environ, PYTHONPATH="", OMP_NUM_THREADS="2"),
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "MODULES" in r.stderr
    for out, good in (("a_k12.hist", "reads_k12.hist.good"), ("g_k12.hist", "reads-gap_k12.hist.good"),
                      ("m_k12.hist", "both_k12.hist.good")):
        assert (tmp_path / out).read_bytes() == (GOLD / good).read_bytes(), out
    assert r.stdout == (GOLD / "nthll_k25.out.good").read_text()

"""Nothing the benchmark runs imports JAX, flax, the JAX package
``repro`` or the JAX package's suites under ``benchmarks/``; names are
compared whole, so ``repro_torch`` passes."""
from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from perfbench import lib

BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
SOURCES = sorted(p for p in lib.ROOT.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(lib.ROOT)))
def test_no_banned_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops = [node.module.split(".")[0]]
        else:
            continue
        assert not BANNED & set(tops), (path, tops)


def test_references_import_nothing_of_the_port():
    for path in (lib.ROOT / "reference").glob("*.py"):
        text = path.read_text()
        assert "repro_torch" not in text.replace("port's", ""), path


def test_forbidden_modules_compares_whole_names():
    sys.path.insert(0, str(lib.REPO))
    run = lib.load_module("run.py")
    saved = {k: sys.modules[k] for k in list(sys.modules)
             if k.split(".")[0] in run.FORBIDDEN}
    try:
        for k in saved:
            del sys.modules[k]
        sys.modules["repro_torch_fake_probe"] = object()
        assert run.forbidden_modules() == []
        sys.modules["repro.core"] = object()
        assert run.forbidden_modules() == ["repro"]
    finally:
        sys.modules.pop("repro.core", None)
        sys.modules.pop("repro_torch_fake_probe", None)
        sys.modules.update(saved)


def test_a_run_loads_no_jax():
    """Import everything a run imports, in a fresh interpreter, and look at
    sys.modules as the run does after its window."""
    code = (
        "import sys; sys.path[:0] = ['src', '.'];"
        "from perfbench import lib, arith;"
        "[lib.load_module('runners', k + '.py') for k in ('train', 'serve')];"
        "[lib.load_module('traffic', k + '.py') for k in ('train', 'serve')];"
        "[lib.load_module('reference', c['name'] + '.py') "
        "for c in lib.manifest()['configs']];"
        "import repro_torch.sim.engine, repro_torch.serve.continuous;"
        "import repro_torch.models.model, repro_torch.optim.decentralized;"
        "run = lib.load_module('run.py');"
        "print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=lib.REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result(tmp_path):
    """Without CUDA the command exits non-zero and prints no result."""
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "grok-chat",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        cwd=lib.REPO, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path),
             "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_without_the_port_prints_no_result(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's own
    files, the command exits non-zero and prints no result."""
    import shutil
    shutil.copy(lib.REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(lib.ROOT, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "encdec-dsgd",
         "--seed", "7", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""

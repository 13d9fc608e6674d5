"""The port stands without JAX: no module of peregrine_tpu_torch (nor
chip_smoke.py, nor the kernel cases it loads, nor the multi-process
tests' worker) imports jax or the JAX package or names a path into it,
the native library builds from the port's own sources, every module
imports with both made unimportable, and chip_smoke.py refuses to run
without a card or outside a checkout."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "peregrine_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "peregrine_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "torch_kernel_cases.py",
        ROOT / "tests" / "torch_multihost_worker.py"]


def _imported(path: pathlib.Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


# chip_smoke.py's citations of the TPU kernels each kernel replaces: file
# and line names, never read
CITATIONS = ("REPLACES", "ALIGN_REPLACES")


def _jax_package_paths(path: pathlib.Path):
    """The string constants of a file (docstrings and the citations aside)
    that name the JAX package's directory or a path inside it."""
    tree = ast.parse(path.read_text(), str(path))
    skip = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)):
            skip.add(id(body[0].value))
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id in CITATIONS
                for t in node.targets):
            skip.update(id(n) for n in ast.walk(node.value))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in skip
                and (node.value.strip("/\\") == "peregrine_tpu"
                     or "peregrine_tpu/" in node.value
                     or "peregrine_tpu\\" in node.value)):
            yield node.lineno, node.value


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_paths_into_the_jax_package(path):
    """Nothing of the port reads a file of the JAX package: no string
    that could become a path into peregrine_tpu/ (its C++ sources once
    were compiled from there)."""
    bad = list(_jax_package_paths(path))
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


def test_path_scan_finds_a_path_into_the_jax_package(tmp_path):
    f = tmp_path / "m.py"
    f.write_text('"""peregrine_tpu/ops/x.py in a docstring."""\n'
                 'REPLACES = {"a": "peregrine_tpu/ops/x.py:1"}\n'
                 'D = os.path.join(ROOT, "peregrine_tpu", "native")\n')
    assert [ln for ln, _ in _jax_package_paths(f)] == [3]


def test_native_sources_lie_in_the_port():
    from peregrine_tpu_torch import native

    assert native._SRC
    for src in native._SRC:
        p = pathlib.Path(src).resolve()
        assert p.is_relative_to(PORT) and p.exists(), src


_BLOCKED = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["peregrine_tpu"] = None
import peregrine_tpu_torch
for m in pkgutil.walk_packages(peregrine_tpu_torch.__path__,
                               "peregrine_tpu_torch."):
    importlib.import_module(m.name)
from peregrine_tpu_torch import cli
cli.main(["asm", "--help"])
"""


def test_imports_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _BLOCKED], cwd=str(ROOT),
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "--device" in r.stdout


def _run_smoke(script: pathlib.Path, cwd: pathlib.Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, str(script)], cwd=str(cwd),
                          env=env, capture_output=True, text=True,
                          timeout=600)


def test_chip_smoke_fails_without_a_card():
    r = _run_smoke(ROOT / "chip_smoke.py", ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _run_smoke(tmp_path / "chip_smoke.py", tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout

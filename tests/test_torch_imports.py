"""The port stands without JAX: no module of peregrine_tpu_torch (nor
chip_smoke.py) imports jax or the JAX package, every module imports with
both made unimportable, and chip_smoke.py refuses to run without a card
or outside a checkout."""

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
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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

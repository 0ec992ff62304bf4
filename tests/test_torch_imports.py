"""Import hygiene of the port: every ``repro_torch`` module, and the chip
scripts, import with jax blocked and ``repro``/``repro.*`` refused
(``repro_torch`` itself stays allowed).  And ``chip_smoke.py`` fails,
printing no result, without a CUDA card or without the package."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the parity suites import both frameworks)
import torch  # noqa: F401

REPO = Path(__file__).resolve().parents[1]

_HYGIENE = r"""
import importlib, importlib.abc, importlib.util, pkgutil, sys
sys.modules["jax"] = None                       # any jax import now fails


class RefuseRepro(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "repro" or name.startswith("repro."):
            raise ImportError(f"the port imported {name}")
        return None


sys.meta_path.insert(0, RefuseRepro())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
for i, script in enumerate(sys.argv[1:]):      # the chip scripts
    spec = importlib.util.spec_from_file_location(f"script{i}", script)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [m for m in sys.modules if m == "jax" and sys.modules[m] is not None
       or m == "repro" or m.startswith("repro.") or m.startswith("jax.")]
assert not bad, bad
print(len(names))
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    env.update(extra)
    return env


def test_port_imports_neither_jax_nor_repro():
    res = subprocess.run(
        [sys.executable, "-c", _HYGIENE, str(REPO / "chip_smoke.py"),
         str(REPO / "chip_profile.py"), str(REPO / "chip_kernel_steps.py")],
        env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    # every module was walked: 63 since the hybrid and MoE configs
    assert int(res.stdout.split()[-1]) >= 63


def test_chip_scripts_import_neither_jax_nor_repro_anywhere():
    """Their package imports sit inside ``main``: check every import
    statement, not only the module-level ones."""
    for script in ("chip_smoke.py", "chip_profile.py",
                   "chip_kernel_steps.py"):
        tree = ast.parse((REPO / script).read_text())
        for node in ast.walk(tree):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) else []
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "repro"), (script, name)


def _ok_line(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok") is True:
                return True
        except (ValueError, AttributeError):
            continue
    return False


def test_chip_smoke_fails_without_a_card():
    res = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO,
        env=_env(CUDA_VISIBLE_DEVICES=""), capture_output=True, text=True,
        timeout=300)
    assert res.returncode != 0
    assert not _ok_line(res.stdout)


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = _env(CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH")
    res = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert not _ok_line(res.stdout)

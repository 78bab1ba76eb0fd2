"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports ``jax`` or anything of the reference package
``repro``, and the chip smoke refuses to run without a card."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k in ("jax", "jaxlib", "repro") or k.startswith(
                 ("jax.", "jaxlib.", "repro.")))
print(" ".join(names))
print(bad)
"""

# The training slice's modules, which must be among those imported.
TRAINING_MODULES = {"repro_torch.tree", "repro_torch.optim.adamw",
                    "repro_torch.data.pipeline",
                    "repro_torch.checkpoint.store",
                    "repro_torch.checkpoint.fault",
                    "repro_torch.launch.train"}
# The engine slice's modules.
ENGINE_MODULES = {"repro_torch.launch.engine",
                  "repro_torch.kernels.paged_gather"}
# The Mamba serving slice's modules.
MAMBA_MODULES = {"repro_torch.models.mamba",
                 "repro_torch.kernels.selective_scan",
                 "repro_torch.configs.falcon_mamba_7b"}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    return env


def test_every_port_module_imports_without_jax_or_repro():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=_env(),
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    names, bad = out.stdout.strip().splitlines()
    names = set(names.split())
    assert len(names) >= 31 and (TRAINING_MODULES | ENGINE_MODULES
                                 | MAMBA_MODULES) <= names, names
    assert bad == "[]", f"the port imported {bad}"


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_names_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 28
    for path in files:
        roots = _imported_roots(path)
        assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA it exits non-zero before printing a result; alone in
    a directory it has nothing to import either."""
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env={k: v for k, v in os.environ.items()
                                  if k != "PYTHONPATH"})
        assert out.returncode != 0
        assert '"ok"' not in out.stdout

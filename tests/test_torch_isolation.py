"""The port stands alone: importing ``filodb_tpu_torch`` and every one of
its modules loads neither JAX nor anything of ``filodb_tpu``, and no port
source file (nor ``chip_smoke.py`` or ``tile_sweep.py``) imports either. The import check runs
in a subprocess because tests/conftest.py imports JAX into this one."""

import ast
import json
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "filodb_tpu_torch"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "filodb_tpu")


def test_forbidden_matches_only_the_jax_package():
    assert _forbidden("filodb_tpu") and _forbidden("filodb_tpu.ops.staging")
    assert _forbidden("jax.numpy") and _forbidden("jaxlib")
    assert not _forbidden("filodb_tpu_torch") and not _forbidden("filodb_tpu_torch.ops")


def port_modules() -> list[str]:
    names = ["filodb_tpu_torch"]
    for info in pkgutil.walk_packages([str(PORT)], prefix="filodb_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def test_importing_the_port_loads_no_jax():
    mods = port_modules()
    assert {"filodb_tpu_torch.ops.window_stats", "filodb_tpu_torch.singleflight",
            "filodb_tpu_torch.metrics"} <= set(mods)
    script = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(sys.modules)))\n"
    )
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "filodb_tpu_torch.coordinator.planner" in loaded
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, f"port import pulled in {bad[:10]}"


def source_files() -> list[Path]:
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "tile_sweep.py"]


@pytest.mark.parametrize("path", source_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative: stays inside the port
                continue
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert not _forbidden(name), f"{path.name}:{node.lineno} imports {name}"

"""Import hygiene of the PyTorch port: ``repro_torch``, ``benchmarks_torch``
and ``chip_smoke.py`` import neither JAX nor anything of the JAX package
``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
SOURCES = (sorted(PORT.rglob("*.py")) + sorted((REPO / "benchmarks_torch").glob("*.py"))
           + [REPO / "chip_smoke.py"])


def _imported(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax_or_repro(path):
    for name in _imported(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), f"{path} imports {name}"


def test_every_module_imports_with_jax_blocked():
    modules = sorted(
        ".".join(p.relative_to(PORT.parent).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in PORT.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        f"for mod in {modules!r}:\n"
        "    importlib.import_module(mod)\n"
        "assert not any(k == 'repro' or k.startswith(('repro.', 'jax'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


FACADE = ["repro_torch.api", "repro_torch.api.session", "repro_torch.api.specs",
          "repro_torch.core.scenarios", "repro_torch.checkpoint",
          "repro_torch.checkpoint.checkpoint", "repro_torch.serve",
          "repro_torch.serve.client", "repro_torch.serve.health",
          "repro_torch.serve.metrics", "repro_torch.serve.ring",
          "repro_torch.serve.server", "repro_torch.serve.smoke"]


@pytest.mark.parametrize("module", FACADE)
def test_facade_module_is_checked(module):
    """The facade's modules are among the sources checked above."""
    path = PORT.parent.joinpath(*module.split("."))
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    assert path in SOURCES


def test_facade_names_are_the_jax_packages():
    """``repro_torch.api`` and ``repro_torch`` export every name of
    ``repro.api.__all__`` and of ``repro.checkpoint``, and
    ``repro_torch.serve`` and ``repro_torch`` every name of
    ``repro.serve.__all__``."""
    import repro.api
    import repro.checkpoint
    import repro.serve
    import repro_torch
    import repro_torch.api
    import repro_torch.checkpoint
    import repro_torch.serve
    assert set(repro.serve.__all__) == set(repro_torch.serve.__all__)
    assert set(repro.serve.__all__) <= set(repro_torch.__all__)
    assert set(repro.api.__all__) <= set(repro_torch.api.__all__)
    assert set(repro.api.__all__) <= set(repro_torch.__all__)
    assert set(repro.checkpoint.__all__) == set(repro_torch.checkpoint.__all__)
    assert set(repro.checkpoint.__all__) <= set(repro_torch.__all__)
    for name in repro_torch.__all__:
        assert hasattr(repro_torch, name), name
    # the meshes of one process: one device, the GSPMD mesh (1, 1)
    assert repro_torch.api.make_worker_mesh().shape == {"workers": 1}
    assert repro_torch.api.make_lane_mesh().shape == {"lanes": 1,
                                                      "workers": 1}
    assert repro_torch.api.make_worker_mesh(model=1).shape == {"workers": 1,
                                                               "model": 1}

"""The port imports PyTorch, never JAX (nor ``ml_dtypes``, which the
card's machine does not have), and nothing of the reference package:
every .py under tpu_inference_torch/ (and chip_smoke.py and scripts/,
which drive the port on the card) is scanned with ``ast``."""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tpu_inference_torch")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    scripts = os.path.join(ROOT, "scripts")
    if os.path.isdir(scripts):
        out += [os.path.join(scripts, f) for f in os.listdir(scripts)
                if f.endswith(".py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "ml_dtypes", "tpu_inference")


def _imports(path: str):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.lineno, node.module


def test_port_has_sources():
    files = _port_files()
    assert len(files) > 15
    assert os.path.isfile(os.path.join(PKG, "csrc", "paged_attention.cu"))
    assert os.path.isfile(os.path.join(PKG, "csrc", "prefill_attention.cu"))
    for mod in ("integrity.py", "server/transport.py", "server/worker.py",
                "server/fleet.py", "parallel/__init__.py", "parallel/mesh.py",
                "parallel/shardings.py", "parallel/tp.py"):
        assert os.path.join(PKG, mod) in files, mod


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    bad = [(line, mod) for line, mod in _imports(path) if _forbidden(mod)]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_scanner_catches_forbidden_forms(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import jax.numpy as jnp\n"
                 "from tpu_inference.engine import kv_cache\n"
                 "import tpu_inference\n"
                 "import ml_dtypes\n"
                 "import tpu_inference_torch\n"
                 "from tpu_inference_torch.config import PRESETS\n")
    bad = [mod for _, mod in _imports(str(p)) if _forbidden(mod)]
    assert bad == ["jax.numpy", "tpu_inference.engine", "tpu_inference",
                   "ml_dtypes"]

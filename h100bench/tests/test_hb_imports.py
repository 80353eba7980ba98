"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference and the model families import nothing of the port. Names are
compared by their top-level part whole: ``tpu_inference_torch`` is the
port, allowed outside the reference and the families;
``tpu_inference`` is the JAX package."""

import ast
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "h100bench")
FORBIDDEN = {"jax", "jaxlib", "flax", "tpu_inference"}
PORT = "tpu_inference_torch"


def _modules():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported_tops(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    bad = {p: sorted(set(_imported_tops(p)) & FORBIDDEN)
           for p in _modules()}
    assert not {p: b for p, b in bad.items() if b}


def test_the_reference_imports_nothing_of_the_port():
    dirs = [os.path.join(BENCH, d) for d in
            ("reference", "families", os.path.join("tests", "families"))]
    seen = 0
    for path in _modules():
        if any(path.startswith(d + os.sep) for d in dirs):
            assert PORT not in set(_imported_tops(path)), path
            seen += 1
    assert seen >= 6


def _dry_import(names):
    code = ("import importlib, json, sys\n"
            f"for n in {names!r}: importlib.import_module(n)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    return {m.split(".")[0] for m in json.loads(out.stdout.splitlines()[-1])}


def test_a_dry_import_of_every_module_loads_no_jax():
    names = []
    for path in _modules():
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        if ".metrics." in rel or ".tests." in rel:
            continue
        names.append(rel.removesuffix(".__init__"))
    loaded = _dry_import(names)
    assert not loaded & FORBIDDEN, loaded & FORBIDDEN


def test_a_dry_import_of_the_reference_loads_nothing_of_the_port():
    loaded = _dry_import(["h100bench.reference.model",
                          "h100bench.reference.check",
                          "h100bench.families.mistral",
                          "h100bench.families.mixtral"])
    assert PORT not in loaded and not loaded & FORBIDDEN

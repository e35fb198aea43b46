"""Static import guard of the port: no file of cometbft_tpu_torch/, not
chip_smoke.py and not compare_kernels.py imports JAX or anything of the
JAX package cometbft_tpu — at module level or inside a function, by an
import statement or by importlib/__import__ with a literal name. The
subprocess check in tests/test_torch_verify.py sees only what importing
the modules imports; this one reads every import in the source.
"""

from __future__ import annotations

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "cometbft_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "compare_kernels.py"]
FORBIDDEN_ROOTS = ("jax", "jaxlib", "cometbft_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN_ROOTS


def forbidden_imports(source: str) -> list[tuple[int, str]]:
    """(line, module) of every import of JAX or the JAX package in
    `source`, wherever it stands."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            names = [node.args[0].value] if name in ("import_module", "__import__") else []
        else:
            continue
        found += [(node.lineno, n) for n in names if _forbidden(n)]
    return sorted(found)


def test_guard_sees_every_form_of_import():
    src = (
        "import numpy\n"
        "import cometbft_tpu_torch.ops\n"
        "def f():\n"
        "    import jax.numpy as jnp\n"
        "    from cometbft_tpu.crypto import sr25519_math\n"
        "    return importlib.import_module('cometbft_tpu.ops.hashvec')\n"
        "class C:\n"
        "    def g(self):\n"
        "        __import__('jaxlib')\n"
        "from . import limbs\n"
    )
    assert forbidden_imports(src) == [
        (4, "jax.numpy"), (5, "cometbft_tpu.crypto"), (6, "cometbft_tpu.ops.hashvec"),
        (9, "jaxlib")]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_no_jax(path):
    assert forbidden_imports(path.read_text()) == []

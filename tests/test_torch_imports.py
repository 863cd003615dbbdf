"""The port stands alone: no file of promptir_tpu_torch/ nor chip_smoke.py
imports JAX, flax, optax, orbax, PIL or anything of the JAX package."""

import ast
import pathlib

import jax  # noqa: F401  (both frameworks share the test process)
import pytest
import torch  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
BANNED = {"jax", "jaxlib", "flax", "optax", "orbax", "PIL", "promptir_tpu"}
FILES = sorted((ROOT / "promptir_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]


def imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_has_files():
    assert len(FILES) > 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(imported_roots(path)) & BANNED)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"

"""Nothing under port_bench/ imports JAX or the JAX package, the reference
imports nothing of the port, and the run's own check compares top-level
module names whole (promptir_tpu_torch begins with promptir_tpu)."""

import ast
import sys

import pytest

from port_bench import manifest, run

SOURCES = sorted(manifest.HERE.rglob("*.py"))


def top_level_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(manifest.ROOT)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & set(run.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((manifest.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "promptir_tpu_torch" not in top_level_imports(path)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "promptir_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    for name in run.FORBIDDEN:
        monkeypatch.delitem(sys.modules, name, raising=False)
    assert run.forbidden_modules() == [] or all(
        n.split(".")[0] in run.FORBIDDEN for n in run.forbidden_modules())
    assert "promptir_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "promptir_tpu.models", object())
    assert "promptir_tpu.models" in run.forbidden_modules()


def test_a_run_in_a_process_loads_no_jax(tmp_path):
    """A rehearsal in a fresh process, where JAX is installed, runs to
    its result line and leaves neither JAX nor the JAX package loaded."""
    import subprocess

    code = ("from port_bench import rehearse, run\n"
            "out = rehearse.rehearse('promptir-serve-photo', 5, 1.0)\n"
            "assert not run.forbidden_modules(), run.forbidden_modules()\n"
            "print(out['line']['correct'])\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={**__import__("os").environ, "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "True"

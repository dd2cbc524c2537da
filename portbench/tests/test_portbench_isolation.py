"""No file of the benchmark imports JAX, its libraries or the JAX package
(top-level names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

import ast
import os

import pytest

from portbench import run

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "fourk_nerf_tpu"}


def imported_tops(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def sources(sub: str = ""):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_anywhere(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_imports_nothing_of_the_program(path):
    assert "fourk_nerf_torch" not in imported_tops(path)


def test_the_top_level_name_is_compared_whole(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "fourk_nerf_torch_like",
                        types.ModuleType("fourk_nerf_torch_like"))
    assert "fourk_nerf_torch_like" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla",
                        types.ModuleType("jaxlib.xla"))
    assert "jaxlib.xla" in run.forbidden_modules()

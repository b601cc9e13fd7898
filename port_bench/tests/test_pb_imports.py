"""No file of the benchmark imports JAX, its libraries or the JAX package,
by whole top-level module name (the port's name begins with the JAX
package's), and none under reference/ imports the program under test;
a run refuses to print its result with such a module loaded."""

from __future__ import annotations

import ast
import glob
import json
import os
import sys

import pytest

from port_bench import harness, hooks

FILES = sorted(glob.glob(os.path.join(harness.BENCH, "**", "*.py"),
                         recursive=True))
PROGRAM = "cartpoleplusplus_tpu_torch"


def _top_level_imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.add(node.args[0].value.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(p, harness.BENCH)
                              for p in FILES])
def test_no_file_imports_jax_or_the_jax_package(path):
    found = _top_level_imports(path) & set(harness.FORBIDDEN)
    assert not found, f"{path} imports {found}"
    if os.sep + "reference" + os.sep in path:
        assert PROGRAM not in _top_level_imports(path)


def test_the_check_reads_whole_top_level_names(monkeypatch):
    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, PROGRAM + ".probe", object())
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "cartpoleplusplus_tpu.env", object())
    assert "cartpoleplusplus_tpu" in harness.forbidden_modules()


def test_the_spans_wrap_only_the_program():
    for name in os.listdir(os.path.join(harness.BENCH, "configs")):
        with open(os.path.join(harness.BENCH, "configs", name)) as f:
            config = json.load(f)
        for target, _ in (list(config.get("spans", {}).values())
                          + list(config.get("faults", {}).values())):
            assert target.split(".")[0] in (hooks.ROOT, PROGRAM), target

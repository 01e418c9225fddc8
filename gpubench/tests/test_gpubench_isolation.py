"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference imports nothing of the program."""

import ast
import os
import sys
import types

from gbench import window
from gbench.registry import HERE


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("fqzcomp5_tpu_torch", "fqzcomp5_tpu_torch.ops",
                 "jaxtyping", "flaxen.x"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert window.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "fqzcomp5_tpu.ops",
                        types.ModuleType("fqzcomp5_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert window.forbidden_modules() == ["fqzcomp5_tpu", "jax"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module.split(".")[0]


def _sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = set(_imports(path)) & {"jax", "jaxlib", "flax",
                                     "fqzcomp5_tpu"}
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    ref = [p for p in _sources()
           if os.path.basename(p).startswith("ref_")]
    assert len(ref) >= 6
    for path in ref:
        mods = set(_imports(path))
        assert "fqzcomp5_tpu_torch" not in mods, path
        assert mods <= {"__future__", "struct", "zlib", "numpy", "gbench",
                        "bisect", "itertools"}, (path, mods)

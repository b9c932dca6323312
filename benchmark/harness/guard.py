"""The import guard: the process that prints a result may hold no module of
JAX or of the JAX package.  Names are compared whole, component by
component: `bifurcationkit.jl_tpu_torch` (the port) begins with the
letters of `bifurcationkit.jl_tpu` (the JAX package) and is not it."""
from __future__ import annotations

import ast
from pathlib import Path

FORBIDDEN_TOP = ("jax", "jaxlib", "flax")
JAX_PACKAGE = ("bifurcationkit", "jl_tpu")


def forbidden(name: str) -> bool:
    parts = name.split(".")
    if parts[0] in FORBIDDEN_TOP:
        return True
    return tuple(parts[:len(JAX_PACKAGE)]) == JAX_PACKAGE


def forbidden_loaded(modules) -> list:
    """The names in `modules` (such as `sys.modules`) that are JAX's, or
    the JAX package's."""
    return sorted(n for n in modules if forbidden(n))


def imports_of(path: Path) -> set:
    """The modules a Python file imports, by its syntax tree."""
    tree = ast.parse(Path(path).read_text(), filename=str(path))
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            out.add(node.module)
    return out


def reference_imports_program(ref_dir: Path) -> list:
    """Files of the reference folder that import `bifurcationkit` (the
    port or the JAX package) or JAX: the reference is plain PyTorch and
    NumPy."""
    bad = []
    for p in sorted(Path(ref_dir).glob("*.py")):
        for name in imports_of(p):
            top = name.split(".")[0]
            if top == "bifurcationkit" or top in FORBIDDEN_TOP:
                bad.append(f"{p.name}: {name}")
    return bad

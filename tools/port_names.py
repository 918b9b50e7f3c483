#!/usr/bin/env python3
"""List, module by module, the public names of the JAX package that its
PyTorch port lacks.

    python tools/port_names.py [module ...]

For each ``jafpro_tpu/<module>.py`` (all of them, or the ones named, as
``models/ablations``), the top-level ``def`` and ``class`` names that do
not start with ``_``, minus those of ``jafpro_tpu_torch/<module>.py``
(names an ``__init__.py`` imports count as its own). Reads the sources
with ``ast``: imports neither package."""

from __future__ import annotations

import ast
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def public_names(path: str) -> set:
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif (isinstance(node, ast.ImportFrom)
              and os.path.basename(path) == "__init__.py"):
            names.update(a.asname or a.name for a in node.names)
    return {n for n in names if not n.startswith("_")}


def modules() -> list:
    base = os.path.join(ROOT, "jafpro_tpu")
    out = []
    for dirpath, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), base)
                out.append(rel[:-3])
    return sorted(out)


def missing(module: str) -> tuple:
    """(public names of the JAX module, those the port's module lacks)."""
    jax_names = public_names(os.path.join(ROOT, "jafpro_tpu",
                                          module + ".py"))
    port_names = public_names(os.path.join(ROOT, "jafpro_tpu_torch",
                                           module + ".py"))
    return jax_names, sorted(jax_names - port_names)


def main(argv=None) -> int:
    names = (argv if argv is not None else sys.argv[1:]) or modules()
    for module in names:
        jax_names, lack = missing(module)
        print(f"{module}: {len(jax_names)} public, "
              f"{len(jax_names) - len(lack)} in the port; lacks "
              f"{', '.join(lack) if lack else 'nothing'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

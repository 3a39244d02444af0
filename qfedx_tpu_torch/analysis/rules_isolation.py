"""QFX007 — port-isolation: the port imports nothing of JAX or the
reference.

The port is a package of its own beside the JAX reference: it imports
``torch`` and numpy, never ``jax`` (or ``jaxlib``, ``flax``, ``optax``)
and nothing of ``qfedx_tpu``, so it runs on a machine that has no JAX
at all. ``tests/test_torch_isolation.py`` checks that importing every
port module loads none of them, but it sees only what runs at import
time; an import inside a function fails only when that function runs,
on the machine with no JAX. This rule is the static twin of that test,
at every scope:

- an ``import``/``from … import`` of one of those packages (or a
  submodule);
- a string literal naming one of them as the first argument of
  ``importlib.import_module`` or ``__import__``;
- a module-scope ``import matplotlib…``: plotting is optional, so
  ``data/viz`` and the sweep import it inside the function that plots.

Only the tests import both packages; they are not package code.
"""

from __future__ import annotations

import ast

from qfedx_tpu_torch.analysis.engine import Finding, LintContext, Rule, register
from qfedx_tpu_torch.analysis.loader import Module

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "qfedx_tpu")
LAZY_ONLY = ("matplotlib",)
_IMPORTERS = {"import_module", "__import__"}


def _top(name: str, roots: tuple[str, ...]) -> str | None:
    """``roots`` entry that ``name`` is or is a submodule of."""
    for r in roots:
        if name == r or name.startswith(r + "."):
            return r
    return None


def _in_function(node: ast.AST) -> bool:
    cur = getattr(node, "parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return True
        cur = getattr(cur, "parent", None)
    return False


def isolation_violations(mod: Module) -> list[tuple[int, str]]:
    """``[(lineno, message)]`` of forbidden imports in ``mod``."""
    out: list[tuple[int, str]] = []
    for node in ast.walk(mod.tree):
        names: list[str] = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and (
            node.module
        ):
            names = [node.module]
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            fname = fn.attr if isinstance(fn, ast.Attribute) else (
                fn.id if isinstance(fn, ast.Name) else None
            )
            first = node.args[0]
            if fname in _IMPORTERS and isinstance(
                first, ast.Constant
            ) and isinstance(first.value, str):
                hit = _top(first.value, FORBIDDEN)
                if hit is not None:
                    out.append((
                        node.lineno,
                        f"{fname}({first.value!r}) loads {hit} — the port "
                        "imports nothing of JAX or qfedx_tpu, at any scope",
                    ))
            continue
        for name in names:
            hit = _top(name, FORBIDDEN)
            if hit is not None:
                out.append((
                    node.lineno,
                    f"import of {name} — the port imports nothing of JAX "
                    "or qfedx_tpu, at any scope (only the tests import "
                    "both packages)",
                ))
            elif _top(name, LAZY_ONLY) is not None and not _in_function(
                node
            ):
                out.append((
                    node.lineno,
                    f"module-scope import of {name} — plotting is "
                    "optional: import it inside the function that plots",
                ))
    return out


def _run(ctx: LintContext) -> list[Finding]:
    out: list[Finding] = []
    for rel, mod in sorted(ctx.modules.items()):
        for lineno, msg in isolation_violations(mod):
            out.append(Finding("QFX007", rel, lineno, msg))
    return out


register(Rule(
    "QFX007", "port-isolation",
    "the port imports nothing of jax/jaxlib/flax/optax/qfedx_tpu at any "
    "scope, and matplotlib only inside functions",
    _run,
))

"""The lint engine's call graph: reachability with witness
paths from roots given by key.

Counterpart of ``qfedx_tpu/analysis/callgraph.py`` without its
traced-root discovery: the reference seeds reachability from the
functions JAX traces (``jit``/``scan``/``vmap``/``shard_map``), and the
port is eager, so nothing is traced. A rule names its roots instead
(``"rel/path.py::qualname"``; QFX006 (e) starts from the round factories
and the trainers). The graph is conservative and intra-package:

- **Nodes** are function definitions, keyed ``"rel/path.py::qualname"``
  (nested functions and methods get dotted qualnames: ``outer.inner``,
  ``Class.method``).
- **Edges** resolve three call spellings (the ones the repo uses; an
  unresolvable callee is *dropped*, never guessed): a bare ``Name``
  (local nested def, module-level def, or ``from m import f [as g]``
  alias), a module attribute (``mod.f()`` where ``mod`` is an imported
  package module), and ``self.meth()`` (methods of the enclosing
  class). A bare Name *reference* to a known function (callbacks)
  also edges — a function handed around may be invoked by whoever
  receives it.

Under-approximation is the deliberate trade: a dropped edge can only
produce a false *negative*, which the per-rule fixtures and the
baseline keep honest — a guessed edge would produce unactionable
noise, which kills a linter faster than any missed bug.
"""

from __future__ import annotations

import ast
from collections import deque
from dataclasses import dataclass, field

from qfedx_tpu_torch.analysis.loader import Module


@dataclass
class FuncInfo:
    """One function definition node."""

    key: str              # "rel/path.py::qualname"
    module: Module
    qualname: str
    node: ast.AST         # FunctionDef | AsyncFunctionDef | Lambda


@dataclass
class CallGraph:
    functions: dict[str, FuncInfo] = field(default_factory=dict)
    edges: dict[str, set[str]] = field(default_factory=dict)

    def reachable_from(self, roots) -> dict[str, list[str]]:
        """``{key: witness_path}`` for every function reachable from
        one of ``roots`` (roots included, path = [root, ..., key]); a
        root key naming no function is skipped."""
        out: dict[str, list[str]] = {}
        dq = deque()
        for root in roots:
            if root in self.functions and root not in out:
                out[root] = [root]
                dq.append(root)
        while dq:
            cur = dq.popleft()
            for nxt in sorted(self.edges.get(cur, ())):
                if nxt not in out:
                    out[nxt] = out[cur] + [nxt]
                    dq.append(nxt)
        return out


class _ModuleIndex:
    """Per-module symbol tables: local defs by qualname, import aliases."""

    def __init__(self, mod: Module):
        self.mod = mod
        # qualname -> FuncInfo key; also bare name -> key per scope
        self.defs: dict[str, str] = {}
        # alias -> dotted module name ("np" -> "numpy")
        self.import_modules: dict[str, str] = {}
        # alias -> (dotted module, symbol) ("span" -> ("qfedx_tpu_torch.obs", "span"))
        self.import_symbols: dict[str, tuple[str, str]] = {}

    def scan_imports(self) -> None:
        for node in ast.walk(self.mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.import_modules[a.asname] = a.name
                    else:
                        root = a.name.split(".")[0]
                        self.import_modules[root] = root
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    self.import_symbols[a.asname or a.name] = (
                        node.module, a.name
                    )


def _walk_functions(mod: Module):
    """Yield (qualname, node) for every def/lambda, with dotted
    qualnames built from the enclosing def/class chain."""

    def visit(node: ast.AST, prefix: str):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = f"{prefix}{child.name}"
                yield q, child
                yield from visit(child, f"{q}.")
            elif isinstance(child, ast.ClassDef):
                yield from visit(child, f"{prefix}{child.name}.")
            elif isinstance(child, ast.Lambda):
                q = f"{prefix}<lambda@{child.lineno}>"
                yield q, child
                yield from visit(child, f"{q}.")
            else:
                yield from visit(child, prefix)

    yield from visit(mod.tree, "")


def _enclosing_function(node: ast.AST) -> ast.AST | None:
    cur = getattr(node, "parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return cur
        cur = getattr(cur, "parent", None)
    return None


def _enclosing_class(node: ast.AST) -> ast.ClassDef | None:
    cur = getattr(node, "parent", None)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur
        cur = getattr(cur, "parent", None)
    return None


def build_callgraph(modules: dict[str, Module]) -> CallGraph:
    g = CallGraph()
    idx: dict[str, _ModuleIndex] = {}
    # module dotted name -> rel path, for resolving imports package-wide
    by_name: dict[str, str] = {m.name: rel for rel, m in modules.items()}
    node_key: dict[int, str] = {}  # id(ast node) -> function key

    # Pass 1: register every function node.
    for rel, mod in modules.items():
        mi = idx[rel] = _ModuleIndex(mod)
        mi.scan_imports()
        for qualname, fnode in _walk_functions(mod):
            key = f"{rel}::{qualname}"
            g.functions[key] = FuncInfo(key, mod, qualname, fnode)
            g.edges.setdefault(key, set())
            mi.defs[qualname] = key
            node_key[id(fnode)] = key

    def resolve_export(mod_dotted: str, name: str,
                       seen: frozenset = frozenset()) -> str | None:
        """``name`` looked up in module ``mod_dotted``, following
        re-export chains (``obs/__init__.py``'s ``from .trace import
        span`` makes ``obs.span`` resolve to trace.py's def)."""
        if mod_dotted in seen:
            return None
        target_rel = by_name.get(mod_dotted)
        if target_rel is None:
            return None
        mi = idx[target_rel]
        if name in mi.defs:
            return mi.defs[name]
        sym = mi.import_symbols.get(name)
        if sym is not None:
            # re-exported symbol, or an imported submodule used as attr
            hit = resolve_export(sym[0], sym[1], seen | {mod_dotted})
            if hit is not None:
                return hit
            if f"{sym[0]}.{sym[1]}" in by_name:
                return None  # it's a module object, not a function
        return None

    def resolve_in_module(rel: str, name: str, scope_qual: str) -> str | None:
        """A bare Name in function ``scope_qual`` of module ``rel``."""
        mi = idx[rel]
        # innermost-out: nested defs of enclosing scopes, then module level
        parts = scope_qual.split(".") if scope_qual else []
        for depth in range(len(parts), -1, -1):
            q = ".".join(parts[:depth] + [name]) if depth else name
            if q in mi.defs:
                return mi.defs[q]
        # from-import alias to another package module's function
        sym = mi.import_symbols.get(name)
        if sym is not None:
            return resolve_export(sym[0], sym[1])
        return None

    def _module_for_alias(rel: str, base: str) -> str | None:
        """Dotted module a bare name refers to, if it names a module:
        ``import x.y as m`` / ``from pkg import sub``."""
        mi = idx[rel]
        dotted = mi.import_modules.get(base)
        if dotted is not None:
            return dotted
        sym = mi.import_symbols.get(base)
        if sym is not None and f"{sym[0]}.{sym[1]}" in by_name:
            return f"{sym[0]}.{sym[1]}"
        return None

    def resolve_attribute(rel: str, node: ast.Attribute,
                          scope_qual: str) -> str | None:
        """``mod.f`` / ``pkg.sub.f`` / ``self.meth``."""
        mi = idx[rel]
        if isinstance(node.value, ast.Name):
            base = node.value.id
            if base == "self":
                cls = _enclosing_class(node)
                if cls is not None:
                    return mi.defs.get(f"{cls.name}.{node.attr}")
                return None
            dotted = _module_for_alias(rel, base)
            if dotted is not None:
                return resolve_export(dotted, node.attr)
        elif isinstance(node.value, ast.Attribute):
            # pkg.sub.f — flatten the dotted chain
            chain = []
            cur: ast.AST = node.value
            while isinstance(cur, ast.Attribute):
                chain.append(cur.attr)
                cur = cur.value
            if isinstance(cur, ast.Name):
                chain.append(cur.id)
                chain.reverse()
                dotted_base = _module_for_alias(rel, chain[0])
                if dotted_base is None and chain[0] in by_name:
                    dotted_base = chain[0]
                if dotted_base is not None:
                    dotted = ".".join([dotted_base] + chain[1:])
                    return resolve_export(dotted, node.attr)
        return None

    def owner_key(node: ast.AST, rel: str) -> str | None:
        """The function whose body contains ``node`` (module level -> None)."""
        f = _enclosing_function(node)
        return node_key.get(id(f)) if f is not None else None

    # Pass 2: edges.
    for rel, mod in modules.items():
        for node in ast.walk(mod.tree):
            # -- edges: calls and bare function references ----------------
            if isinstance(node, ast.Call):
                src = owner_key(node, rel)
                target = None
                scope = g.functions[src].qualname if src else ""
                if isinstance(node.func, ast.Name):
                    target = resolve_in_module(rel, node.func.id, scope)
                elif isinstance(node.func, ast.Attribute):
                    target = resolve_attribute(rel, node.func, scope)
                if target is not None and src is not None:
                    g.edges[src].add(target)
                elif target is not None:
                    # module-level call: treat module body as a root-less
                    # caller — nothing to edge from, rules scan it directly
                    pass
            elif isinstance(node, ast.Name) and isinstance(
                node.ctx, ast.Load
            ):
                # A bare reference to a known function (a callback) —
                # conservative edge from the enclosing function.
                src = owner_key(node, rel)
                if src is not None:
                    scope = g.functions[src].qualname
                    target = resolve_in_module(rel, node.id, scope)
                    if target is not None and target != src:
                        g.edges[src].add(target)
    return g

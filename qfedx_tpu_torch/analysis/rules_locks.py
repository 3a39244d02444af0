"""QFX004 — lock-discipline for shared instrument state.

Counterpart of ``qfedx_tpu/analysis/rules_locks.py``, copied as it is.

The obs registry's contract (obs/trace.py ``_Registry`` docstring) is
"every mutation happens under ONE lock": concurrent uploader/serve/
telemetry threads bumping the same counter must lose no increments,
and a renderer iterating a dict mid-insert is a RuntimeError. The
rule generalizes that contract to every class that owns a lock:

- A class is *lock-owning* when ``__init__`` assigns
  ``self._lock``/``self._cond`` from ``threading.Lock/RLock/
  Condition``.
- Its *guarded attributes* are the container-typed ``self.X``
  assigned in ``__init__`` (dict/list/set/deque literals or
  constructor calls) — the shared mutable state.
- Any **mutation** of a guarded attribute (subscript store, augmented
  assign, or a mutating method call: append/update/pop/...) in a
  method body must sit lexically inside ``with self._lock:`` /
  ``with self._cond:``.

Escape hatches, by convention: ``__init__`` itself (no concurrent
caller can hold a reference yet) and methods whose name ends in
``_locked`` (the repo's "caller holds the lock" spelling —
``MicroBatcher._take_locked``). Reads are not flagged: the registry's
accessors copy under the lock, and flagging every read would drown
the rule in noise the copies already answer.
"""

from __future__ import annotations

import ast

from qfedx_tpu_torch.analysis.engine import Finding, LintContext, Rule, register
from qfedx_tpu_torch.analysis.loader import Module

LOCK_ATTRS = {"_lock", "_cond"}
_LOCK_TYPES = {"Lock", "RLock", "Condition"}
_CONTAINER_CALLS = {"dict", "list", "set", "deque", "defaultdict",
                    "OrderedDict", "Counter"}
MUTATORS = {
    "append", "appendleft", "extend", "insert", "remove", "pop",
    "popleft", "popitem", "clear", "update", "setdefault", "add",
    "discard", "sort", "reverse",
}


def _is_lock_ctor(value: ast.AST) -> bool:
    if not isinstance(value, ast.Call):
        return False
    fn = value.func
    name = fn.attr if isinstance(fn, ast.Attribute) else (
        fn.id if isinstance(fn, ast.Name) else None
    )
    return name in _LOCK_TYPES


def _is_container_init(value: ast.AST) -> bool:
    if isinstance(value, (ast.Dict, ast.List, ast.Set, ast.ListComp,
                          ast.DictComp, ast.SetComp)):
        return True
    if isinstance(value, ast.BinOp):  # [0] * n
        return _is_container_init(value.left) or _is_container_init(
            value.right
        )
    if isinstance(value, ast.Call):
        fn = value.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None
        )
        return name in _CONTAINER_CALLS
    return False


def _self_attr(node: ast.AST) -> str | None:
    """``self.X`` -> "X"."""
    if isinstance(node, ast.Attribute) and isinstance(
        node.value, ast.Name
    ) and node.value.id == "self":
        return node.attr
    return None


def _under_lock(node: ast.AST, lock_names: set[str]) -> bool:
    """Is ``node`` lexically inside ``with self.<lock>:`` (any item)?"""
    cur = getattr(node, "parent", None)
    while cur is not None:
        if isinstance(cur, (ast.With, ast.AsyncWith)):
            for item in cur.items:
                attr = _self_attr(item.context_expr)
                if attr in lock_names:
                    return True
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return False
        cur = getattr(cur, "parent", None)
    return False


def _class_mutations(cls: ast.ClassDef) -> list[tuple[int, str]]:
    """``[(lineno, message)]`` for one lock-owning class (empty when
    the class owns no lock)."""
    init = next(
        (n for n in cls.body
         if isinstance(n, ast.FunctionDef) and n.name == "__init__"),
        None,
    )
    if init is None:
        return []
    locks: set[str] = set()
    guarded: set[str] = set()
    for node in ast.walk(init):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            attr = _self_attr(node.targets[0])
            if attr is None:
                continue
            if attr in LOCK_ATTRS and _is_lock_ctor(node.value):
                locks.add(attr)
            elif _is_container_init(node.value):
                guarded.add(attr)
    if not locks or not guarded:
        return []

    out: list[tuple[int, str]] = []
    for meth in cls.body:
        if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if meth.name == "__init__" or meth.name.endswith(
            ("_locked", "_unlocked")
        ):
            continue
        for node in ast.walk(meth):
            attr, verb = None, None
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (
                    node.targets if isinstance(node, ast.Assign)
                    else [node.target]
                )
                for t in targets:
                    if isinstance(t, ast.Subscript):
                        attr = _self_attr(t.value)
                        verb = "subscript store on"
                    elif isinstance(node, ast.AugAssign) and isinstance(
                        t, ast.Attribute
                    ):
                        a = _self_attr(t)
                        if a in guarded:
                            attr, verb = a, "augmented assign to"
            elif isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ) and node.func.attr in MUTATORS:
                attr = _self_attr(node.func.value)
                verb = f".{node.func.attr}() on"
            if attr in guarded and not _under_lock(node, locks):
                lock_list = "/".join(f"self.{n}" for n in sorted(locks))
                out.append((
                    node.lineno,
                    f"{verb} shared 'self.{attr}' outside `with "
                    f"{lock_list}:` in {cls.name}.{meth.name} — racing "
                    "threads can lose this mutation",
                ))
    return out


def lock_violations(mod: Module) -> list[tuple[int, str]]:
    out: list[tuple[int, str]] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef):
            out.extend(_class_mutations(node))
    return out


def _run(ctx: LintContext) -> list[Finding]:
    out: list[Finding] = []
    for rel, mod in sorted(ctx.modules.items()):
        for lineno, msg in lock_violations(mod):
            out.append(Finding("QFX004", rel, lineno, msg))
    return out


register(Rule(
    "QFX004", "lock-discipline",
    "mutations of lock-owning classes' shared container state happen "
    "under the lock (no lost increments, no iterate-during-insert)",
    _run,
))

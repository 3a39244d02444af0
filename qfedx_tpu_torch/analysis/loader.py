"""Shared module loader: one parse per file, parent-annotated, cached.

Counterpart of ``qfedx_tpu/analysis/loader.py``, copied as it is. The
loader parses each file ONCE into a ``Module`` carrying the AST (with
``.parent`` back-links — rules need "is this call a ``with`` item?",
"which function encloses this node?"), the source lines (baseline keys
are line *text*, stable across line-number drift), and the per-line
suppressions.

Suppression grammar (per line, same line as the finding):

    something()  # qfedx: ignore[QFX002] reason the reader needs

Multiple IDs comma-separate: ``ignore[QFX002,QFX003]``. The reason is
free text; the engine requires it to be non-empty — a suppression is a
claim someone made, and a claim without a why is the drift this whole
package exists to prevent.

The cache keys on (path, mtime, size): a test editing a fixture file
in tmp_path re-parses, a second rule pass over the repo does not.
"""

from __future__ import annotations

import ast
import re
import tokenize
from dataclasses import dataclass, field
from pathlib import Path

_SUPPRESS = re.compile(
    r"#\s*qfedx:\s*ignore\[([A-Za-z0-9_,\s]+)\]\s*(.*)"
)


@dataclass(frozen=True)
class Suppression:
    """One ``# qfedx: ignore[...]`` comment."""

    line: int
    rules: tuple[str, ...]
    reason: str


@dataclass
class Module:
    """One parsed source file, shared by every rule."""

    path: Path            # absolute
    rel: str              # posix path relative to the scan root
    name: str             # dotted module name ("qfedx_tpu_torch.ops.fuse")
    tree: ast.Module
    lines: list[str] = field(default_factory=list)
    suppressions: dict[int, Suppression] = field(default_factory=dict)

    def line_text(self, lineno: int) -> str:
        """Stripped source text of ``lineno`` (1-based) — the
        line-number-stable half of a baseline key."""
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def suppressed(self, lineno: int, rule: str) -> bool:
        sup = self.suppressions.get(lineno)
        return sup is not None and (
            rule in sup.rules or "*" in sup.rules
        )


def annotate_parents(tree: ast.AST) -> None:
    """Set ``.parent`` on every node (the AST module doesn't)."""
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child.parent = node  # type: ignore[attr-defined]


def parse_suppressions(lines: list[str]) -> dict[int, Suppression]:
    """Suppressions from real COMMENT tokens only — the grammar inside
    a string literal or docstring (a doc example, this module's own
    docstring) must neither register an exemption nor trip QFX000."""
    out: dict[int, Suppression] = {}
    readline = iter([ln + "\n" for ln in lines]).__next__
    try:
        tokens = list(tokenize.generate_tokens(readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        # The loader only reaches here after ast.parse succeeded, so
        # this is theoretical; degrade to no suppressions (loud side).
        return out
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _SUPPRESS.search(tok.string)
        if m:
            i = tok.start[0]
            rules = tuple(
                r.strip() for r in m.group(1).split(",") if r.strip()
            )
            out[i] = Suppression(i, rules, m.group(2).strip())
    return out


def module_name(rel: str) -> str:
    parts = Path(rel).with_suffix("").parts
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


# (path, mtime, size) -> the expensive parse artifacts. The Module
# wrapper itself is rebuilt per load call — it is cheap, and callers
# key the same file differently (package-relative in the standalone
# check_* surfaces, repo-relative under the engine), so caching the
# payload instead of the wrapper lets both share ONE parse without
# anyone mutating a cached object.
_CACHE: dict[tuple, tuple[ast.Module, list[str], dict[int, Suppression]]] = {}


def load_module(path: Path, rel: str) -> Module:
    """Parse one file (parse cached on path+mtime+size)."""
    st = path.stat()
    key = (str(path), st.st_mtime_ns, st.st_size)
    hit = _CACHE.get(key)
    if hit is None:
        text = path.read_text()
        tree = ast.parse(text, filename=str(path))
        annotate_parents(tree)
        lines = text.splitlines()
        hit = (tree, lines, parse_suppressions(lines))
        _CACHE[key] = hit
    tree, lines, suppressions = hit
    return Module(
        path=path,
        rel=rel,
        name=module_name(rel),
        tree=tree,
        lines=lines,
        suppressions=suppressions,
    )


def load_tree(
    root: Path,
    exclude: tuple[str, ...] = ("__pycache__",),
    rel_prefix: str = "",
) -> dict[str, Module]:
    """``{rel_path: Module}`` for every ``*.py`` under ``root``,
    skipping any path with an excluded component. ``rel`` paths are
    posix and relative to ``root`` (matching the standalone checkers:
    ``ops/fuse.py`` when root is the package dir); ``rel_prefix``
    prepends a path segment to every rel AND the dotted module name —
    the engine passes the package dir's repo-relative prefix so
    Finding paths, baseline keys and import resolution all speak
    repo coordinates without re-keying anything after the fact."""
    root = Path(root)
    out: dict[str, Module] = {}
    for py in sorted(root.rglob("*.py")):
        rel = py.relative_to(root).as_posix()
        if any(part in exclude for part in Path(rel).parts):
            continue
        if rel_prefix:
            rel = f"{rel_prefix}/{rel}"
        out[rel] = load_module(py, rel)
    return out

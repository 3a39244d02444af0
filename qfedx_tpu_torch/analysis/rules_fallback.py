"""QFX008 — no-device-fallback: a CUDA tensor launches the kernel or
raises.

The port's entry points run on the card unless the caller passes
``device="cpu"``, and a kernel wrapper takes its plain PyTorch version
only because the tensor it was given lies on the CPU. A silent fall
back — to the plain version when a launch fails, or to the CPU when no
card is found — keeps a run going on another path than the one it
claims, and every number it reports then measures the wrong thing. So
the rule flags:

- **(a)** an ``except`` handler whose body calls a plain version or
  moves work to the CPU. A plain version is a function whose name ends
  in ``_plain`` (``ops/scan_body.scan_body_plain``): every plain
  version of a kernel is named so. Moving work to the CPU is
  ``.cpu()``, ``.to("cpu")``, ``torch.device("cpu")`` or a
  ``device="cpu"`` argument.
- **(b)** an ``if`` statement or conditional expression whose test
  calls ``torch.cuda.is_available()`` or ``torch.cuda.device_count()``
  and one of whose branches names the CPU device (a ``"cpu"`` string or
  a ``.cpu()`` call). ``utils/pins.resolve_device`` is the one place
  that decides the device: it raises without CUDA.
"""

from __future__ import annotations

import ast

from qfedx_tpu_torch.analysis.engine import Finding, LintContext, Rule, register
from qfedx_tpu_torch.analysis.loader import Module

PLAIN_SUFFIX = "_plain"
_CUDA_PROBES = {"is_available", "device_count"}


def _is_cpu_str(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and isinstance(
        node.value, str
    ) and (node.value == "cpu" or node.value.startswith("cpu:"))


def _call_name(node: ast.Call) -> str | None:
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return None


def _cpu_move(node: ast.Call) -> str | None:
    """How ``node`` moves work to the CPU, or None."""
    name = _call_name(node)
    if name == "cpu" and isinstance(node.func, ast.Attribute):
        return ".cpu()"
    if name in ("to", "device") and node.args and _is_cpu_str(node.args[0]):
        return f"{'.to' if name == 'to' else 'torch.device'}('cpu')"
    for kw in node.keywords:
        if kw.arg == "device" and _is_cpu_str(kw.value):
            return "device='cpu'"
    return None


def _handler_fallbacks(handler: ast.ExceptHandler) -> list[tuple[int, str]]:
    out: list[tuple[int, str]] = []
    for stmt in handler.body:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name is not None and name.endswith(PLAIN_SUFFIX):
                out.append((
                    node.lineno,
                    f"except handler calls the plain version {name}() — a "
                    "CUDA tensor launches the kernel or raises, never "
                    "falls back",
                ))
                continue
            how = _cpu_move(node)
            if how is not None:
                out.append((
                    node.lineno,
                    f"except handler moves work to the CPU ({how}) — a "
                    "failure on the card raises, never falls back",
                ))
    return out


def _probes_cuda(test: ast.AST) -> bool:
    for node in ast.walk(test):
        if isinstance(node, ast.Call) and isinstance(
            node.func, ast.Attribute
        ) and node.func.attr in _CUDA_PROBES:
            base = node.func.value
            if isinstance(base, ast.Attribute) and base.attr == "cuda":
                return True
    return False


def _names_cpu(branches) -> bool:
    for branch in branches:
        for node in ast.walk(branch):
            if _is_cpu_str(node):
                return True
            if isinstance(node, ast.Call) and _call_name(node) == "cpu" and (
                isinstance(node.func, ast.Attribute)
            ):
                return True
    return False


def fallback_sites(mod: Module) -> list[tuple[int, str]]:
    """``[(lineno, message)]`` of silent device fall-backs in ``mod``."""
    out: list[tuple[int, str]] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ExceptHandler):
            out.extend(_handler_fallbacks(node))
        elif isinstance(node, (ast.If, ast.IfExp)) and _probes_cuda(
            node.test
        ):
            branches = (
                node.body + node.orelse if isinstance(node, ast.If)
                else [node.body, node.orelse]
            )
            if _names_cpu(branches):
                out.append((
                    node.lineno,
                    "branch on torch.cuda availability picks the CPU — "
                    "resolve the device through utils/pins.resolve_device, "
                    "which raises without CUDA",
                ))
    return out


def _run(ctx: LintContext) -> list[Finding]:
    out: list[Finding] = []
    for rel, mod in sorted(ctx.modules.items()):
        for lineno, msg in fallback_sites(mod):
            out.append(Finding("QFX008", rel, lineno, msg))
    return out


register(Rule(
    "QFX008", "no-device-fallback",
    "no except handler falls back to a plain version or the CPU, and no "
    "torch.cuda availability test picks the CPU",
    _run,
))

"""QFX006 — seeded-draws: every random draw in the port comes from a
seed.

The port's runs are replayable: the same ``--seed`` gives the same
partition, initialisation, client sampling, shuffles, noise and fault
draws, which is what the tests hold against the reference and what a
card run is held against its CPU twin with. A draw from a global
random state breaks that silently (its value depends on whatever drew
before it), and a draw in round code outside ``fed/round.RoundDraws``
escapes the per-client, per-stream seeding the rounds are built on.
The rule flags:

- **(a)** a torch sampling call without ``generator=``
  (``torch.rand``, ``randn``, ``randint``, ``randperm``, ``bernoulli``,
  ``multinomial``, ``normal``, ``poisson``, and the in-place
  ``uniform_``, ``normal_``, ``bernoulli_``, ``exponential_``,
  ``geometric_``, ``cauchy_``, ``log_normal_`` and ``random_`` on any
  receiver). A ``*_like`` sampler is always a finding: it takes no
  generator.
- **(b)** ``torch.manual_seed``, ``torch.seed`` or a
  ``torch.cuda.manual_seed*``/``seed*`` call: package code never
  reseeds the global state.
- **(c)** numpy's global-state ``np.random.<f>``: anything but the
  ``default_rng``/``SeedSequence``/``Generator``/``RandomState``/
  bit-generator constructors, and any of those called with no argument.
- **(d)** a draw from the stdlib ``random`` module (its global state or
  an unseeded ``random.Random()``).
- **(e)** a torch sampling call, seeded or not, that the call graph
  reaches from the round factories (``fed/round.py::make_fed_round``,
  ``make_fed_round_partial``, ``make_fed_rounds``) or the trainers
  (``run/trainer.py::train_federated``, ``train_federated_streamed``)
  and that is not inside a method of ``fed/round.RoundDraws``, reported
  with the witness path.
"""

from __future__ import annotations

import ast

from qfedx_tpu_torch.analysis.engine import Finding, LintContext, Rule, register
from qfedx_tpu_torch.analysis.loader import Module

TORCH_SAMPLERS = ("rand", "randn", "randint", "randperm", "bernoulli",
                  "multinomial", "normal", "poisson")
TORCH_LIKE = ("rand_like", "randn_like", "randint_like")
INPLACE_SAMPLERS = ("uniform_", "normal_", "bernoulli_", "exponential_",
                    "geometric_", "cauchy_", "log_normal_", "random_")
TORCH_RESEEDS = ("torch.manual_seed", "torch.seed",
                 "torch.random.manual_seed", "torch.random.seed")
NP_CONSTRUCTORS = ("default_rng", "SeedSequence", "Generator",
                   "RandomState", "BitGenerator", "PCG64", "PCG64DXSM",
                   "MT19937", "Philox", "SFC64")
ROUND_ROOTS = (
    "fed/round.py::make_fed_round",
    "fed/round.py::make_fed_round_partial",
    "fed/round.py::make_fed_rounds",
    "run/trainer.py::train_federated",
    "run/trainer.py::train_federated_streamed",
)
DRAWS_MODULE_SUFFIX = "fed/round.py"
DRAWS_CLASS = "RoundDraws"


def import_aliases(mod: Module) -> dict[str, str]:
    """``{bound name: dotted name}`` for every import in ``mod``, at any
    scope (``import numpy as np`` → ``np: numpy``, ``from torch import
    rand`` → ``rand: torch.rand``)."""
    out: dict[str, str] = {}
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    out[a.asname] = a.name
                else:
                    root = a.name.split(".")[0]
                    out[root] = root
        elif isinstance(node, ast.ImportFrom) and node.module and (
            node.level == 0
        ):
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def dotted_call(func: ast.AST, aliases: dict[str, str]) -> str | None:
    """The dotted name a call's function resolves to through the
    module's imports (``np.random.rand`` → ``numpy.random.rand``), or
    None when its base is no imported name."""
    chain: list[str] = []
    cur = func
    while isinstance(cur, ast.Attribute):
        chain.append(cur.attr)
        cur = cur.value
    if not isinstance(cur, ast.Name) or cur.id not in aliases:
        return None
    return ".".join([aliases[cur.id]] + chain[::-1])


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


def torch_draw(call: ast.Call, aliases: dict[str, str]) -> str | None:
    """The spelling of a torch sampling call (seeded or not), or None."""
    fn = call.func
    if isinstance(fn, ast.Attribute) and fn.attr in INPLACE_SAMPLERS:
        return f".{fn.attr}()"
    dotted = dotted_call(fn, aliases)
    if dotted is None:
        return None
    if dotted in {f"torch.{f}" for f in TORCH_SAMPLERS + TORCH_LIKE}:
        return f"{dotted}()"
    return None


def unseeded_draws(mod: Module) -> list[tuple[int, str]]:
    """``[(lineno, message)]`` of findings (a)–(d) in ``mod``."""
    aliases = import_aliases(mod)
    out: list[tuple[int, str]] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        draw = torch_draw(node, aliases)
        if draw is not None:
            if draw.removesuffix("()").endswith("_like"):
                out.append((node.lineno, (
                    f"{draw} draws from the global torch generator and "
                    "takes no generator= — draw with torch.rand/randn/"
                    "randint(..., generator=) from a seeded generator"
                )))
            elif not _has_generator(node):
                out.append((node.lineno, (
                    f"{draw} without generator= draws from the global "
                    "torch generator — pass a seeded torch.Generator"
                )))
            continue
        dotted = dotted_call(node.func, aliases)
        if dotted is None:
            continue
        if dotted in TORCH_RESEEDS or dotted.startswith(
            ("torch.cuda.manual_seed", "torch.cuda.seed")
        ):
            out.append((node.lineno, (
                f"{dotted}() reseeds torch's global generator — package "
                "code draws from its own seeded torch.Generator"
            )))
        elif dotted.startswith("numpy.random."):
            f = dotted.split(".")[2]
            if f not in NP_CONSTRUCTORS:
                out.append((node.lineno, (
                    f"np.random.{f}() draws from numpy's global state — "
                    "draw from np.random.default_rng(seed)"
                )))
            elif not node.args and not node.keywords:
                out.append((node.lineno, (
                    f"np.random.{f}() without a seed draws OS entropy — "
                    "pass the run's seed"
                )))
        elif dotted.startswith("random."):
            f = dotted.split(".")[1]
            if f != "Random" or not (node.args or node.keywords):
                out.append((node.lineno, (
                    f"random.{f}() draws from the stdlib's global or "
                    "unseeded state — use a seeded numpy or torch "
                    "generator"
                )))
    return out


def _owner(node: ast.AST) -> ast.AST | None:
    cur = getattr(node, "parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.Lambda)):
            return cur
        cur = getattr(cur, "parent", None)
    return None


def _root_keys(functions) -> list[str]:
    return sorted(
        k for k in functions
        for r in ROUND_ROOTS if k == r or k.endswith("/" + r)
    )


def round_draws(ctx: LintContext) -> list[Finding]:
    """Finding (e): seeded torch draws reachable from the round code
    outside ``RoundDraws`` (unseeded ones are already findings)."""
    g = ctx.callgraph
    reach = g.reachable_from(_root_keys(g.functions))
    by_node = {id(info.node): key for key, info in g.functions.items()}
    out: list[Finding] = []
    for rel, mod in sorted(ctx.modules.items()):
        aliases = import_aliases(mod)
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            draw = torch_draw(node, aliases)
            if draw is None or not _has_generator(node):
                continue
            owner = _owner(node)
            key = by_node.get(id(owner)) if owner is not None else None
            if key is None or key not in reach:
                continue
            qual = g.functions[key].qualname
            if rel.endswith(DRAWS_MODULE_SUFFIX) and qual.startswith(
                DRAWS_CLASS + "."
            ):
                continue
            path = " -> ".join(k.split("::")[1] for k in reach[key])
            out.append(Finding("QFX006", rel, node.lineno, (
                f"{draw} reachable from round code outside "
                f"{DRAWS_CLASS} (path: {path}) — round randomness comes "
                f"only from fed/round.{DRAWS_CLASS}"
            )))
    return out


def _run(ctx: LintContext) -> list[Finding]:
    out: list[Finding] = []
    for rel, mod in sorted(ctx.modules.items()):
        for lineno, msg in unseeded_draws(mod):
            out.append(Finding("QFX006", rel, lineno, msg))
    return out + round_draws(ctx)


register(Rule(
    "QFX006", "seeded-draws",
    "every random draw comes from a seeded generator, and round code "
    "draws only through fed/round.RoundDraws",
    _run,
))

"""Lint configuration: the ``[tool.qfedx_tpu_torch.lint]`` pyproject
section.

Counterpart of ``qfedx_tpu/analysis/config.py`` with the port's
defaults: the scanned package is ``qfedx_tpu_torch``, the kernel build
directory ``_build`` is skipped, and the baseline lives beside the
engine (``qfedx_tpu_torch/analysis/lint_baseline.json``). The section is
optional; without it the defaults hold. Python 3.10 has no ``tomllib``,
so the loader tries it (3.11+), then falls back to a deliberately tiny
parser that understands exactly the shapes this section uses:
``key = "string"`` and ``key = ["a", "b"]`` arrays of double-quoted
strings (both valid JSON after the ``=`` — the fallback is
``json.loads``, not a hand-rolled TOML grammar).
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path

_SECTION = "[tool.qfedx_tpu_torch.lint]"
_KV = re.compile(r"^([A-Za-z0-9_-]+)\s*=\s*(.+?)\s*$")


@dataclass
class LintConfig:
    """Resolved lint settings; every field has the committed default."""

    root: Path = Path(".")
    # Scanned package directories, repo-relative.
    packages: tuple[str, ...] = ("qfedx_tpu_torch",)
    # Path components that exclude a file wherever they appear.
    exclude: tuple[str, ...] = ("__pycache__", "_build")
    # Committed grandfathered-findings file, repo-relative.
    baseline: str = "qfedx_tpu_torch/analysis/lint_baseline.json"

    @property
    def baseline_path(self) -> Path:
        return self.root / self.baseline

    def package_roots(self) -> list[Path]:
        return [self.root / p for p in self.packages]


def _fallback_parse(text: str) -> dict:
    """The ``[tool.qfedx_tpu_torch.lint]`` section only, JSON-shaped
    values."""
    out: dict = {}
    in_section = False
    for raw in text.splitlines():
        line = raw.strip()
        if line.startswith("["):
            in_section = line == _SECTION
            continue
        if not in_section or not line or line.startswith("#"):
            continue
        m = _KV.match(line)
        if not m:
            continue
        try:
            out[m.group(1)] = json.loads(m.group(2))
        except ValueError:
            continue  # a value shape the mini-parser doesn't speak: skip
    return out


def load_config(root: str | Path | None = None) -> LintConfig:
    """LintConfig from ``<root>/pyproject.toml`` (defaults when the
    file or section is absent). ``root`` defaults to the repo this
    package lives in."""
    root = (
        Path(root) if root is not None
        else Path(__file__).resolve().parents[2]
    )
    cfg = LintConfig(root=root)
    pyproject = root / "pyproject.toml"
    if not pyproject.exists():
        return cfg
    text = pyproject.read_text()
    section: dict = {}
    try:
        import tomllib  # Python 3.11+

        section = (
            tomllib.loads(text)
            .get("tool", {})
            .get("qfedx_tpu_torch", {})
            .get("lint", {})
        )
    except ModuleNotFoundError:
        section = _fallback_parse(text)
    if "packages" in section:
        cfg.packages = tuple(section["packages"])
    if "exclude" in section:
        cfg.exclude = tuple(section["exclude"])
    if "baseline" in section:
        cfg.baseline = str(section["baseline"])
    return cfg

"""The QFEDX_* pin grammar — ONE parser for every pin the port reads.

Counterpart of ``qfedx_tpu/utils/pins.py`` (a copy: the port imports
nothing of the JAX package). Every boolean pin accepts ``0``/``off``/
``1``/``on`` case-insensitively and rejects anything else with a loud
ValueError — a typo must never silently run the other route.

The reference's ``tpu_backend_default`` (routes follow the JAX backend)
has no counterpart: the port's routing pins default to the program the
card runs (batched, fused, scanned, kernel), on every device, so the
CPU tests run the card's program. What does follow the hardware is the
DEVICE: ``resolve_device`` maps ``device=None`` to CUDA and raises when
there is no card — the CPU runs only when a caller asks for it.
"""

from __future__ import annotations

import os
from typing import Callable


def parse_onoff(value: str) -> bool | None:
    """``0``/``off`` → False, ``1``/``on`` → True (case-insensitive),
    anything else → None."""
    low = value.lower()
    if low in ("0", "off"):
        return False
    if low in ("1", "on"):
        return True
    return None


def bool_pin(name: str, default: bool | Callable[[], bool]) -> bool:
    """Resolve the env pin ``name`` to a bool; ``default`` (a value or a
    lazy callable) applies when the variable is unset."""
    env = os.environ.get(name)
    if env is None:
        return default() if callable(default) else default
    val = parse_onoff(env)
    if val is None:
        raise ValueError(f"{name}={env!r}: expected '1'/'on' or '0'/'off'")
    return val


def resolve_device(device=None):
    """The device an entry point runs on: ``None`` means the card
    (``"cuda"``), and raises when no CUDA device is present — there is
    no silent CPU fallback. Pass ``device="cpu"`` to run on the CPU."""
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch route on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def float_pin(name: str, default: float) -> float:
    """Float-valued pin: unset → default, a number → that value, anything
    else raises."""
    env = os.environ.get(name)
    if env is None:
        return default
    try:
        return float(env)
    except ValueError:
        raise ValueError(f"{name}={env!r}: expected a number") from None


def int_pin(name: str, default: int) -> int:
    """Non-negative-integer pin: unset → default, digits → that value,
    anything else raises."""
    env = os.environ.get(name)
    if env is None:
        return default
    if not env.isdigit():
        raise ValueError(f"{name}={env!r}: expected a non-negative integer")
    return int(env)


def int_list_pin(name: str, default: tuple[int, ...]) -> tuple[int, ...]:
    """Comma-separated integer-list pin: unset → default, ``"1,8,32"`` →
    (1, 8, 32), anything else (including an empty value) raises."""
    env = os.environ.get(name)
    if env is None:
        return default
    try:
        out = tuple(int(tok) for tok in env.split(",") if tok.strip())
    except ValueError:
        out = ()
    if not out:
        raise ValueError(
            f"{name}={env!r}: expected comma-separated integers, "
            "e.g. '1,8,32'"
        )
    return out


def choice_pin(name: str, choices: tuple[str, ...],
               default: str | None) -> str | None:
    """Enumerated-string pin: unset or empty → ``default``, a
    case-insensitive match of one of ``choices`` → that choice, anything
    else raises."""
    env = os.environ.get(name)
    if not env:
        return default
    low = env.lower()
    if low not in choices:
        raise ValueError(f"{name}={env!r}: expected one of {choices}")
    return low


def str_pin(name: str, default: str | None = None) -> str | None:
    """The raw string value of pin ``name`` (``default`` when unset)."""
    return os.environ.get(name, default)

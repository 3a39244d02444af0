"""Kernel-launch census: state-sized-op counts of one executed call.

Counterpart of ``qfedx_tpu/obs/hlo.py``. The reference counts the ops of
a LOWERED program (StableHLO text) by whether they touch a
state-sized tensor; eager PyTorch has no lowered program, so the port
counts the ops a call EXECUTES: ``state_ops`` runs ``fn`` once under a
``TorchDispatchMode`` and splits every aten op by whether any tensor
argument or result holds ≥ ``min_elems`` elements (one pass over a
state-sized buffer) vs small coefficient arithmetic — the reference's
split (``count_state_ops``). A launch of the scan-body kernel goes
through ctypes, not the dispatcher, so the wrapper's ``launch_counts``
over the call are added: each launch is one state-sized sweep.

As in the reference, raw totals are the wrong metric (the fusion pass
adds small matrix-composition ops while removing state passes); the
state-sized count is what fusion shrinks.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


class _OpCounter(TorchDispatchMode):
    def __init__(self, min_elems: int):
        super().__init__()
        self.min_elems = min_elems
        self.total = 0
        self.state = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.total += 1
        flat, _ = tree_flatten((args, kwargs, out))
        if any(isinstance(t, torch.Tensor) and t.numel() >= self.min_elems
               for t in flat):
            self.state += 1
        return out


def state_ops(fn, *args, min_elems: int) -> dict:
    """Run ``fn(*args)`` once and count its executed ops: ``lowered_ops``
    (every aten op plus every scan-body kernel launch), ``lowered_state_ops``
    (those touching a tensor of ≥ ``min_elems`` elements, the launches
    included) and ``kernel_launches`` (the launches alone)."""
    from qfedx_tpu_torch.ops import scan_body

    launches0 = scan_body.launch_count
    counter = _OpCounter(min_elems)
    with counter:
        fn(*args)
    launches = scan_body.launch_count - launches0
    return {
        "lowered_ops": counter.total + launches,
        "lowered_state_ops": counter.state + launches,
        "kernel_launches": launches,
    }


def module_counts(fn, params, n_qubits, compiled=True):
    """Op counts of one call of a step program ``fn(params)`` with the
    reference's keys: ``lowered_ops`` and ``lowered_state_ops`` (state
    size 2^n). With ``compiled`` also ``compiled_instructions`` (every
    executed op, the launches included) and ``compiled_fusions`` (the
    scan-body launches: the fused sweeps the port executes as one
    kernel each)."""
    got = state_ops(fn, params, min_elems=1 << n_qubits)
    out = {"lowered_ops": got["lowered_ops"],
           "lowered_state_ops": got["lowered_state_ops"]}
    if compiled:
        out["compiled_instructions"] = got["lowered_ops"]
        out["compiled_fusions"] = got["kernel_launches"]
    return out

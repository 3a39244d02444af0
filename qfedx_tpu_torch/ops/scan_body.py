"""Scan-body kernel: a stacked fused layer program as ONE Hopper launch.

Counterpart of ``qfedx_tpu/ops/pallas_body.py``. The reference runs the
scanned super-layer body as a Pallas kernel whose grid is (state block,
layer), the block resident across the layer axis, in three launches: the
forward (Launch A), the forward that also writes each layer's entry
state (Launch B, the ``custom_vjp`` residuals) and, for the gradient,
the same kernel over the adjointed program with the cotangent as the
state (Launch C). Here all three are ONE CUDA C++ kernel for ``sm_90a``
in ``csrc/scan_body.cu``: one CTA per state block, a loop over the
layers inside the CTA, the op sequence inside that loop, and an optional
boundary output (see the source's header for the design and its bound).

Routing is the reference's: ``QFEDX_PALLAS`` pins the route (default on
— the card's program), and ``fuse.apply_scan`` consults ``route_ok`` per
program; a program it refuses (e.g. a stacked ``g1`` at even widths
n ≥ 16) runs the torch layer loop, exactly where the reference runs
``lax.scan``.

The wrapper ``scan_body`` launches the kernel for CUDA tensors (or
raises — there is no fallback), and calls the plain PyTorch version
``scan_body_plain`` only for tensors on the CPU. It records no autograd
graph: gradients go through ``ScanBodyFn``, whose forward is Launch B and
whose backward is Launch C plus the coefficient cotangents (torch
autograd of one layer over the saved boundaries). The Function is the
same on both devices; only the sweep inside ``scan_body`` changes.
``launch_count`` counts kernel launches, ``launch_counts`` splits them
by launch ("fwd" = A, "fwd_bnd" = B, "adj" = C), and ``build_count``
counts every build-and-load of the kernel library into the process.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from qfedx_tpu_torch.ops.cpx import CArray
from qfedx_tpu_torch.ops.statevector import _LANE_BITS, _LANES, _SLAB_MIN
from qfedx_tpu_torch.utils import pins

launch_count = 0
launch_counts = {"fwd": 0, "fwd_bnd": 0, "adj": 0}
build_count = 0

_SOURCE = Path(__file__).parent / "csrc" / "scan_body.cu"
_BUILD_DIR = Path(__file__).parent / "csrc" / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LIB = None
_LIB_LOCK = threading.Lock()
build_log = ""  # nvcc's output of the last build (register/spill report)


def pallas_enabled() -> bool:
    """Route scanned layer stacks through the scan-body kernel?
    QFEDX_PALLAS pins ("1"/"on" or "0"/"off"; the reference's name);
    default on."""
    return pins.bool_pin("QFEDX_PALLAS", True)


def resolved_route() -> dict:
    """The fuse/scan/kernel route booleans as this process resolves them
    now (each conjoined with the one below it)."""
    from qfedx_tpu_torch.ops import fuse

    fuse_on = fuse.fuse_enabled()
    scan_on = fuse.scan_enabled() and fuse_on
    return {
        "fuse": fuse_on,
        "scan_layers": scan_on,
        "pallas": pallas_enabled() and scan_on,
    }


# Stacked body kinds the kernel emits; anything else (a "g1"/"g2" that
# survived fusion) runs the torch layer loop.
_STACKED_KINDS = frozenset(
    ("lane", "rowmat", "mask", "rowperm", "glane", "growmat", "rowpair")
)
# Layer-constant kinds with STATIC coefficients.
_STATIC_KINDS = frozenset(("cnot", "rowperm"))

# Trailing gate-axis counts per stacked kind (below the optional group
# axis), mirroring batched._coeff_groups' gate_ndim convention.
_GATE_NDIM = {
    "lane": 2, "rowmat": 2, "mask": 1,
    "glane": 3, "growmat": 3, "rowpair": 4,
}

# Kernel op codes (csrc/scan_body.cu ``enum Kind``) and descriptor width.
_KIND_CODE = {
    "lane": 0, "rowmat": 1, "mask": 2, "glane": 3,
    "growmat": 4, "rowperm": 5, "rowpair": 6, "cnot": 7,
}
_DESC_W = 8


class _OpSpec(NamedTuple):
    """Static (hashable) description of one body op."""

    kind: str
    qubits: tuple
    stacked: bool
    groups: int            # coefficient groups (1 = shared)
    has_im: bool           # stacked coefficients carry an imaginary part
    perm: tuple | None     # static row permutation ("rowperm" only)


class _KernelSpec(NamedTuple):
    """Static description of one scanned-body kernel launch."""

    n: int
    length: int
    tb: int                # state blocks (one per sample when batched)
    batched: bool
    ops: tuple             # of _OpSpec, in execution order


def _op_groups(op, tb: int) -> int | None:
    """Coefficient-group count of a stacked op against ``tb`` state blocks
    (None = unsupported shape), with the G | B contract."""
    gate_ndim = _GATE_NDIM[op.kind]
    lead = op.coeffs.re.ndim - 1 - gate_ndim  # minus the layer axis
    if lead == 0:
        return 1
    if lead != 1:
        return None
    g = op.coeffs.re.shape[1]
    if g <= 0 or tb % g != 0:
        return None
    return g


def route_ok(state: CArray, n: int, program, batched: bool) -> bool:
    """May THIS program run as the scan-body kernel?  The pin must be on,
    the width a slab, and every body op a kind the kernel emits with a
    group count that divides the state-block grid."""
    if not pallas_enabled():
        return False
    if n < _SLAB_MIN or program.length < 1 or not program.body:
        return False
    tb = state.re.shape[0] if batched else 1
    for op in program.body:
        if op.stacked:
            if op.kind not in _STACKED_KINDS or op.kind == "rowperm":
                return False
            if not isinstance(op.coeffs, CArray):
                return False
            if _op_groups(op, tb) is None:
                return False
        else:
            if op.kind not in _STATIC_KINDS:
                return False
            if op.kind == "cnot" and len(op.qubits) != 2:
                return False
    return True


def _build_spec(state: CArray, n: int, program, batched: bool) -> _KernelSpec:
    tb = state.re.shape[0] if batched else 1
    ops = []
    for op in program.body:
        if op.stacked:
            ops.append(_OpSpec(
                op.kind, tuple(op.qubits), True,
                _op_groups(op, tb), op.coeffs.im is not None, None,
            ))
        else:
            perm = (
                tuple(int(i) for i in np.asarray(op.coeffs))
                if op.kind == "rowperm" else None
            )
            ops.append(_OpSpec(op.kind, tuple(op.qubits), False, 1, False,
                               perm))
    return _KernelSpec(
        n=n, length=program.length, tb=tb, batched=batched, ops=tuple(ops)
    )


def _static_arrays(op: _OpSpec) -> list:
    """The static int32 operands ``op`` consumes: a rowperm's gather map.
    The reference also ships 128×128 lane-CNOT permutation matrices; the
    kernel applies those CNOTs as index permutations instead."""
    if op.kind == "rowperm":
        return [np.asarray(op.perm, dtype=np.int32)]
    return []


def _gate_shape(spec: _KernelSpec, kind: str) -> tuple:
    """Per-(layer, group) coefficient block of a stacked kind, in the
    kernel's layout (masks as (R,128) slabs, rowpairs as (4,4))."""
    r = 1 << (spec.n - _LANE_BITS)
    return {
        "lane": (_LANES, _LANES), "rowmat": (r, r),
        "mask": (r, _LANES), "glane": (2, _LANES, _LANES),
        "growmat": (2, r, r), "rowpair": (4, 4),
    }[kind]


@functools.lru_cache(maxsize=256)
def _layout(spec: _KernelSpec):
    """The descriptor table (n_ops, _DESC_W) int32, the packed coefficient
    length in floats, and the packed statics int32 array of ``spec``."""
    desc = np.zeros((len(spec.ops), _DESC_W), dtype=np.int32)
    offset = 0
    statics = []
    static_len = 0
    for i, op in enumerate(spec.ops):
        q = tuple(op.qubits) + (0, 0)
        re_off, im_off = 0, -1
        gsize = 0
        if op.stacked:
            gsize = int(np.prod(_gate_shape(spec, op.kind)))
            block = spec.length * op.groups * gsize
            re_off, offset = offset, offset + block
            if op.has_im:
                im_off, offset = offset, offset + block
        st_off = static_len
        for arr in _static_arrays(op):
            statics.append(arr)
            static_len += arr.size
        desc[i] = (_KIND_CODE[op.kind], q[0], q[1], re_off, im_off,
                   op.groups, gsize, st_off)
    if offset >= 2**31:
        raise ValueError(f"packed coefficients ({offset} floats) exceed int32")
    packed_statics = (
        np.concatenate(statics) if statics else np.zeros(1, np.int32)
    )
    return desc, offset, packed_statics


@functools.lru_cache(maxsize=256)
def _device_tables(spec: _KernelSpec, device: torch.device):
    desc, _, statics = _layout(spec)
    return (
        torch.as_tensor(desc, device=device),
        torch.as_tensor(statics, device=device),
    )


def _check_coeffs(spec: _KernelSpec, xs, device) -> None:
    stacked = [op for op in spec.ops if op.stacked]
    if len(xs) != len(stacked):
        raise ValueError(
            f"spec has {len(stacked)} stacked ops but {len(xs)} coefficient "
            "stacks were given"
        )
    for op, c in zip(stacked, xs):
        want = spec.length * op.groups * int(np.prod(_gate_shape(spec, op.kind)))
        parts = (c.re,) if c.im is None else (c.re, c.im)
        if (c.im is not None) != op.has_im:
            raise ValueError(f"{op.kind}: has_im disagrees with the spec")
        for p in parts:
            if p.dtype != torch.float32:
                raise TypeError(f"{op.kind} coefficients must be float32, "
                                f"got {p.dtype}")
            if p.device != device:
                raise ValueError(f"{op.kind} coefficients on {p.device}, "
                                 f"state on {device}")
            if p.numel() != want or p.shape[0] != spec.length:
                raise ValueError(
                    f"{op.kind} coefficients of shape {tuple(p.shape)} do "
                    f"not match the spec ({want} values, layer axis "
                    f"{spec.length})"
                )


def _pack_coeffs(spec: _KernelSpec, xs) -> torch.Tensor:
    """Every stacked op's (L, G, gate...) re (then im) in one f32 buffer,
    in descriptor order."""
    parts = []
    for c in xs:
        parts.append(c.re.reshape(-1))
        if c.im is not None:
            parts.append(c.im.reshape(-1))
    return torch.cat(parts).contiguous()


# --- the kernel library -----------------------------------------------------


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME); nvcc is "
                           "needed to build the scan-body kernel")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def load_kernel():
    """Build ``csrc/scan_body.cu`` with nvcc (first use; the shared library
    is keyed by the source's hash under ``csrc/_build``), load it into the
    process once, and return it."""
    global _LIB, build_count, build_log
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        tag = hashlib.sha256(_SOURCE.read_bytes()).hexdigest()[:16]
        lib_path = _BUILD_DIR / f"libscan_body_{tag}.so"
        if not lib_path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
                capture_output=True, text=True,
            )
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {_SOURCE.name}:\n{build_log}"
                )
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        fn = lib.qfx_scan_body_launch
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int]
            + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        )
        build_count += 1
        _LIB = lib
        return lib


# --- the wrapper and its plain version --------------------------------------


def reset_counts() -> None:
    """Set ``launch_count`` and every entry of ``launch_counts`` to 0."""
    global launch_count
    launch_count = 0
    for key in launch_counts:
        launch_counts[key] = 0


def scan_body(packed: torch.Tensor, spec: _KernelSpec, xs,
              with_boundaries: bool = False, adjoint: bool = False):
    """One sweep of ``spec``'s body over the packed (2, tb, R, 128) f32
    state with the stacked coefficients ``xs``; returns the packed final
    state, and with ``with_boundaries`` also the (L, 2, tb, R, 128)
    layer-entry states. ``adjoint`` marks a sweep of an adjointed program
    (Launch C) for the launch counts; it changes nothing else.

    CUDA tensors launch the kernel (a launch the runtime refuses raises);
    CPU tensors take ``scan_body_plain``; anything else raises. Inputs
    that require grad under grad mode raise: the sweep records no graph,
    so gradients go through ``ScanBodyFn``."""
    r = 1 << (spec.n - _LANE_BITS)
    if packed.dtype != torch.float32:
        raise TypeError(f"scan_body takes float32 states, got {packed.dtype}")
    if tuple(packed.shape) != (2, spec.tb, r, _LANES):
        raise ValueError(
            f"packed state of shape {tuple(packed.shape)}, expected "
            f"{(2, spec.tb, r, _LANES)}"
        )
    _check_coeffs(spec, xs, packed.device)
    if torch.is_grad_enabled() and (
        packed.requires_grad or any(p.requires_grad for p in _flatten(xs))
    ):
        raise RuntimeError(
            "scan_body records no autograd graph; differentiate through "
            "ScanBodyFn (apply_scan_pallas routes there)"
        )
    if packed.device.type == "cpu":
        return scan_body_plain(packed, spec, xs, with_boundaries)
    if packed.device.type != "cuda":
        raise ValueError(f"scan_body runs on cuda or cpu, not {packed.device}")
    if not packed.is_contiguous():
        raise ValueError("scan_body needs a contiguous packed state")
    key = "adj" if adjoint else ("fwd_bnd" if with_boundaries else "fwd")
    return _launch(packed, spec, xs, with_boundaries, key)


def _launch(packed, spec, xs, with_boundaries: bool, key: str):
    global launch_count
    lib = load_kernel()
    # The launch is asynchronous on the current stream. The temporaries
    # below (coefficients, scratch) go back to PyTorch's caching allocator
    # when this function returns, which only hands their memory to work
    # queued later on the same stream — after this kernel.
    desc, statics = _device_tables(spec, packed.device)
    coeffs = _pack_coeffs(spec, xs)
    out = torch.empty_like(packed)
    tmp = torch.empty_like(packed)
    half = spec.tb * (1 << spec.n) * packed.element_size()
    bnd = bnd_re = bnd_im = None
    if with_boundaries:
        # (2, L, tb, R, 128): each part is the (L, tb, R, 128) block the
        # kernel writes; the caller sees the (L, 2, tb, R, 128) view.
        bnd = torch.empty((2, spec.length) + tuple(packed.shape[1:]),
                          dtype=packed.dtype, device=packed.device)
        bnd_re = bnd.data_ptr()
        bnd_im = bnd_re + spec.length * half
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    err = lib.qfx_scan_body_launch(
        packed.data_ptr(), packed.data_ptr() + half,
        out.data_ptr(), out.data_ptr() + half,
        tmp.data_ptr(), tmp.data_ptr() + half,
        bnd_re, bnd_im,
        desc.data_ptr(), len(spec.ops),
        coeffs.data_ptr(), statics.data_ptr(),
        spec.tb, spec.n, spec.length, packed.device.index or 0, stream,
    )
    if err != 0:
        raise RuntimeError(f"scan_body kernel launch failed: CUDA error {err}")
    launch_count += 1
    launch_counts[key] += 1
    if with_boundaries:
        return out, bnd.transpose(0, 1)
    return out


def _layer_exec(spec: _KernelSpec, packed: torch.Tensor, sliced
                ) -> torch.Tensor:
    """ONE layer of the body on a packed (2, tb, R, 128) state with the
    layer's coefficient slices — the reference's ``_layer_exec``: the scan
    route's own per-op executors (``fuse._exec_stacked``), so the plain
    sweep and the coefficient cotangents run the code the torch layer
    loop runs."""
    from qfedx_tpu_torch.ops import fuse

    r = 1 << (spec.n - _LANE_BITS)
    shape = (spec.tb, 1 << spec.n)
    st = CArray(packed[0].reshape(shape), packed[1].reshape(shape))
    it = iter(sliced)
    for op in spec.ops:
        if op.stacked:
            coeffs = next(it)
        elif op.kind == "rowperm":
            coeffs = np.asarray(op.perm)
        else:
            coeffs = None
        st = fuse._exec_stacked(
            st, spec.n, fuse.StackedOp(op.kind, op.qubits, coeffs, False),
            spec.batched,
        )
    return torch.stack([
        st.re.reshape(spec.tb, r, _LANES),
        st.imag_or_zeros().reshape(spec.tb, r, _LANES),
    ])


def scan_body_plain(packed: torch.Tensor, spec: _KernelSpec, xs,
                    with_boundaries: bool = False):
    """The kernel's plain PyTorch version: ``_layer_exec`` looped over the
    L layers (with ``with_boundaries``, also the stacked layer-entry
    states, as ``scan_body`` returns them)."""
    from qfedx_tpu_torch.ops import fuse

    bnds = []
    for layer in range(spec.length):
        if with_boundaries:
            bnds.append(packed)
        packed = _layer_exec(
            spec, packed, [fuse._cslice(c, layer) for c in xs]
        )
    if with_boundaries:
        return packed, torch.stack(bnds)
    return packed


# --- the backward: the same sweep over the adjointed program ---------------


def _adjoint_spec(spec: _KernelSpec) -> _KernelSpec:
    """Launch C's spec: op order reversed, static permutations inverted
    (CNOTs are involutions — unchanged)."""
    ops = []
    for op in reversed(spec.ops):
        perm = op.perm
        if op.kind == "rowperm" and perm is not None:
            inv = np.empty(len(perm), dtype=np.int64)
            inv[np.asarray(perm)] = np.arange(len(perm))
            perm = tuple(int(i) for i in inv)
        ops.append(op._replace(perm=perm))
    return spec._replace(ops=tuple(ops))


def _adjoint_xs(spec: _KernelSpec, xs) -> tuple:
    """Adjointed coefficient stacks in ``_adjoint_spec``'s order: branch
    matrices conjugate-transposed (the last two axes only; layer, group
    and branch axes untouched), masks conjugated, rowpairs transposed on
    their paired (2,2,2,2) axes, the layer axis flipped."""
    out = []
    stacked = [op for op in spec.ops if op.stacked]
    for op, c in zip(stacked, xs):
        re, im = c.re, c.im
        if op.kind == "mask":
            im = None if im is None else -im
        elif op.kind == "rowpair":
            def tp(x):
                return x.transpose(-4, -2).transpose(-3, -1)

            re = tp(re)
            im = None if im is None else -tp(im)
        else:  # lane / rowmat / glane / growmat: M† per branch
            re = re.transpose(-1, -2)
            im = None if im is None else -im.transpose(-1, -2)
        re = torch.flip(re, (0,))
        im = None if im is None else torch.flip(im, (0,))
        out.append(CArray(re, im))
    return tuple(reversed(out))


def _flatten(xs) -> list:
    """Coefficient stacks → flat tensor list (re, then im where present)."""
    return [p for c in xs for p in (c.re, c.im) if p is not None]


def _unflatten(spec: _KernelSpec, flat) -> tuple:
    it = iter(flat)
    return tuple(
        CArray(next(it), next(it) if op.has_im else None)
        for op in spec.ops if op.stacked
    )


def _coeff_cotangents(spec, bnd, flat, c_out, need) -> list:
    """dL/dxs[l] = (∂out_l/∂xs[l])ᵀ C[l]: torch autograd of one layer
    (``_layer_exec``) at its saved entry state ``bnd[l]``, against that
    layer's output cotangent ``c_out[l]`` — the reference's vjp of the
    vmapped layer body, as a loop over the L layers."""
    from qfedx_tpu_torch.ops import fuse

    with torch.enable_grad():
        leaves = [p.detach().requires_grad_(bool(nd))
                  for p, nd in zip(flat, need)]
        xs = _unflatten(spec, leaves)
        outs = torch.stack([
            _layer_exec(spec, bnd[layer],
                        [fuse._cslice(c, layer) for c in xs])
            for layer in range(spec.length)
        ])
        wanted = [p for p in leaves if p.requires_grad]
        grads = iter(torch.autograd.grad(
            outs, wanted, grad_outputs=c_out, allow_unused=True
        ))
    out = []
    for p in leaves:
        g = next(grads) if p.requires_grad else None
        if p.requires_grad and g is None:
            g = torch.zeros_like(p)
        out.append(g)
    return out


class ScanBodyFn(torch.autograd.Function):
    """The differentiable sweep — the reference's ``_pallas_scan``
    ``custom_vjp``. ``apply(spec, packed, *flat)``: ``flat`` is every
    stacked op's coefficients, re then im where present.

    forward: Launch B (``scan_body(..., with_boundaries=True)``), saving
    the boundaries. backward: Launch C — the same sweep over
    ``_adjoint_spec``/``_adjoint_xs`` with the cotangent as the state —
    gives the state cotangent, and its flipped boundaries are the
    per-layer output cotangents the coefficient cotangents contract
    against (``_coeff_cotangents``)."""

    @staticmethod
    def forward(ctx, spec, packed, *flat):
        final, bnd = scan_body(packed, spec, _unflatten(spec, flat),
                               with_boundaries=True)
        ctx.spec = spec
        ctx.save_for_backward(bnd, *flat)
        return final

    @staticmethod
    @once_differentiable
    def backward(ctx, cot):
        spec = ctx.spec
        bnd, *flat = ctx.saved_tensors
        xs = _unflatten(spec, flat)
        state_cot, cbnd = scan_body(
            cot.contiguous(), _adjoint_spec(spec), _adjoint_xs(spec, xs),
            with_boundaries=True, adjoint=True,
        )
        need = ctx.needs_input_grad[2:]
        coeff = [None] * len(flat)
        if any(need):
            coeff = _coeff_cotangents(
                spec, bnd, flat, torch.flip(cbnd, (0,)), need
            )
        return (None, state_cot if ctx.needs_input_grad[1] else None,
                *coeff)


def apply_scan_pallas(state: CArray, n: int, program,
                      batched: bool = False) -> CArray:
    """Run a stacked fused program with the body as ONE scan-body sweep
    (``fuse.apply_scan``'s kernel branch — same pre-op hoisting). Under
    grad mode with a state or coefficient that requires grad the sweep is
    ``ScanBodyFn`` (Launches B, then C in the backward); otherwise it is
    one plain forward (Launch A). Callers route through
    ``fuse.apply_scan``; this entry assumes ``route_ok``."""
    from qfedx_tpu_torch.ops import fuse

    state = CArray(state.re, state.imag_or_zeros())
    for op in program.pre:
        state = fuse._exec_stacked(state, n, op, batched)
    spec = _build_spec(state, n, program, batched)
    xs = tuple(op.coeffs for op in program.body if op.stacked)
    r = 1 << (n - _LANE_BITS)
    shape = state.re.shape
    packed = torch.stack([
        state.re.reshape(spec.tb, r, _LANES),
        state.im.reshape(spec.tb, r, _LANES),
    ])
    flat = _flatten(xs)
    if torch.is_grad_enabled() and (
        packed.requires_grad or any(p.requires_grad for p in flat)
    ):
        out = ScanBodyFn.apply(spec, packed, *flat)
    else:
        out = scan_body(packed, spec, xs)
    return CArray(out[0].reshape(shape), out[1].reshape(shape))

"""Scan-body kernel: a stacked fused layer program as ONE Hopper launch.

Counterpart of ``qfedx_tpu/ops/pallas_body.py``. The reference runs the
scanned super-layer body as a Pallas kernel whose grid is (state block,
layer), the block resident across the layer axis, in three launches: the
forward (Launch A), the forward that also writes each layer's entry
state (Launch B, the ``custom_vjp`` residuals) and, for the gradient,
the same kernel over the adjointed program with the cotangent as the
state (Launch C). Here all three are ONE CUDA C++ kernel for ``sm_90a``
in ``csrc/scan_body.cu`` (with its headers), a loop over the layers
inside each sample's CTAs, the op sequence inside that loop, and an
optional boundary output, in two instances: up to n=17 a cluster of K
CTAs holds each sample's state in shared memory for the whole sweep,
wider widths run one CTA per sample over global memory. Each comes in
an f32 and a bf16 instance, chosen by the state's dtype (the spec's
``dtype``): the bf16 one reads and writes bf16 in global memory, takes
the coefficients rounded to bf16 as the reference's ``_coeff_operands``
does, accumulates every product in f32 and rounds each op's result to
bf16 where the reference's ``_emit`` rounds; the bf16 cluster instance
takes its lane and row products on the tensor cores (bf16 ``mma`` with f32
accumulation, ``csrc/scan_body_mma.cuh``). ``_launch_config`` picks the
instance and K from the width, tb and dtype alone, before the launch
(see the source's header for the design and its bound).

Routing is the reference's: ``QFEDX_PALLAS`` pins the route (default on
— the card's program), and ``fuse.apply_scan`` consults ``route_ok`` per
program; a program it refuses (e.g. a stacked ``g1`` at even widths
n ≥ 16) runs the torch layer loop, exactly where the reference runs
``lax.scan``.

The wrapper ``scan_body`` launches the kernel for CUDA tensors (or
raises — there is no fallback: a bf16 state never runs the f32 instance
or the plain version), and calls the plain PyTorch version
``scan_body_plain`` only for tensors on the CPU. It records no autograd
graph: gradients go through ``ScanBodyFn``, whose forward is Launch B and
whose backward is Launch C plus the coefficient cotangents (torch
autograd of one layer over the saved boundaries). The Function is the
same on both devices; only the sweep inside ``scan_body`` changes.
``launch_count`` counts kernel launches, ``launch_counts`` splits them
by launch ("fwd" = A, "fwd_bnd" = B, "adj" = C), ``dtype_counts`` by the
instance's element type ("float32", "bfloat16"), and ``build_count``
counts every build-and-load of the kernel libraries into the process
(one library per element type, built by concurrent nvcc processes).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import threading
import time
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
dtype_counts = {"float32": 0, "bfloat16": 0}
build_count = 0

_CSRC = Path(__file__).parent / "csrc"
_SOURCE = _CSRC / "scan_body.cu"
_BUILD_DIR = _CSRC / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LIBS: dict | None = None  # by the C entries' dtype code (_DTYPE_CODE)
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
    dtype: str = "float32"  # the state's (and the launch's) element type


# The kernel's element types: the state, the boundaries and the packed
# coefficients of one launch share one.
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype_name(dtype: torch.dtype) -> str:
    for name, dt in _DTYPES.items():
        if dt == dtype:
            return name
    raise TypeError(f"scan_body takes float32 or bfloat16 states, got {dtype}")


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
        n=n, length=program.length, tb=tb, batched=batched, ops=tuple(ops),
        dtype=_dtype_name(state.re.dtype),
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
    length in elements, and the packed statics int32 array of ``spec``.
    Every offset is a multiple of 8 elements (16 bytes in bf16), as the
    kernel's bulk copies need."""
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
        raise ValueError(f"packed coefficients ({offset} values) exceed int32")
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


# The launch configuration. An H100 has 232,448 bytes of shared memory
# per block; a cluster holds at most 16 CTAs (above 8 with the
# non-portable attribute). The cluster instance runs one CTA per SM (its
# shared memory), and an H100 SXM keeps only this many clusters of K such
# CTAs resident at once (cudaOccupancyMaxActiveClusters, which
# chip_smoke.py prints beside each launch: a cluster lives inside one GPC,
# and the GPCs' SM counts do not divide by K); a launch of more clusters
# runs in a second wave.
_SMEM_LIMIT = 232_448
_MAX_CLUSTER = 16
_RESIDENT = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}


class LaunchConfig(NamedTuple):
    """Which instance of the kernel runs a spec, and how."""

    instance: str          # "cluster" or "global"
    cluster: int           # K, CTAs per sample (1 for "global")
    smem: int              # dynamic shared memory per CTA, bytes
    dtype: str = "float32"  # the instance's element type
    # Where the lane and row products run: "mma" (bf16 tensor cores: the
    # bf16 cluster instance) or "ffma" (f32 FMAs: every other instance).
    products: str = "ffma"


# The cluster instance's stage region (csrc/scan_body_cluster.cuh) comes
# in units of one 16-row slab of a 128×128 matrix, re and im, in the
# launch's element type (the ring holds the coefficients as they lie in
# global memory); it takes 4 to 8 units, with its products on the tensor
# cores (the bf16 instance, csrc/scan_body_mma.cuh) up to 16, so that each
# slab of a glane's two branches has a stage of its own. The state in
# shared memory is f32 in both instances (in bf16, values already rounded
# to bf16); the tensor-core instance adds a bf16 copy of the CTA's rows,
# _OPND_PITCH elements apart (re, then im), before the descriptor table.
_MIN_UNITS, _MAX_UNITS, _MMA_MAX_UNITS = 4, 8, 16
_OPND_PITCH = _LANES + 8


def _unit_bytes(dtype: str) -> int:
    return 2 * 16 * _LANES * _DTYPES[dtype].itemsize


def _products(dtype: str) -> str:
    """Where the cluster instance of ``dtype`` runs its lane and row
    products."""
    return "mma" if dtype == "bfloat16" else "ffma"


def _cluster_smem(spec: _KernelSpec, k: int) -> int | None:
    """Dynamic shared memory of one CTA of the cluster instance, or None
    where it does not fit: two ping-pong buffers of its R/K rows (re and
    im, f32), with tensor-core products ("mma", the bf16 instance) the
    bf16 copy of those rows, the descriptor table, and a stage region of
    as many units as the rest of the block's shared memory holds, 4 to 8
    in f32 (128 KB), 4 to 16 with "mma" (128 KB)."""
    products = _products(spec.dtype)
    rows = (1 << (spec.n - _LANE_BITS)) // k
    fixed = 2 * 2 * rows * _LANES * 4 + len(spec.ops) * _DESC_W * 4
    most = _MAX_UNITS
    if products == "mma":
        fixed += 2 * rows * _OPND_PITCH * _DTYPES[spec.dtype].itemsize
        most = _MMA_MAX_UNITS
    unit = _unit_bytes(spec.dtype)
    units = min(most, (_SMEM_LIMIT - fixed) // unit)
    if units < _MIN_UNITS:
        return None
    return fixed + units * unit


@functools.lru_cache(maxsize=256)
def _launch_config(spec: _KernelSpec) -> LaunchConfig:
    """The instance, cluster size K and dynamic shared memory for
    ``spec``, from its width, tb and dtype alone (a pure function: no CUDA
    call, no retry after a failure).

    K is the largest power of two ≤ min(16, R) whose CTAs' rows fit their
    shared memory and whose tb clusters the card keeps resident in one
    wave (``_RESIDENT``: K=16 at tb ≤ 7, 8 at tb ≤ 15, 4 at tb ≤ 30, 2 at
    tb ≤ 66); where no K fits one wave, the smallest K that fits the
    memory. A width whose state no cluster of ≤ 16 CTAs holds (n ≥ 18 in
    f32 and bf16 alike: the shared-memory state is f32 in both) takes
    the global-memory instance."""
    rows = 1 << (spec.n - _LANE_BITS)
    fits = [
        (k, smem) for k in (16, 8, 4, 2, 1)
        if k <= rows and (smem := _cluster_smem(spec, k)) is not None
    ]
    if not fits:
        return LaunchConfig("global", 1, 0, spec.dtype)
    products = _products(spec.dtype)
    for k, smem in fits:
        if spec.tb <= _RESIDENT[k]:
            return LaunchConfig("cluster", k, smem, spec.dtype, products)
    k, smem = fits[-1]
    return LaunchConfig("cluster", k, smem, spec.dtype, products)


# The C entries' instance code of each dtype (csrc/scan_body.cu).
_DTYPE_CODE = {"float32": 0, "bfloat16": 1}


def _check_coeffs(spec: _KernelSpec, xs, device) -> None:
    """Coefficients come in f32 (the program's build) or already in the
    launch's dtype; ``_pack_coeffs`` rounds them to it."""
    launch_dt = _DTYPES[spec.dtype]
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
            if p.dtype not in (torch.float32, launch_dt):
                raise TypeError(f"{op.kind} coefficients must be float32 or "
                                f"{spec.dtype}, got {p.dtype}")
            if p.device != device:
                raise ValueError(f"{op.kind} coefficients on {p.device}, "
                                 f"state on {device}")
            if p.numel() != want or p.shape[0] != spec.length:
                raise ValueError(
                    f"{op.kind} coefficients of shape {tuple(p.shape)} do "
                    f"not match the spec ({want} values, layer axis "
                    f"{spec.length})"
                )


def _ring_swizzle(x: torch.Tensor) -> torch.Tensor:
    """128×128 lane matrices (the last two axes) with each row's 16-byte
    chunks permuted as the tensor-core instance's ring reads them: chunk c
    of row j stored at chunk c ^ (j mod 8), so that the eight rows of an
    ldmatrix tile fall in eight bank groups (csrc/scan_body_mma.cuh). The
    permutation is its own inverse."""
    j = torch.arange(_LANES, device=x.device)[:, None]
    k = torch.arange(_LANES, device=x.device)[None, :]
    perm = (j * _LANES + ((k >> 3) ^ (j & 7)) * 8 + (k & 7)).reshape(-1)
    flat = x.reshape(-1, _LANES * _LANES)
    return flat[:, perm].reshape(x.shape)


@functools.lru_cache(maxsize=16)
def _swizzle_index(spec: _KernelSpec, device: torch.device) -> torch.Tensor:
    """The int32 gather index that takes ``spec``'s packed coefficients
    to the tensor-core instance's layout: the identity, with every lane
    and glane matrix through ``_ring_swizzle``. Built once per spec and
    device, so a launch pays one gather over its coefficients."""
    desc, total, _ = _layout(spec)
    idx = torch.arange(total, dtype=torch.int32)
    for op, row in zip(spec.ops, desc):
        if not (op.stacked and op.kind in ("lane", "glane")):
            continue
        block = spec.length * op.groups * int(row[6])
        for off in (int(row[3]), int(row[4])):
            if off >= 0:
                part = idx[off:off + block]
                part.copy_(_ring_swizzle(part.view(-1, _LANES, _LANES))
                           .reshape(-1))
    return idx.to(device)


def _pack_coeffs(spec: _KernelSpec, xs,
                 swizzle: bool = False) -> torch.Tensor:
    """Every stacked op's (L, G, gate...) re (then im) in one buffer of
    the launch's dtype, in descriptor order: in bf16 each coefficient is
    rounded to bf16 here, as the reference's ``_coeff_operands`` casts.
    ``swizzle`` (the tensor-core instance) stores the lane and glane
    matrices through ``_ring_swizzle``: one concatenation, one gather
    (``_swizzle_index``) and one rounding."""
    dt = _DTYPES[spec.dtype]
    parts = []
    for c in xs:
        parts.append(c.re.reshape(-1))
        if c.im is not None:
            parts.append(c.im.reshape(-1))
    if swizzle:
        flat = torch.cat(parts)
        return flat.index_select(0, _swizzle_index(spec, flat.device)).to(dt)
    return torch.cat([p.to(dt) for p in parts]).contiguous()


# --- the kernel library -----------------------------------------------------


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME); nvcc is "
                           "needed to build the scan-body kernel")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _build_inputs() -> list:
    """Every file the kernel's build reads: ``scan_body.cu`` and the
    headers (``*.cuh``) beside it."""
    return [_SOURCE] + sorted(_CSRC.glob("*.cuh"))


def _build_tag() -> str:
    """The shared library's key: a hash of the nvcc flags and of every
    file the build reads (name and content), so a changed header
    rebuilds rather than loading a stale library."""
    h = hashlib.sha256(repr(_NVCC_FLAGS).encode())
    for path in _build_inputs():
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entries' argument and result types."""
    fn = lib.qfx_scan_body_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int]
        + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        + [ctypes.c_int] * 3
    )
    resident = lib.qfx_scan_body_max_clusters
    resident.restype = ctypes.c_int
    resident.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    attrs = lib.qfx_scan_body_attrs
    attrs.restype = ctypes.c_int
    attrs.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
    return lib


def load_kernel() -> dict:
    """Build ``csrc/scan_body.cu`` (with its headers) by nvcc at first use,
    once per instance element type, the two nvcc processes side by side —
    the shared libraries are keyed by ``_build_tag`` and the type under
    ``csrc/_build`` — load them into the process once, and return them
    by dtype code (``_DTYPE_CODE``)."""
    global _LIBS, build_count, build_log
    with _LIB_LOCK:
        if _LIBS is not None:
            return _LIBS
        t0 = time.perf_counter()
        tag = _build_tag()
        # One library per instance element type, compiled with
        # -DQFX_INSTANCE=<its dtype code>.
        paths = {code: _BUILD_DIR / f"libscan_body_{tag}_{code}.so"
                 for code in _DTYPE_CODE.values()}
        todo = {code: p for code, p in paths.items() if not p.exists()}
        if todo:
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            procs = {}
            for code, path in todo.items():
                tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
                log = tempfile.TemporaryFile("w+")
                procs[code] = (tmp, log, subprocess.Popen(
                    [_nvcc(), *_NVCC_FLAGS, f"-DQFX_INSTANCE={code}", "-o",
                     str(tmp), str(_SOURCE)],
                    stdout=log, stderr=subprocess.STDOUT, text=True,
                ))
            build_log, failed = "", []
            for code, (tmp, log, proc) in sorted(procs.items()):
                if proc.wait() != 0:
                    failed.append(code)
                log.seek(0)
                build_log += log.read()
                log.close()
            if failed:
                raise RuntimeError(
                    f"nvcc failed to build {_SOURCE.name} (QFX_INSTANCE="
                    f"{failed}):\n{build_log}"
                )
            for code, (tmp, _, _) in procs.items():
                os.replace(tmp, todo[code])
        _LIBS = {code: _bind(ctypes.CDLL(str(path)))
                 for code, path in paths.items()}
        build_count += 1
        # The port's one compile: attributed to the open span (obs).
        from qfedx_tpu_torch.obs import trace as obs_trace

        obs_trace.attribute_compile("kernel_build", time.perf_counter() - t0)
        return _LIBS


# --- the wrapper and its plain version --------------------------------------


def reset_counts() -> None:
    """Set ``launch_count`` and every entry of ``launch_counts`` and
    ``dtype_counts`` to 0."""
    global launch_count
    launch_count = 0
    for counts in (launch_counts, dtype_counts):
        for key in counts:
            counts[key] = 0


def scan_body(packed: torch.Tensor, spec: _KernelSpec, xs,
              with_boundaries: bool = False, adjoint: bool = False):
    """One sweep of ``spec``'s body over the packed (2, tb, R, 128) state
    (f32, or bf16 with a bf16 spec) with the stacked coefficients ``xs``
    (f32, or already the state's dtype); returns the packed final state,
    and with ``with_boundaries`` also the (L, 2, tb, R, 128) layer-entry
    states, both in the state's dtype. ``adjoint`` marks a sweep of an
    adjointed program (Launch C) for the launch counts; it changes
    nothing else.

    CUDA tensors launch the kernel instance of the state's dtype (a launch
    the runtime refuses raises); CPU tensors take ``scan_body_plain``;
    anything else raises, as does a state whose dtype is not the spec's.
    Inputs that require grad under grad mode raise: the sweep records no
    graph, so gradients go through ``ScanBodyFn``."""
    r = 1 << (spec.n - _LANE_BITS)
    if _dtype_name(packed.dtype) != spec.dtype:
        raise TypeError(f"a {packed.dtype} state for a {spec.dtype} spec: "
                        "the state and its launch share one dtype")
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


class _Prepared(NamedTuple):
    """One launch of the kernel with every operand packed and every
    output allocated: ``run()`` enqueues it (and returns the CUDA error,
    0 = launched) any number of times without counting a launch, so a
    timing loop measures the kernel alone; the wrapper counts its own."""

    lib: ctypes.CDLL       # the library of the launch's instance dtype
    args: tuple
    keep: tuple            # tensors the launch reads or writes
    out: torch.Tensor
    bnd: torch.Tensor | None
    config: LaunchConfig

    def run(self) -> int:
        return self.lib.qfx_scan_body_launch(*self.args)


def prepare_launch(packed, spec: _KernelSpec, xs,
                   with_boundaries: bool = False) -> _Prepared:
    """Pack ``xs`` (rounded to the spec's dtype), allocate the output,
    scratch and boundary buffers, and bind the launch's arguments (CUDA
    tensors). The state, the coefficients and the outputs share the
    spec's dtype, which selects the instance; a state of another dtype
    raises."""
    if _dtype_name(packed.dtype) != spec.dtype:
        raise TypeError(f"a {packed.dtype} state for a {spec.dtype} launch")
    cfg = _launch_config(spec)
    lib = load_kernel()[_DTYPE_CODE[cfg.dtype]]
    desc, statics = _device_tables(spec, packed.device)
    coeffs = (_pack_coeffs(spec, xs, cfg.products == "mma") if xs
              else torch.zeros(1, dtype=packed.dtype,  # static ops only
                               device=packed.device))
    out = torch.empty_like(packed)
    half = spec.tb * (1 << spec.n) * packed.element_size()
    tmp = tmp_re = tmp_im = None
    if cfg.instance == "global":  # the cluster keeps its scratch on chip
        tmp = torch.empty_like(packed)
        tmp_re, tmp_im = tmp.data_ptr(), tmp.data_ptr() + half
    bnd = bnd_re = bnd_im = None
    if with_boundaries:
        # (2, L, tb, R, 128): each part is the (L, tb, R, 128) block the
        # kernel writes; the caller sees the (L, 2, tb, R, 128) view.
        bnd = torch.empty((2, spec.length) + tuple(packed.shape[1:]),
                          dtype=packed.dtype, device=packed.device)
        bnd_re = bnd.data_ptr()
        bnd_im = bnd_re + spec.length * half
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    args = (
        packed.data_ptr(), packed.data_ptr() + half,
        out.data_ptr(), out.data_ptr() + half,
        tmp_re, tmp_im,
        bnd_re, bnd_im,
        desc.data_ptr(), len(spec.ops),
        coeffs.data_ptr(), statics.data_ptr(),
        spec.tb, spec.n, spec.length, packed.device.index or 0, stream,
        cfg.cluster if cfg.instance == "cluster" else 0, cfg.smem,
        _DTYPE_CODE[cfg.dtype],
    )
    return _Prepared(lib, args, (packed, desc, statics, coeffs, tmp), out,
                     bnd, cfg)


_ERR_CLUSTER_UNSCHEDULABLE = 100000  # csrc/scan_body.cu


def launch_error(err: int, cfg: LaunchConfig) -> str:
    """The message a refused launch raises with."""
    if err == _ERR_CLUSTER_UNSCHEDULABLE:
        return (f"scan_body: this card cannot co-schedule one cluster of "
                f"{cfg.cluster} CTAs with {cfg.smem} bytes of shared "
                f"memory each ({cfg.dtype} instance)")
    return f"scan_body kernel launch failed ({cfg}): CUDA error {err}"


def resident_clusters(cfg: LaunchConfig) -> int:
    """How many clusters of ``cfg`` the card keeps resident at once
    (cudaOccupancyMaxActiveClusters); ``tb`` clusters beyond it run in
    further waves."""
    code = _DTYPE_CODE[cfg.dtype]
    active = ctypes.c_int()
    err = load_kernel()[code].qfx_scan_body_max_clusters(
        cfg.cluster, cfg.smem, code, ctypes.byref(active))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters: CUDA error "
                           f"{err}")
    return active.value


def instance_attrs() -> dict:
    """Registers, local-memory (spill) bytes and static shared memory of
    each compiled instance, as the runtime reports them (bf16 instances
    under a ``_bf16`` suffix)."""
    libs = load_kernel()
    out = {}
    for sfx, code in (("", 0), ("_bf16", 1)):
        lib = libs[code]
        for name in ("global", "cluster"):
            cluster = int(name == "cluster")
            for bnd in (0, 1):
                vals = [ctypes.c_int() for _ in range(3)]
                err = lib.qfx_scan_body_attrs(
                    cluster, bnd, code, *(ctypes.byref(v) for v in vals))
                if err != 0:
                    raise RuntimeError(
                        f"cudaFuncGetAttributes: CUDA error {err}")
                out[f"{name}{'_bnd' if bnd else ''}{sfx}"] = {
                    "registers": vals[0].value,
                    "local_bytes": vals[1].value,
                    "static_smem": vals[2].value,
                }
    return out


def _launch(packed, spec, xs, with_boundaries: bool, key: str):
    global launch_count
    # The launch is asynchronous on the current stream. The temporaries
    # (coefficients, scratch) go back to PyTorch's caching allocator when
    # this function returns, which only hands their memory to work queued
    # later on the same stream — after this kernel.
    prep = prepare_launch(packed, spec, xs, with_boundaries)
    if torch.autograd.profiler._is_profiler_enabled:
        # Under a profiler (any thread's view of it: the per-thread flag
        # reads False when it records every thread) the launch is named
        # by its kind, so a capture tells A, B and C apart
        # (obs/profile.kernel_launches).
        with torch.profiler.record_function(f"scan_body.{key}"):
            err = prep.run()
    else:
        err = prep.run()
    if err != 0:
        raise RuntimeError(launch_error(err, prep.config))
    launch_count += 1
    launch_counts[key] += 1
    dtype_counts[spec.dtype] += 1
    if with_boundaries:
        return prep.out, prep.bnd.transpose(0, 1)
    return prep.out


def _rowpair_kernel_order(st: CArray, n: int, gate: CArray, q1: int,
                          q2: int) -> CArray:
    """A rowpair in the kernel's order: the four flip terms added one
    after another from zero, re and im interleaved, as the reference's
    Pallas ``_emit`` adds them. ``batched.apply_rowpair_b`` sums the real
    and imaginary coefficient parts apart; in bf16 every step rounds, so
    the two differ."""
    from qfedx_tpu_torch.ops import batched as bt

    b = st.re.shape[0]
    groups = bt._coeff_groups(b, gate, 4)
    gre, gim = bt._cast_parts(gate, st.re.dtype)
    rbits = n - _LANE_BITS
    a, c, e = 1 << q1, 1 << (q2 - q1 - 1), 1 << (rbits - q2 - 1)
    lead = (b * a,) if groups is None else (groups, (b // groups) * a)
    view = lead + (2, c, 2, e, _LANES)
    ax1, ax2 = len(lead), len(lead) + 2
    gshape = (groups or 1,) + (1,) * (len(lead) - 1) + (2, 1, 2, 1, 1)
    i, l = torch.meshgrid(torch.arange(2, device=gre.device),
                          torch.arange(2, device=gre.device), indexing="ij")

    def grids(part):
        return [part[..., i, l, i ^ dj, l ^ dk].reshape(gshape)
                for dj, dk in ((0, 0), (0, 1), (1, 0), (1, 1))]

    def flips(s):
        v = s.reshape(view)
        f1 = torch.flip(v, (ax1,))
        return v, torch.flip(v, (ax2,)), f1, torch.flip(f1, (ax2,))

    re_c = grids(gre)
    im_c = None if gim is None else grids(gim)
    fs_re, fs_im = flips(st.re), flips(st.imag_or_zeros())
    acc_re = acc_im = torch.zeros_like(fs_re[0])
    for d in range(4):
        acc_re = acc_re + re_c[d] * fs_re[d]
        acc_im = acc_im + re_c[d] * fs_im[d]
        if im_c is not None:
            acc_re = acc_re - im_c[d] * fs_im[d]
            acc_im = acc_im + im_c[d] * fs_re[d]
    shape = st.re.shape
    return CArray(acc_re.reshape(shape), acc_im.reshape(shape))


def _layer_exec(spec: _KernelSpec, packed: torch.Tensor, sliced,
                kernel_order: bool = False) -> torch.Tensor:
    """ONE layer of the body on a packed (2, tb, R, 128) state with the
    layer's coefficient slices — the reference's ``_layer_exec``: the scan
    route's own per-op executors (``fuse._exec_stacked``), so the plain
    sweep and the coefficient cotangents run the code the torch layer
    loop runs. ``kernel_order`` (the plain sweep) sums a rowpair's terms
    in the kernel's order instead (``_rowpair_kernel_order``): the one op
    whose executor rounds elsewhere in bf16 than the kernel (the
    reference's ``_emit``) does."""
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
        if kernel_order and op.kind == "rowpair":
            st = _rowpair_kernel_order(st, spec.n, coeffs, *op.qubits)
            continue
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
    """The kernel's plain PyTorch version: ``_layer_exec`` in the kernel's
    order looped over the L layers (with ``with_boundaries``, also the
    stacked layer-entry states, as ``scan_body`` returns them). In bf16
    every product accumulates in f32 and each op's result rounds to bf16
    where the kernel rounds it (torch's bf16 ops round every result)."""
    from qfedx_tpu_torch.ops import fuse

    bnds = []
    for layer in range(spec.length):
        if with_boundaries:
            bnds.append(packed)
        packed = _layer_exec(
            spec, packed, [fuse._cslice(c, layer) for c in xs],
            kernel_order=True,
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

"""On-card smoke of the PyTorch/CUDA port: build, check, serve, time.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. print the card's name and power limit; require CUDA;
2. build the scan-body kernel (``qfedx_tpu_torch/ops/csrc/scan_body.cu``)
   from the checkout's sources with nvcc, and print the build time;
3. hold the kernel against its plain PyTorch version on the card
   (``scan_body_plain``, same inputs, |err| ≤ KERNEL_ATOL): the all-kinds
   program (every op kind, all four CNOT placements) at n=12 and n=15 with
   G ∈ {1, 8}, a real-coefficient variant, and the HEA programs at n=12
   and n=15;
4. serve the slice — ``make_vqc_classifier(12, 3, 2)`` with seeded random
   weights behind ``ServeEngine(buckets=(1, 8, 32))`` and ``MicroBatcher``
   — for 256 requests; hold the logits against the same port on the CPU
   (|err| ≤ LOGIT_ATOL), require the kernel's launch count to rise during
   the run and its build count not to rise after warmup, and print p50/p95
   request latency; then, at each bucket's main-path inputs, hold the
   kernel against its plain version again and print both CUDA-event times,
   the bound and the served forward's host-clock time;
5. print one JSON line describing each kernel (launches on the main path,
   max error, times, bound);
6. print the final ``{"ok": true, "device": {...}}`` line.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

KERNEL_ATOL = 1e-5  # kernel vs plain, f32: same products, other sum order
LOGIT_ATOL = 2e-5  # served logits vs the CPU run (the reference's bound)
N_QUBITS, N_LAYERS, N_CLASSES = 12, 3, 2
BUCKETS = (1, 8, 32)
N_REQUESTS = 256
# H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


# --- programs ----------------------------------------------------------------


def kinds_program(n: int, length: int, groups, device, seed: int,
                  real: bool = False):
    """A stacked program exercising EVERY kernel emission and all four
    CNOT placements, with unitary (orthogonal when ``real``) coefficients
    so absolute tolerances keep their meaning."""
    from qfedx_tpu_torch.ops.cpx import CArray
    from qfedx_tpu_torch.ops.fuse import ScanProgram, StackedOp

    rng = np.random.default_rng(seed)
    r = 1 << (n - 7)
    g = () if groups is None else (groups,)

    def carray(re, im):
        t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
        return CArray(t(re), None if real else t(im))

    def unitary(shape):
        d = shape[-1]
        z = rng.normal(size=shape[:-2] + (d, d))
        if not real:
            z = z + 1j * rng.normal(size=shape[:-2] + (d, d))
        q, rr = np.linalg.qr(z)
        dg = np.diagonal(rr, axis1=-2, axis2=-1)
        q = q * (dg / np.abs(dg))[..., None, :]
        return carray(q.real, q.imag)

    def phases(shape):
        if real:
            return carray(rng.choice([-1.0, 1.0], size=shape), None)
        th = rng.uniform(-np.pi, np.pi, size=shape)
        return carray(np.cos(th), np.sin(th))

    def pair4(c):
        f = lambda x: x.reshape(x.shape[:-2] + (2, 2, 2, 2))  # noqa: E731
        return CArray(f(c.re), None if c.im is None else f(c.im))

    lead = (length,) + g
    body = (
        StackedOp("lane", (), unitary(lead + (128, 128)), True),
        StackedOp("mask", (), phases(lead + (1 << n,)), True),
        StackedOp("growmat", (n - 2,), unitary(lead + (2, r, r)), True),
        StackedOp("rowpair", (0, 2), pair4(unitary(lead + (4, 4))), True),
        StackedOp("rowperm", (), rng.permutation(r), False),
        StackedOp("glane", (1,), unitary(lead + (2, 128, 128)), True),
        StackedOp("rowmat", (), unitary(lead + (r, r)), True),
        StackedOp("cnot", (0, 1), None, False),          # row-row
        StackedOp("cnot", (n - 5, n - 2), None, False),  # lane-lane
        StackedOp("cnot", (2, n - 1), None, False),      # row ctrl, lane tgt
        StackedOp("cnot", (n - 1, 2), None, False),      # lane ctrl, row tgt
    )
    return ScanProgram((), body, length)


def hea_program(n: int, length: int, rx, rz):
    from qfedx_tpu_torch.circuits.ansatz import hea_scan_ops
    from qfedx_tpu_torch.ops import fuse

    return fuse.fuse_ops_stacked(hea_scan_ops(n, rx, rz), n, length)


def random_state(n: int, tb: int, device, seed: int):
    from qfedx_tpu_torch.ops.cpx import CArray

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(tb, 1 << n)) + 1j * rng.normal(size=(tb, 1 << n))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    return CArray(t(x.real), t(x.imag))


def kernel_inputs(state, n: int, program):
    """What ``apply_scan_pallas`` hands the wrapper: pre-ops applied, the
    packed (2, tb, R, 128) state, the spec and the stacked coefficients."""
    from qfedx_tpu_torch.ops import fuse, scan_body
    from qfedx_tpu_torch.ops.cpx import CArray

    state = CArray(state.re, state.imag_or_zeros())
    for op in program.pre:
        state = fuse._exec_stacked(state, n, op, True)
    assert scan_body.route_ok(state, n, program, True), program
    spec = scan_body._build_spec(state, n, program, True)
    xs = tuple(op.coeffs for op in program.body if op.stacked)
    r = 1 << (n - 7)
    packed = torch.stack([
        state.re.reshape(spec.tb, r, 128), state.im.reshape(spec.tb, r, 128)
    ]).contiguous()
    return packed, spec, xs


def sweep_work(spec, xs) -> tuple[float, float]:
    """(FLOP, bytes) one sweep needs: every useful f32 product and sum of
    the op sequence (a glane/growmat counts only the branch each row or
    lane selects; gathers and CNOTs are free), and each input byte read
    once plus each output byte written once."""
    r = 1 << (spec.n - 7)
    size = r * 128
    per_layer = 0
    for op in spec.ops:
        mac = 8 if op.has_im else 4  # complex state × complex/real coeff
        if op.kind in ("lane", "glane"):
            per_layer += mac * size * 128
        elif op.kind in ("rowmat", "growmat"):
            per_layer += mac * size * r
        elif op.kind == "mask":
            per_layer += (6 if op.has_im else 2) * size
        elif op.kind == "rowpair":
            per_layer += 4 * mac * size
    flops = float(per_layer) * spec.length * spec.tb
    state_bytes = 2 * spec.tb * size * 4
    coeff_bytes = sum(p.numel() * 4 for c in xs for p in c if p is not None)
    perm_bytes = sum(len(op.perm) * 4 for op in spec.ops if op.perm)
    return flops, float(2 * state_bytes + coeff_bytes + perm_bytes)


def bound_ms(spec, xs) -> tuple[float, str]:
    flops, nbytes = sweep_work(spec, xs)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def event_ms(fn, iters: int = 100, warm: int = 5) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --- phases ------------------------------------------------------------------


def phase_build() -> float:
    from qfedx_tpu_torch.ops import scan_body

    t0 = time.perf_counter()
    scan_body.load_kernel()
    secs = time.perf_counter() - t0
    print(f"[build] scan_body.cu built and loaded in {secs:.2f} s "
          f"(build_count={scan_body.build_count})")
    for line in scan_body.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")
    return secs


def phase_kernel_parity(device) -> float:
    from qfedx_tpu_torch.ops import scan_body

    cases = []
    for n in (12, 15):
        for groups in (None, 8):
            cases.append((f"all-kinds n={n} G={groups or 1}", n,
                          kinds_program(n, 3, groups, device, seed=n)))
    cases.append(("all-kinds real n=12 G=1", 12,
                  kinds_program(12, 3, None, device, seed=3, real=True)))
    rng = np.random.default_rng(7)
    for n in (12, 15):
        rx, rz = (torch.as_tensor(rng.uniform(-2, 2, (3, n)),
                                  dtype=torch.float32, device=device)
                  for _ in range(2))
        cases.append((f"hea n={n} L=3", n, hea_program(n, 3, rx, rz)))
    worst = 0.0
    for i, (name, n, program) in enumerate(cases):
        packed, spec, xs = kernel_inputs(
            random_state(n, 8, device, seed=100 + i), n, program
        )
        with torch.no_grad():
            got = scan_body.scan_body(packed, spec, xs)
            torch.cuda.synchronize()
            want = scan_body.scan_body_plain(packed, spec, xs)
            torch.cuda.synchronize()
        err = float((got - want).abs().max())
        kinds = ",".join(op.kind for op in spec.ops)
        print(f"[parity] {name} tb=8 body=[{kinds}] max|kernel-plain|="
              f"{err:.3e} (atol {KERNEL_ATOL:g})")
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"kernel disagrees with plain on {name}: "
                                 f"{err:.3e} > {KERNEL_ATOL:g}")
        worst = max(worst, err)
    return worst


def phase_serve(device) -> dict:
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.serve import MicroBatcher, ServeConfig, ServeEngine

    model = make_vqc_classifier(N_QUBITS, N_LAYERS, N_CLASSES,
                                init_scale=1.0)
    params = model.init(0)
    engine = ServeEngine(
        model, params, (N_QUBITS,),
        config=ServeConfig(buckets=BUCKETS, deadline_ms=2.0, max_queue=512),
    )
    warm = engine.warmup()
    print(f"[serve] warmup: {json.dumps(warm, default=str)}")
    builds_after_warmup = scan_body.build_count
    x = np.random.default_rng(11).uniform(0, 1, (N_REQUESTS, N_QUBITS))
    x = x.astype(np.float32)

    scan_body.launch_count = 0
    batcher = MicroBatcher(engine).start()
    futures = []
    # Waves of 1, 5 and 250 requests: each bucket serves on the main path.
    for lo, hi in ((0, 1), (1, 6), (6, N_REQUESTS)):
        wave = [batcher.submit(x[i]) for i in range(lo, hi)]
        for f in wave:
            f.result(timeout=60)
        futures += wave
    batcher.close(drain=True)
    launches = scan_body.launch_count
    builds = scan_body.build_count

    logits = np.stack([f.result()["logits"] for f in futures])
    lat_ms = np.array([(f.done_t - f.submit_t) * 1e3 for f in futures])
    print(f"[serve] {N_REQUESTS} requests, batches={batcher.stats['batches']}"
          f" full={batcher.stats['full_flushes']} deadline="
          f"{batcher.stats['deadline_flushes']}, kernel launches={launches},"
          f" builds after warmup={builds - builds_after_warmup}")
    print(f"[serve] latency p50={np.percentile(lat_ms, 50):.4f} ms "
          f"p95={np.percentile(lat_ms, 95):.4f} ms")
    if launches < batcher.stats["batches"] or launches == 0:
        raise AssertionError(f"main path ran {launches} kernel launches for "
                             f"{batcher.stats['batches']} batches")
    if builds != builds_after_warmup:
        raise AssertionError("the kernel library was built after warmup")

    cpu_model = make_vqc_classifier(N_QUBITS, N_LAYERS, N_CLASSES,
                                    init_scale=1.0, device="cpu")
    cpu_params = {g: {k: v.cpu() for k, v in d.items()}
                  for g, d in params.items()}
    with torch.no_grad():
        ref = cpu_model.apply(cpu_params, x).numpy()
    if logits.shape != (N_REQUESTS, N_CLASSES) or not np.isfinite(
        logits
    ).all():
        raise AssertionError(f"bad logits: shape {logits.shape}")
    err = float(np.abs(logits - ref).max())
    print(f"[serve] logits max|card-cpu|={err:.3e} (atol {LOGIT_ATOL:g})")
    if not err <= LOGIT_ATOL:
        raise AssertionError(f"served logits disagree with the CPU run: "
                             f"{err:.3e}")
    return {"launches": launches, "engine": engine, "logit_err": err}


def phase_times(device, engine) -> dict:
    """Kernel vs plain (agreement, then CUDA-event times) at each bucket's
    main-path inputs (the n=12 L=3 HEA sweep), with the bound, beside the
    host-clock
    time of the whole served forward (``ServeEngine._forward``: program
    build, encoder, kernel, readout, device→host fetch)."""
    from qfedx_tpu_torch.circuits.encoders import angle_amplitudes
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.ops.batched import bstate_product_tree

    params = engine.params
    program = hea_program(N_QUBITS, N_LAYERS, params["ansatz"]["rx"],
                          params["ansatz"]["rz"])
    rows = {}
    for b in BUCKETS:
        x = torch.as_tensor(
            np.random.default_rng(b).uniform(0, 1, (b, N_QUBITS)),
            dtype=torch.float32, device=device,
        )
        state = bstate_product_tree(angle_amplitudes(x * math.pi))
        packed, spec, xs = kernel_inputs(state, N_QUBITS, program)
        saved = scan_body.launch_count
        with torch.no_grad():
            got = scan_body.scan_body(packed, spec, xs)
            torch.cuda.synchronize()
            want = scan_body.scan_body_plain(packed, spec, xs)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not err <= KERNEL_ATOL:
                raise AssertionError(f"kernel disagrees with plain at bucket "
                                     f"{b}: {err:.3e} > {KERNEL_ATOL:g}")
            ms = event_ms(lambda: scan_body.scan_body(packed, spec, xs))
            plain = event_ms(
                lambda: scan_body.scan_body_plain(packed, spec, xs), iters=20
            )
        xb = x.cpu().numpy()
        engine._forward(xb)
        t0 = time.perf_counter()
        for _ in range(20):
            engine._forward(xb)
        fwd_ms = (time.perf_counter() - t0) / 20 * 1e3
        scan_body.launch_count = saved
        bms, by = bound_ms(spec, xs)
        flops, nbytes = sweep_work(spec, xs)
        rows[b] = {"ms": ms, "plain_ms": plain, "bound_ms": bms,
                   "bound_by": by, "flops": flops, "bytes": nbytes,
                   "forward_ms": fwd_ms, "max_abs_err": err}
        print(f"[time] bucket {b}: max|kernel-plain|={err:.3e}, "
              f"kernel {ms:.5f} ms, plain {plain:.5f} ms,"
              f" bound {bms:.5f} ms ({by}; {flops:.4g} FLOP, "
              f"{nbytes:.4g} B), served forward {fwd_ms:.4f} ms (host "
              f"clock), body=[{','.join(op.kind for op in spec.ops)}]")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    import qfedx_tpu_torch  # noqa: F401 — fails alone, outside the checkout

    phase_build()
    worst = phase_kernel_parity(device)
    served = phase_serve(device)
    times = phase_times(device, served["engine"])
    main_row = times[BUCKETS[-1]]
    kernels = {"kernels": [{
        "name": "scan_body",
        "route": "cuda",
        "source": "qfedx_tpu_torch/ops/csrc/scan_body.cu",
        "replaces": "qfedx_tpu/ops/pallas_body.py:401",
        "launches": served["launches"],
        "max_abs_err": max([worst] + [r["max_abs_err"]
                                      for r in times.values()]),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": None,
    }]}
    print(card_line())
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

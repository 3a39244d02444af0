"""On-card smoke of the PyTorch/CUDA port: build, check, serve, train, time.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. print the card's name and power limit; require CUDA;
2. build the scan-body kernel (``qfedx_tpu_torch/ops/csrc/scan_body.cu``)
   from the checkout's sources with nvcc, and print the build time;
3. hold the kernel's three launches against their plain PyTorch versions
   on the card (same inputs, |err| ≤ KERNEL_ATOL) on seven programs — the
   all-kinds program (every op kind, all four CNOT placements) at n=12 and
   n=15 with G ∈ {1, 8}, a real-coefficient variant, and the HEA programs
   at n=12 and n=15: Launch A (the forward), Launch B (final state and
   every layer-entry boundary) and Launch C (the sweep over the adjointed
   program with a cotangent as the state, and its boundaries);
4. on the same programs, hold ``ScanBodyFn``'s state and coefficient
   cotangents (Launches B and C inside) against torch autograd straight
   through ``scan_body_plain`` on the card (|err| ≤ GRAD_ATOL);
5. serve the slice — ``make_vqc_classifier(12, 3, 2)`` with seeded random
   weights behind ``ServeEngine(buckets=(1, 8, 32))`` and ``MicroBatcher``
   — for 256 requests; hold the logits against the same port on the CPU
   (|err| ≤ LOGIT_ATOL), require Launch A to run at least once per batch
   (and B and C never) and the build count not to rise after warmup, and
   print p50/p95 request latency; then, at each bucket's main-path inputs,
   hold the kernel against its plain version again and print both
   CUDA-event times, the bound and the served forward's host-clock time;
6. train the slice — 3 federated rounds of ``fed.round.make_fed_round``
   with the same model and bench.py's fed16q federation shape (2 clients ×
   64 seeded samples, batch 16, 1 local epoch, Adam lr 0.1) — and the same
   rounds with the same shuffles on the CPU port: per-round mean loss
   within LOSS_ATOL, the trained logits on a held-out batch within
   TRAINED_LOGIT_ATOL, exactly 4 Launch-B and 4 Launch-C launches and no
   Launch A per round, no build after the first round; print each round's
   host-clock wall time and client-rounds/s; then, at the training shape
   (tb = 32, G = 2), print Launch B's and Launch C's CUDA-event times beside
   their plain versions and bounds, and the time of the torch
   coefficient-cotangent part;
7. print one JSON line describing each launch of the kernel (launches on
   its main path, max error, times, bound);
8. print the final ``{"ok": true, "device": {...}}`` line.
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
GRAD_ATOL = 2e-5  # cotangents vs plain autograd (the reference's bound)
LOGIT_ATOL = 2e-5  # served logits vs the CPU run (the reference's bound)
LOSS_ATOL = 1e-5  # per-round mean loss, card vs the CPU port
TRAINED_LOGIT_ATOL = 1e-4  # logits after 3 Adam rounds, card vs CPU
N_QUBITS, N_LAYERS, N_CLASSES = 12, 3, 2
BUCKETS = (1, 8, 32)
N_REQUESTS = 256
# bench.py's fed16q federation shape (at the kernel's width, n=12).
FED_CLIENTS, FED_SAMPLES, FED_BATCH, FED_EPOCHS, FED_ROUNDS = 2, 64, 16, 1, 3
STEPS_PER_ROUND = FED_EPOCHS * FED_SAMPLES // FED_BATCH
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


def sweep_work(spec, xs, with_boundaries: bool = False
               ) -> tuple[float, float]:
    """(FLOP, bytes) one sweep needs: every useful f32 product and sum of
    the op sequence (a glane/growmat counts only the branch each row or
    lane selects; gathers and CNOTs are free), and each input byte read
    once plus each output byte written once — with boundaries, the L
    layer-entry states written too."""
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
    bnd_bytes = spec.length * state_bytes if with_boundaries else 0
    return flops, float(2 * state_bytes + coeff_bytes + perm_bytes
                        + bnd_bytes)


def bound_ms(spec, xs, with_boundaries: bool = False) -> tuple[float, str]:
    flops, nbytes = sweep_work(spec, xs, with_boundaries)
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


def parity_programs(device) -> list:
    """The seven (name, n, program) cases the kernel is held on."""
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
    return cases


def _max_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def _require(err: float, atol: float, what: str) -> None:
    if not err <= atol:
        raise AssertionError(f"{what}: {err:.3e} > {atol:g}")


def phase_kernel_parity(device) -> dict:
    """Launches A, B and C against their plain versions; returns the
    worst error of each."""
    from qfedx_tpu_torch.ops import scan_body

    worst = {"A": 0.0, "B": 0.0, "C": 0.0}
    for i, (name, n, program) in enumerate(parity_programs(device)):
        packed, spec, xs = kernel_inputs(
            random_state(n, 8, device, seed=100 + i), n, program
        )
        aspec = scan_body._adjoint_spec(spec)
        axs = scan_body._adjoint_xs(spec, xs)
        cot = random_state(n, 8, device, seed=200 + i)
        cot = torch.stack([cot.re, cot.im]).reshape(packed.shape)
        with torch.no_grad():
            errs = {
                "A": _max_err([scan_body.scan_body(packed, spec, xs)],
                              [scan_body.scan_body_plain(packed, spec, xs)]),
                "B": _max_err(
                    scan_body.scan_body(packed, spec, xs,
                                        with_boundaries=True),
                    scan_body.scan_body_plain(packed, spec, xs, True)),
                "C": _max_err(
                    scan_body.scan_body(cot, aspec, axs,
                                        with_boundaries=True, adjoint=True),
                    scan_body.scan_body_plain(cot, aspec, axs, True)),
            }
            torch.cuda.synchronize()
        kinds = ",".join(op.kind for op in spec.ops)
        print(f"[parity] {name} tb=8 body=[{kinds}] max|kernel-plain|: "
              f"A {errs['A']:.3e}, B (final+boundaries) {errs['B']:.3e}, "
              f"C (adjoint+boundaries) {errs['C']:.3e} "
              f"(atol {KERNEL_ATOL:g})")
        for launch, err in errs.items():
            _require(err, KERNEL_ATOL,
                     f"Launch {launch} disagrees with plain on {name}")
            worst[launch] = max(worst[launch], err)
    return worst


def _cotangents(spec, packed, xs, w, through: str) -> list:
    """Cotangents of Σ w·out² w.r.t. the packed state and every flat
    coefficient: through ``ScanBodyFn`` (the kernel) or straight through
    ``scan_body_plain``'s autograd."""
    from qfedx_tpu_torch.ops import scan_body

    state = packed.clone().requires_grad_(True)
    flat = [p.clone().requires_grad_(True) for p in scan_body._flatten(xs)]
    if through == "kernel":
        out = scan_body.ScanBodyFn.apply(spec, state, *flat)
    else:
        out = scan_body.scan_body_plain(state, spec,
                                        scan_body._unflatten(spec, flat))
    return list(torch.autograd.grad((w * out**2).sum(), [state] + flat))


def phase_grad_parity(device) -> float:
    from qfedx_tpu_torch.ops import scan_body

    worst = 0.0
    for i, (name, n, program) in enumerate(parity_programs(device)):
        packed, spec, xs = kernel_inputs(
            random_state(n, 8, device, seed=300 + i), n, program
        )
        w = torch.as_tensor(
            np.random.default_rng(400 + i).normal(size=tuple(packed.shape)),
            dtype=torch.float32, device=device,
        )
        before = dict(scan_body.launch_counts)
        got = _cotangents(spec, packed, xs, w, "kernel")
        launched = {k: scan_body.launch_counts[k] - before[k]
                    for k in before}
        want = _cotangents(spec, packed, xs, w, "plain")
        torch.cuda.synchronize()
        err_state = float((got[0] - want[0]).abs().max())
        err_coeff = _max_err(got[1:], want[1:])
        print(f"[grad] {name} tb=8: max|kernel-plain| state cotangent "
              f"{err_state:.3e}, coefficient cotangents {err_coeff:.3e} "
              f"(atol {GRAD_ATOL:g}), launches {launched}")
        if launched != {"fwd": 0, "fwd_bnd": 1, "adj": 1}:
            raise AssertionError(f"ScanBodyFn on {name} launched {launched}")
        _require(max(err_state, err_coeff), GRAD_ATOL,
                 f"kernel gradients disagree with plain autograd on {name}")
        worst = max(worst, err_state, err_coeff)
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

    scan_body.reset_counts()
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
    by_launch = dict(scan_body.launch_counts)
    builds = scan_body.build_count

    logits = np.stack([f.result()["logits"] for f in futures])
    lat_ms = np.array([(f.done_t - f.submit_t) * 1e3 for f in futures])
    print(f"[serve] {N_REQUESTS} requests, batches={batcher.stats['batches']}"
          f" full={batcher.stats['full_flushes']} deadline="
          f"{batcher.stats['deadline_flushes']}, kernel launches={launches}"
          f" {by_launch}, builds after warmup={builds - builds_after_warmup}")
    print(f"[serve] latency p50={np.percentile(lat_ms, 50):.4f} ms "
          f"p95={np.percentile(lat_ms, 95):.4f} ms")
    if launches < batcher.stats["batches"] or launches == 0:
        raise AssertionError(f"main path ran {launches} kernel launches for "
                             f"{batcher.stats['batches']} batches")
    if by_launch["fwd"] != launches:
        raise AssertionError(f"serving ran launches other than A: "
                             f"{by_launch}")
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


def fed_data():
    rng = np.random.default_rng(0)
    cx = rng.uniform(0, 1, (FED_CLIENTS, FED_SAMPLES, N_QUBITS))
    cy = rng.integers(0, 2, (FED_CLIENTS, FED_SAMPLES))
    cm = np.ones((FED_CLIENTS, FED_SAMPLES))
    return (cx.astype(np.float32), cy.astype(np.int64),
            cm.astype(np.float32))


def phase_train(device) -> dict:
    """3 federated rounds on the card and the same rounds on the CPU
    port (same weights, data and shuffles)."""
    from qfedx_tpu_torch.fed.client import draw_perms
    from qfedx_tpu_torch.fed.config import FedConfig
    from qfedx_tpu_torch.fed.round import make_fed_round
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.ops import scan_body

    cfg = FedConfig(local_epochs=FED_EPOCHS, batch_size=FED_BATCH,
                    learning_rate=0.1, optimizer="adam")
    model = make_vqc_classifier(N_QUBITS, N_LAYERS, N_CLASSES)
    cpu_model = make_vqc_classifier(N_QUBITS, N_LAYERS, N_CLASSES,
                                    device="cpu")
    params = model.init(0)
    cpu_params = {g: {k: v.cpu() for k, v in d.items()}
                  for g, d in params.items()}
    round_fn = make_fed_round(model, cfg, num_clients=FED_CLIENTS)
    cpu_round_fn = make_fed_round(cpu_model, cfg, num_clients=FED_CLIENTS)
    data = fed_data()
    on_card = [torch.as_tensor(a, device=device) for a in data]
    on_cpu = [torch.as_tensor(a) for a in data]

    rounds, launches = [], {"fwd": 0, "fwd_bnd": 0, "adj": 0}
    builds0 = None
    for r in range(FED_ROUNDS):
        perms = draw_perms(torch.Generator().manual_seed(r), FED_CLIENTS,
                           FED_EPOCHS, FED_SAMPLES)
        scan_body.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, stats = round_fn(params, *on_card, perms=perms)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(scan_body.launch_counts)
        for k in launches:
            launches[k] += counts[k]
        if builds0 is None:
            builds0 = scan_body.build_count
        cpu_params, cpu_stats = cpu_round_fn(cpu_params, *on_cpu,
                                             perms=perms)
        loss, cpu_loss = float(stats.mean_loss), float(cpu_stats.mean_loss)
        err = abs(loss - cpu_loss)
        rounds.append({"wall_s": wall, "loss_err": err, "counts": counts})
        print(f"[train] round {r}: mean_loss card {loss!r} cpu {cpu_loss!r}"
              f" |err|={err:.3e} (atol {LOSS_ATOL:g}), total_weight "
              f"{float(stats.total_weight)!r}, launches {counts}, wall "
              f"{wall * 1e3:.4f} ms (host clock, synchronised), "
              f"{FED_CLIENTS / wall:.4f} client-rounds/s")
        _require(err, LOSS_ATOL, f"round {r} mean loss, card vs cpu")
        want = {"fwd": 0, "fwd_bnd": STEPS_PER_ROUND, "adj": STEPS_PER_ROUND}
        if counts != want:
            raise AssertionError(f"round {r} launched {counts}, expected "
                                 f"{want}")
        if not (math.isfinite(loss)
                and float(stats.total_weight) == FED_CLIENTS * FED_SAMPLES):
            raise AssertionError(f"round {r}: bad stats {stats}")
    if scan_body.build_count != builds0:
        raise AssertionError("the kernel library was built after round 0")

    held = np.random.default_rng(5).uniform(0, 1, (32, N_QUBITS))
    held = held.astype(np.float32)
    with torch.no_grad():
        logits = model.apply(params, held).cpu().numpy()
        cpu_logits = cpu_model.apply(cpu_params, held).numpy()
    if logits.shape != (32, N_CLASSES) or not np.isfinite(logits).all():
        raise AssertionError(f"bad trained logits: shape {logits.shape}")
    logit_err = float(np.abs(logits - cpu_logits).max())
    print(f"[train] trained logits on a held-out batch of 32: "
          f"max|card-cpu|={logit_err:.3e} (atol {TRAINED_LOGIT_ATOL:g})")
    _require(logit_err, TRAINED_LOGIT_ATOL, "trained logits, card vs cpu")
    walls = [r["wall_s"] for r in rounds]
    steady = walls[1:] or walls  # round 0 also builds the kernel library
    print(f"[train] {FED_ROUNDS} rounds x {STEPS_PER_ROUND} local steps: "
          f"wall per round {[w * 1e3 for w in walls]} ms, client-rounds/s "
          f"after round 0 {FED_CLIENTS * len(steady) / sum(steady):.4f}")
    return {"launches": launches, "params": params, "model": model,
            "logit_err": logit_err,
            "loss_err": max(r["loss_err"] for r in rounds)}


def phase_train_times(device, trained: dict) -> dict:
    """Launches B and C at the training shape (one local step's inputs:
    C·B = 32 state blocks, G = 2 client groups) against their plain
    versions and bounds, and the coefficient-cotangent part's time."""
    from qfedx_tpu_torch.circuits.ansatz import hea_scan_ops
    from qfedx_tpu_torch.circuits.encoders import angle_amplitudes
    from qfedx_tpu_torch.ops import fuse, scan_body
    from qfedx_tpu_torch.ops.batched import bstate_product_tree

    a = trained["params"]["ansatz"]
    rng = np.random.default_rng(13)
    rx, rz = (
        (v[None] + torch.as_tensor(
            0.1 * rng.normal(size=(FED_CLIENTS,) + tuple(v.shape)),
            dtype=torch.float32, device=device)).movedim(0, 1)
        for v in (a["rx"], a["rz"])
    )
    program = fuse.fuse_ops_stacked(hea_scan_ops(N_QUBITS, rx, rz),
                                    N_QUBITS, N_LAYERS)
    x = torch.as_tensor(fed_data()[0][:, :FED_BATCH], device=device)
    state = bstate_product_tree(
        angle_amplitudes(x.reshape(-1, N_QUBITS) * math.pi))
    packed, spec, xs = kernel_inputs(state, N_QUBITS, program)
    aspec = scan_body._adjoint_spec(spec)
    axs = scan_body._adjoint_xs(spec, xs)
    cot = random_state(N_QUBITS, spec.tb, device, seed=14)
    cot = torch.stack([cot.re, cot.im]).reshape(packed.shape)
    rows = {}
    with torch.no_grad():
        b_err = _max_err(
            scan_body.scan_body(packed, spec, xs, with_boundaries=True),
            scan_body.scan_body_plain(packed, spec, xs, True))
        c_out = scan_body.scan_body(cot, aspec, axs, with_boundaries=True,
                                    adjoint=True)
        c_err = _max_err(c_out, scan_body.scan_body_plain(cot, aspec, axs,
                                                          True))
        for launch, err in (("B", b_err), ("C", c_err)):
            _require(err, KERNEL_ATOL, f"Launch {launch} at the training "
                     "shape disagrees with plain")
        ms_b = event_ms(lambda: scan_body.scan_body(
            packed, spec, xs, with_boundaries=True))
        plain_b = event_ms(lambda: scan_body.scan_body_plain(
            packed, spec, xs, True), iters=20)
        ms_c = event_ms(lambda: scan_body.scan_body(
            cot, aspec, axs, with_boundaries=True, adjoint=True))
        plain_c = event_ms(lambda: scan_body.scan_body_plain(
            cot, aspec, axs, True), iters=20)
        _, bnd = scan_body.scan_body(packed, spec, xs, with_boundaries=True)
    flat = scan_body._flatten(xs)
    need = (True,) * len(flat)
    c_flip = torch.flip(c_out[1], (0,))
    cotan_ms = event_ms(lambda: scan_body._coeff_cotangents(
        spec, bnd, flat, c_flip, need), iters=20)
    flops, nbytes = sweep_work(spec, xs, with_boundaries=True)
    bms, by = bound_ms(spec, xs, with_boundaries=True)
    kinds = ",".join(op.kind for op in spec.ops)
    for launch, ms, plain, err in (("B", ms_b, plain_b, b_err),
                                   ("C", ms_c, plain_c, c_err)):
        rows[launch] = {"ms": ms, "plain_ms": plain, "bound_ms": bms,
                        "bound_by": by, "max_abs_err": err}
        print(f"[time] Launch {launch} at the training shape (tb="
              f"{spec.tb}, G={spec.ops[0].groups}, body=[{kinds}]): "
              f"max|kernel-plain|={err:.3e}, kernel {ms:.5f} ms, plain "
              f"{plain:.5f} ms, bound {bms:.5f} ms ({by}; {flops:.4g} FLOP, "
              f"{nbytes:.4g} B with {spec.length} boundary states)")
    print(f"[time] coefficient cotangents (torch autograd of one layer per "
          f"layer over the boundaries) at the training shape: "
          f"{cotan_ms:.5f} ms (CUDA events)")
    rows["cotangent_ms"] = cotan_ms
    rows["step"] = local_step_split(device, trained, rx, rz)
    return rows


def local_step_split(device, trained: dict, rx, rz, iters: int = 10
                     ) -> dict:
    """One local step of the training slice split on the host clock
    (synchronised): the forward (program build, encoder, Launch B,
    readout, loss), the backward (Launch C, coefficient cotangents,
    autograd of the program build) and the optimizer update."""
    from qfedx_tpu_torch.fed.client import _cross_entropy, make_optimizer
    from qfedx_tpu_torch.fed.config import FedConfig

    model = trained["model"]
    leaves = {
        "ansatz": {"rx": rx.movedim(0, 1).contiguous(),
                   "rz": rz.movedim(0, 1).contiguous()},
        "readout": {k: v[None].repeat(FED_CLIENTS, 1)
                    for k, v in trained["params"]["readout"].items()},
    }
    cx, cy, _ = fed_data()
    xb = torch.as_tensor(cx[:, :FED_BATCH], device=device)
    yb = torch.as_tensor(cy[:, :FED_BATCH], device=device)
    opt = make_optimizer(FedConfig(optimizer="adam", learning_rate=0.1))
    state = opt.init(leaves)
    parts = {"forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    for i in range(iters + 1):
        p = {g: {k: v.detach().requires_grad_(True) for k, v in d.items()}
             for g, d in leaves.items()}
        flat = [p[g][k] for g in sorted(p) for k in sorted(p[g])]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = _cross_entropy(model.apply_clients(p, xb), yb).mean(1).sum()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(loss, flat)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        it = iter(grads)
        with torch.no_grad():
            g = {gk: {k: next(it) for k in sorted(p[gk])} for gk in sorted(p)}
            _, state = opt.update(g, state)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if i:  # the first step warms the allocator
            parts["forward"] += (t1 - t0) / iters * 1e3
            parts["backward"] += (t2 - t1) / iters * 1e3
            parts["optimizer"] += (t3 - t2) / iters * 1e3
    print(f"[time] one local step at the training shape (host clock, "
          f"synchronised, mean of {iters}): forward {parts['forward']:.4f} "
          f"ms, backward {parts['backward']:.4f} ms, optimizer "
          f"{parts['optimizer']:.4f} ms")
    return parts


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
    grad_err = phase_grad_parity(device)
    served = phase_serve(device)
    times = phase_times(device, served["engine"])
    trained = phase_train(device)
    train_times = phase_train_times(device, trained)
    main_row = times[BUCKETS[-1]]
    source = "qfedx_tpu_torch/ops/csrc/scan_body.cu"
    kernel = "qfedx_tpu/ops/pallas_body.py:401"
    kernels = {"kernels": [
        {
            "name": "scan_body Launch A (forward)",
            "route": "cuda",
            "source": source,
            "replaces": f"{kernel} via _run :491 from _pallas_scan :618",
            "launches": served["launches"],
            "max_abs_err": max([worst["A"]] + [r["max_abs_err"]
                                               for r in times.values()]),
            "ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": None,
        },
        {
            "name": "scan_body Launch B (forward with boundaries)",
            "route": "cuda",
            "source": source,
            "replaces": f"{kernel} via _run :491 from _pallas_scan_fwd :624",
            "launches": trained["launches"]["fwd_bnd"],
            "max_abs_err": max(worst["B"], train_times["B"]["max_abs_err"]),
            **{k: train_times["B"][k]
               for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
        },
        {
            "name": "scan_body Launch C (adjoint sweep)",
            "route": "cuda",
            "source": source,
            "replaces": f"{kernel} via _run :491 from _pallas_scan_bwd :629",
            "launches": trained["launches"]["adj"],
            "max_abs_err": max(worst["C"], train_times["C"]["max_abs_err"]),
            **{k: train_times["C"][k]
               for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
            "library_ms": None,
        },
    ]}
    print(f"[summary] gradient max|kernel-plain| {grad_err:.3e}; trained "
          f"logits max|card-cpu| {trained['logit_err']:.3e}; round loss "
          f"max|card-cpu| {trained['loss_err']:.3e}")
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

"""On-card smoke of the PyTorch/CUDA port: build, check, serve, train, time.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. print the card's name and power limit; require CUDA;
2. build the scan-body kernel (``qfedx_tpu_torch/ops/csrc/scan_body.cu``
   and its headers) from the checkout's sources with nvcc, and print the
   build time and each instance's registers, local memory and static
   shared memory;
3. hold the kernel's three launches against their plain PyTorch versions
   on the card (same inputs, |err| ≤ KERNEL_ATOL) on seven programs at
   tb=8 — the all-kinds program (every op kind, all four CNOT placements)
   at n=12 and n=15 with G ∈ {1, 8}, a real-coefficient variant, and the
   HEA programs at n=12 and n=15 — and on seven width/tb cases (tb=1, 16
   and 32; n=17, the widest width the cluster instance takes, and n=18,
   which takes the global-memory one), each line naming the instance, K,
   CTAs, shared memory and resident clusters that ran: Launch A (the
   forward), Launch B (final state and every layer-entry boundary) and
   Launch C (the sweep over the adjointed program with a cotangent as the
   state, and its boundaries);
4. on the same programs, hold ``ScanBodyFn``'s state and coefficient
   cotangents (Launches B and C inside) against torch autograd straight
   through ``scan_body_plain`` on the card (|err| ≤ GRAD_ATOL);
5. serve the slice — ``make_vqc_classifier(12, 3, 2)`` with seeded random
   weights behind ``ServeEngine(buckets=(1, 8, 32))`` and ``MicroBatcher``
   — for 256 requests; hold the logits against the same port on the CPU
   (|err| ≤ LOGIT_ATOL), require Launch A to run at least once per batch
   (and B and C never) and the build count not to rise after warmup, and
   print p50/p95 request latency; then, at each bucket's main-path inputs,
   hold the kernel against its plain version again (on the cluster
   instance) and print the kernel's own CUDA-event time (raw launches of
   one prepared launch), the whole wrapper call's, the plain version's,
   the bound and the served forward's host-clock time, and the kernel's
   time on the served body cut to one kind at a time;
6. train the slice — 3 federated rounds of ``fed.round.make_fed_round``
   with the same model and bench.py's fed16q federation shape (2 clients ×
   64 seeded samples, batch 16, 1 local epoch, Adam lr 0.1) — and the same
   rounds with the same shuffles on the CPU port: per-round mean loss
   within LOSS_ATOL, the trained logits on a held-out batch within
   TRAINED_LOGIT_ATOL, exactly 4 Launch-B and 4 Launch-C launches and no
   Launch A per round, no build after the first round; print each round's
   host-clock wall time and client-rounds/s; then, at the training shape
   (tb = 32, G = 2), print Launch B's and Launch C's CUDA-event times
   (kernel alone and wrapper call) beside their plain versions and
   bounds, and the time of the torch coefficient-cotangent part;
7. at the trainer's shapes — the evaluator's tb = 256 (Launch A), the
   folded local step's tb = 128 with G = 4 (Launches B and C), and the
   in-chunk evaluation's tb (Launch A at the CLI run's validation set and
   at the trainer's cap of 2048), where ``_launch_config`` takes clusters
   of ONE CTA and the card runs the grid in one to sixteen waves — hold
   the three launches (on the HEA and the all-kinds programs) and
   ``ScanBodyFn``'s cotangents against their plain versions, each line
   naming K, CTAs and waves, and time them;
8. ``[cli-train]``: run ``python -m qfedx_tpu_torch train`` (CLI_ARGV, in
   this process, so that the counters can be read) on the card and the
   same argv on the CPU: a complete run directory (config.json, schema-1
   metrics.jsonl rows, summary.json, checkpoints whose sha256 verify),
   per-round loss and the final θ card vs CPU within
   TRAINED_LOGIT_ATOL, accuracy within one evaluation sample, exactly
   E·S_pad/B Launch-B and as many Launch-C launches per round, Launch A
   only from evaluation, and no build after round 1; print each round's
   time_s and client-rounds/s;
9. ``[cli-chunked]``: the same run with ``--rounds-per-call 3
   --checkpoint-every 3`` (the in-chunk evaluation: Launch A at the
   validation set's size), rows equal to the unchunked run's apart from
   chunk_rounds/time_s/eval_n;
10. ``[cli-rate]``: the same argv for 1 + RATE_ROUNDS rounds with
   ``--pipeline-depth 0 --rounds-per-call 1`` (each round synchronous):
   the same per-round launches, the first rounds' losses equal to the
   pipelined run's, and the round rate over the rounds after the first;
11. ``[cli-serve]``: ``serve --run-dir`` on the trained run answers 64
   requests and one malformed line in order (one ``code: 400``), with
   logits within LOGIT_ATOL of the CPU port's ``model.apply`` on the
   restored checkpoint; print p50/p95;
12. the bf16 route (``QFEDX_DTYPE=bf16``; the kernel's bf16 instances,
   the cluster one with its lane and row products on the tensor cores):
   ``[bf16-parity]`` holds Launches A, B and C in bf16 against the bf16
   plain version (relative norm ≤ BF16_RTOL) on the cases of phase 3 plus the
   trainer's tb = 128 (G = 4) and tb = 256, each line naming the
   instance, K, rows per CTA (RK), mma or FFMA products and shared
   memory; ``[bf16-grad]`` holds ``ScanBodyFn``'s cotangents against
   plain autograd in bf16 (relative norm ≤ BF16_GRAD_RTOL); both again
   on every tile path of the tensor-core products (``tc_program`` at
   every RK from 1 to 64, complex and real, G = 1 and G = tb);
   ``[bf16-serve]`` serves the 256 requests of phase 5
   under the pin (logits against the CPU port in bf16, every launch A on
   the bf16 instance, and the largest difference from the f32 logits);
   ``[time] bf16`` lines time A at the buckets, tb = 256 and tb = 78,
   B and C at tb = 128 and A, B and C at tb = 32 beside the f32 kernel,
   the bound (2 B per element, FLOP at the bf16 tensor-core rate)
   and the L2 bytes the ring moves as modelled from the code's slab
   count (printed beside the bound, not measured); a bf16 breakdown
   splits the sweep by kind;
   ``[bf16-cli-train]`` runs CLI_ARGV under the pin on the card and the
   CPU (6 B + 6 C per round and A only in evaluation, all on the bf16
   instance, no build after round 1, losses within BF16_LOSS_ATOL, the final
   accuracy within 0.12 of the f32 run's); ``[bf16-cli-serve]`` serves
   that run's checkpoint;
13. the dense engine (no kernel below n = 10, in either package):
   ``[dense-cli-train]`` runs ``train`` at the reference CLI's defaults
   (DENSE_ARGV: n = 8, L = 2, classes 0,1,2) on the card and the CPU —
   the "vmap" engine, 0 launches and 0 kernel builds, per-round loss and
   the final θ within TRAINED_LOGIT_ATOL, accuracy within one evaluation
   sample; ``[dense-cli-chunked]`` holds its rows under
   ``--rounds-per-call 3`` (the in-chunk evaluation) as ``[cli-chunked]``
   does; ``[dense-cli-rate]`` times 1 + RATE_ROUNDS synchronous rounds
   of it as ``[cli-rate]`` does; ``[dense-cli-serve]`` serves its
   checkpoint (64 requests and a malformed line, logits within
   LOGIT_ATOL); ``[dense-config1]`` the same for BASELINE.md config 1
   (CONFIG1_ARGV: n = 4, classes 0,1, 2 clients); ``[bf16-dense-cli-train]``
   the n = 8 run under the pin (losses within BF16_LOSS_ATOL, final
   accuracy within 0.12 of f32); ``[dense-route]`` holds the n = 12 L = 3
   model under QFEDX_BATCHED=0 (the dense state run as its slab) against
   the batched route: served logits, one local step's gradients and the
   same Launch A/B/C counts; ``[remat]`` holds one local step with
   ``remat=True`` at n = 8 and 12 against the per-layer route without
   checkpoints (REMAT_ATOL) and the default route (GRAD_ATOL), printing
   each run's peak device memory; ``[time] dense`` times the n = 8 served
   forward at the buckets (host clock, with ``torch.profiler``'s device
   kernels per forward and their device time) and one local step at the
   CLI's shape;
14. print one JSON line describing each launch of the kernel, f32 and
   bf16 instances (launches on the CLI run, and per path, the dense
   paths included; max error; kernel-alone, plain and bound at the CLI
   run's shape, and at the earlier slices' shapes);
15. print the final ``{"ok": true, "device": {...}}`` line.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

KERNEL_ATOL = 1e-5  # kernel vs plain, f32: same products, other sum order
GRAD_ATOL = 2e-5  # cotangents vs plain autograd (the reference's bound)
# bf16 (QFEDX_DTYPE=bf16): the kernel and its plain version round at the
# same points, but an f32 sum taken in another order can land on the other
# side of a bf16 rounding, and that one-ulp step (2^-8 relative) travels
# on through the sweep. A state is held by the relative norm of the
# difference over every output of a launch: an amplitude's typical size
# falls as 2^(-n/2), so an absolute bound fit for n = 12 would pass a zero
# output at n = 18, while a zero or wrong-op output reads ~1 here at any
# width. Logits and losses are O(0.1-1) at every width: absolute bounds.
BF16_RTOL = 2e-2  # bf16 kernel vs bf16 plain, ||kernel-plain|| / ||plain||
BF16_LOGIT_ATOL = 1e-3  # served logits card vs cpu, both bf16
BF16_LOSS_ATOL = 1e-4  # per-round mean loss card vs cpu, both bf16
BF16_GRAD_RTOL = 0.05  # bf16 cotangents vs plain autograd, relative norm
LOGIT_ATOL = 2e-5  # served logits vs the CPU run (the reference's bound)
LOSS_ATOL = 1e-5  # per-round mean loss, card vs the CPU port
TRAINED_LOGIT_ATOL = 1e-4  # logits after 3 Adam rounds, card vs CPU
N_QUBITS, N_LAYERS, N_CLASSES = 12, 3, 2
BUCKETS = (1, 8, 32)
N_REQUESTS = 256
# bench.py's fed16q federation shape (at the kernel's width, n=12).
FED_CLIENTS, FED_SAMPLES, FED_BATCH, FED_EPOCHS, FED_ROUNDS = 2, 64, 16, 1, 3
STEPS_PER_ROUND = FED_EPOCHS * FED_SAMPLES // FED_BATCH
# The trainer's shapes at the CLI's defaults: 4 clients x batch 32 folded
# (tb = 128, G = 4) for Launches B and C; the evaluator's batch of 256.
TRAIN_CLIENTS, TRAIN_BATCH, EVAL_BATCH = 4, 32, 256
CLI_ARGV = ["train", "--model", "vqc", "--qubits", str(N_QUBITS), "--layers",
            str(N_LAYERS), "--classes", "0,1", "--clients",
            str(TRAIN_CLIENTS), "--rounds", "3", "--local-epochs", "1",
            "--checkpoint-every", "1"]
CLI_ROUNDS = 3
RATE_ROUNDS = 16  # timed rounds of [cli-rate], after one warm-up round
N_SERVE_REQUESTS = 64
# H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the tensor cores,
# bf16 on the tensor cores (bf16 operands, f32 accumulation), HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
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


def random_state(n: int, tb: int, device, seed: int,
                 dtype=torch.float32):
    from qfedx_tpu_torch.ops.cpx import CArray

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(tb, 1 << n)) + 1j * rng.normal(size=(tb, 1 << n))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device).to(
            dtype)

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
    layer-entry states written too. States and coefficients count at the
    launch's element size (4 B in f32, 2 B in bf16)."""
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
    elem = 2 if spec.dtype == "bfloat16" else 4
    state_bytes = 2 * spec.tb * size * elem
    coeff_bytes = sum(p.numel() * elem for c in xs for p in c
                      if p is not None)
    perm_bytes = sum(len(op.perm) * 4 for op in spec.ops if op.perm)
    bnd_bytes = spec.length * state_bytes if with_boundaries else 0
    return flops, float(2 * state_bytes + coeff_bytes + perm_bytes
                        + bnd_bytes)


def bound_ms(spec, xs, with_boundaries: bool = False) -> tuple[float, str]:
    """The least time of the sweep on the card: its FLOP at the card's
    peak for the operands' type (a bf16 launch's products are bf16
    operands accumulated in f32, which the tensor cores do at the bf16
    rate, whatever the instance runs them on) or its bytes at the HBM
    rate, whichever is longer."""
    flops, nbytes = sweep_work(spec, xs, with_boundaries)
    peak = PEAK_BF16_FLOPS if spec.dtype == "bfloat16" else PEAK_F32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_HBM_BYTES
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


def kernel_only_ms(packed, spec, xs, with_boundaries: bool = False,
                   iters: int = 200) -> float:
    """CUDA-event time of the kernel alone: events around a loop of raw
    launches of ONE prepared launch (coefficients packed and outputs
    allocated once, before the loop), queued behind a device-side sleep
    so that the launches run back to back: neither wrapper work (checks,
    packing, allocation) nor the host's enqueue is timed. Counts no
    launch."""
    from qfedx_tpu_torch.ops import scan_body

    prep = scan_body.prepare_launch(packed, spec, xs, with_boundaries)

    def run():
        err = prep.run()
        if err != 0:
            raise RuntimeError(f"raw launch failed: CUDA error {err}")

    for _ in range(5):
        run()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)  # ~10 ms of device time to queue under
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
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
    for name, a in scan_body.instance_attrs().items():
        print(f"[build] instance {name}: {a['registers']} registers, "
              f"{a['local_bytes']} bytes local memory (spills and stack), "
              f"{a['static_smem']} bytes static shared memory (+ the "
              "dynamic shared memory in each [parity]/[time] line)")
    print(f"[build] bf16 cluster instance: lane and row products as "
          f"mma.sync m16n8k16 bf16 (f32 accumulators); ring of up to "
          f"{scan_body._MMA_MAX_UNITS} units of "
          f"{scan_body._unit_bytes('bfloat16')} B (16-row slabs, re and im, "
          f"rows swizzled by the host: chunk c of row j at c ^ (j mod 8)), "
          f"a bf16 copy of the CTA's rows ({scan_body._OPND_PITCH * 2} B "
          f"apart, re and im)")
    # The one-wave rule of ops/scan_body._launch_config rests on this
    # table: the card's resident clusters of K CTAs at the n=12 sizes.
    # In bf16 the ring's units are half the bytes, but the tensor-core
    # instance takes up to 16 of them and a bf16 copy of its rows.
    for dtype in ("float32", "bfloat16"):
        spec = scan_body._KernelSpec(12, N_LAYERS, 1, True, (
            scan_body._OpSpec("glane", (4,), True, 1, True, None),
            scan_body._OpSpec("growmat", (11,), True, 1, True, None),
        ), dtype)
        for k, table in scan_body._RESIDENT.items():
            cfg = scan_body.LaunchConfig(
                "cluster", k, scan_body._cluster_smem(spec, k), dtype,
                scan_body._products(dtype))
            got = scan_body.resident_clusters(cfg)
            note = ("" if got >= table
                    else " — FEWER than the table: more waves")
            print(f"[build] {dtype} resident clusters of K={k} ({cfg.smem} B "
                  f"each): {got} on this card, {table} in _RESIDENT{note}")
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


def width_and_tb_cases(device) -> list:
    """(name, n, program, tb) cases beyond the seven at tb=8: the
    all-kinds program at tb=1 (K at its largest, and K=R at n=10), at
    tb=16 and tb=32 (K=4 and 2), and at the widest width the cluster
    instance takes (n=17) and the next one up (n=18, the global-memory
    instance) — fewer layers there, where R×R coefficients grow."""
    return [
        ("all-kinds n=10 G=1", 10, kinds_program(10, 3, None, device, 10), 1),
        ("all-kinds n=12 G=1", 12, kinds_program(12, 3, None, device, 21), 1),
        ("all-kinds n=15 G=1", 15, kinds_program(15, 3, None, device, 22), 1),
        ("all-kinds n=12 G=8", 12, kinds_program(12, 3, 8, device, 23), 32),
        ("all-kinds n=12 G=8", 12, kinds_program(12, 3, 8, device, 24), 16),
        ("all-kinds n=17 G=1 L=2", 17,
         kinds_program(17, 2, None, device, 25), 2),
        ("all-kinds n=18 G=1 L=1", 18,
         kinds_program(18, 1, None, device, 26), 2),
    ]


def require_cluster(spec, what: str) -> None:
    """The main path's width (n=12) must take the cluster instance."""
    from qfedx_tpu_torch.ops import scan_body

    cfg = scan_body._launch_config(spec)
    if cfg.instance != "cluster":
        raise AssertionError(f"{what} runs the {cfg.instance} instance")


def config_text(spec) -> str:
    """Which instance a spec runs, with K, rows per CTA (RK), where its
    lane and row products run (mma: bf16 tensor cores; FFMA), CTAs and
    shared memory."""
    from qfedx_tpu_torch.ops import scan_body

    cfg = scan_body._launch_config(spec)
    dt = "" if cfg.dtype == "float32" else f" {cfg.dtype}"
    prod = "mma" if cfg.products == "mma" else "FFMA"
    if cfg.instance == "global":
        return f"instance global{dt}, {prod} products, {spec.tb} CTAs"
    resident = scan_body.resident_clusters(cfg)
    rk = (1 << (spec.n - 7)) // cfg.cluster
    return (f"instance cluster{dt}, K={cfg.cluster}, RK={rk}, {prod} "
            f"products, {spec.tb * cfg.cluster} "
            f"CTAs, {cfg.smem} B dynamic shared memory per CTA, "
            f"{resident} clusters resident at once "
            f"({-(-spec.tb // resident)} wave(s))")


def l2_bytes(spec, with_boundaries: bool = False) -> float:
    """A model, not a measurement: the bytes one sweep of the bf16
    tensor-core instance reads from L2 into shared memory, counted from
    its code (csrc/scan_body_mma.cuh): every
    lane product loads each slab once per group of the cluster (multicast)
    — a lane matrix once a pass, a glane's two branches once (a pass holds
    both, or each of two passes one) or, with the selecting bit in the
    rank, each group its branch once a pass; a row product's CTAs copy
    their rows of M (both growmat branches) once; a mask its slab; plus the
    state read and written and the boundaries. The state rows a row
    product copies between CTAs travel SM to SM and are not counted."""
    from qfedx_tpu_torch.ops import scan_body

    cfg = scan_body._launch_config(spec)
    r = 1 << (spec.n - 7)
    kbits = cfg.cluster.bit_length() - 1
    rk = r // cfg.cluster
    passes = max(1, rk // 32)
    per_layer = 0
    for op in spec.ops:
        parts = 2 if op.has_im else 1
        mat = 128 * 128 * 2 * parts
        if op.kind == "lane":
            per_layer += passes * mat
        elif op.kind == "glane":
            in_rank = (spec.n - 7) - 1 - op.qubits[0] < kbits
            per_layer += (2 * passes if in_rank else 2) * mat
        elif op.kind in ("rowmat", "growmat"):
            nbr = 2 if op.kind == "growmat" else 1
            per_layer += nbr * parts * r * r * 2
        elif op.kind == "mask":
            per_layer += parts * r * 128 * 2
    state = 2 * r * 128 * 2
    bnd = spec.length * state if with_boundaries else 0
    return float(spec.tb * (spec.length * per_layer + 2 * state + bnd))


def _max_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def _require(err: float, atol: float, what: str) -> None:
    if not err <= atol:
        raise AssertionError(f"{what}: {err:.3e} > {atol:g}")


def _rel_err(got, want) -> float:
    """||got - want|| / ||want|| over every tensor of the two lists."""
    num = sum(float((g.float() - w.float()).square().sum())
              for g, w in zip(got, want))
    den = sum(float(w.float().square().sum()) for w in want)
    return math.sqrt(num / den)


def _is_bf16(dtype) -> bool:
    return dtype == torch.bfloat16


def _tag(base: str, dtype) -> str:
    return f"[bf16-{base}]" if _is_bf16(dtype) else f"[{base}]"


def bf16_trainer_cases(device) -> list:
    """The trainer's shapes, held in bf16 beside the seven programs and
    the width/tb cases: the folded local step's tb = 128 (G = 4) and the
    evaluator's tb = 256, on the all-kinds and the HEA programs."""
    return [
        ("all-kinds n=12 G=4", 12,
         kinds_program(12, 3, TRAIN_CLIENTS, device, 41),
         TRAIN_CLIENTS * TRAIN_BATCH),
        ("hea n=12 L=3 G=4 (local step)", 12,
         hea_grouped_program(TRAIN_CLIENTS, 42, device),
         TRAIN_CLIENTS * TRAIN_BATCH),
        ("all-kinds n=12 G=1", 12, kinds_program(12, 3, None, device, 43),
         EVAL_BATCH),
    ]


def tc_program(n: int, length: int, groups, device, seed: int,
               real: bool = False):
    """A stacked program over every product path of the bf16 tensor-core
    instance: a lane product; a glane on row bit 0 (in the rank wherever
    K ≥ 2) and one on the top row bit (local wherever RK ≥ 2); a growmat
    on lane bit 0 (inside an n8 tile of lanes) and one on lane bit 6
    (outside it); a rowmat. Gaussian coefficients scaled to keep the
    state's norm on average (orthogonal-free: the bf16 checks are
    relative), real ones with ``real``."""
    from qfedx_tpu_torch.ops.cpx import CArray
    from qfedx_tpu_torch.ops.fuse import ScanProgram, StackedOp

    rng = np.random.default_rng(seed)
    r = 1 << (n - 7)
    lead = (length,) + (() if groups is None else (groups,))

    def mat(shape):
        d = shape[-1]
        scale = 1.0 / math.sqrt(d if real else 2 * d)
        def part():
            return torch.as_tensor(
                rng.standard_normal(lead + shape, dtype=np.float32) * scale,
                device=device)
        return CArray(part(), None if real else part())

    rbits = n - 7
    body = (
        StackedOp("lane", (), mat((128, 128)), True),
        StackedOp("glane", (rbits - 1,), mat((2, 128, 128)), True),
        StackedOp("growmat", (n - 1,), mat((2, r, r)), True),
        StackedOp("glane", (0,), mat((2, 128, 128)), True),
        StackedOp("growmat", (n - 7,), mat((2, r, r)), True),
        StackedOp("rowmat", (), mat((r, r)), True),
    )
    return ScanProgram((), body, length)


# (n, tb) of each rows-per-CTA shape the tensor-core instance tells apart:
# RK = 32 (K = 1), 16 (K = 2), 8 (K = 4; and n = 10 at K = 1), 4 and 2
# (the buckets 8 and 1), 1 (n = 10, K = 8), and 64 (n = 15 at K = 4, n = 17
# at K = 16: their state fits no smaller cluster).
TC_SHAPES = ((12, 128), (12, 32), (12, 16), (10, 128), (12, 8), (12, 1),
             (10, 1), (15, 16), (17, 2))


def phase_bf16_tiles(device) -> dict:
    """``[bf16-parity]`` and ``[bf16-grad]`` on every tile path of the
    bf16 tensor-core instance: ``tc_program`` at each of TC_SHAPES, with
    complex and real coefficients, shared (G = 1) and per sample
    (G = tb): Launches A, B and C against the bf16 plain version
    (relative norm ≤ BF16_RTOL) and ``ScanBodyFn``'s cotangents against
    plain autograd (≤ BF16_GRAD_RTOL). Returns the worst of each."""
    from qfedx_tpu_torch.ops import scan_body

    bf16 = torch.bfloat16
    worst = {"A": 0.0, "B": 0.0, "C": 0.0, "rel": 0.0, "grad": 0.0}
    i = 0
    t0 = time.perf_counter()
    for n, tb in TC_SHAPES:
        for real in (False, True):
            for groups in sorted({1, tb}):
                i += 1
                program = tc_program(n, 2, None if groups == 1 else groups,
                                     device, seed=1000 + i, real=real)
                packed, spec, xs = kernel_inputs(
                    random_state(n, tb, device, seed=1100 + i, dtype=bf16),
                    n, program)
                cfg = scan_body._launch_config(spec)
                if (cfg.instance, cfg.products) != ("cluster", "mma"):
                    raise AssertionError(f"n={n} tb={tb} runs {cfg}")
                aspec = scan_body._adjoint_spec(spec)
                axs = scan_body._adjoint_xs(spec, xs)
                cot = random_state(n, tb, device, seed=1200 + i, dtype=bf16)
                cot = torch.stack([cot.re, cot.im]).reshape(packed.shape)
                with torch.no_grad():
                    outs = {
                        "A": ([scan_body.scan_body(packed, spec, xs)],
                              [scan_body.scan_body_plain(packed, spec, xs)]),
                        "B": (scan_body.scan_body(packed, spec, xs,
                                                  with_boundaries=True),
                              scan_body.scan_body_plain(packed, spec, xs,
                                                        True)),
                        "C": (scan_body.scan_body(cot, aspec, axs,
                                                  with_boundaries=True,
                                                  adjoint=True),
                              scan_body.scan_body_plain(cot, aspec, axs,
                                                        True)),
                    }
                    torch.cuda.synchronize()
                rels = {k: _rel_err(*o) for k, o in outs.items()}
                name = (f"tc n={n} tb={tb} G={groups} "
                        f"{'real' if real else 'complex'}")
                print(f"[bf16-parity] {name} ({config_text(spec)}) "
                      f"body=[{','.join(op.kind for op in spec.ops)}] "
                      f"||kernel-plain||/||plain||: A {rels['A']:.3e}, B "
                      f"{rels['B']:.3e}, C {rels['C']:.3e} (rtol "
                      f"{BF16_RTOL:g})")
                for launch, rel in rels.items():
                    _require(rel, BF16_RTOL, f"bf16 Launch {launch} on {name}")
                    worst[launch] = max(worst[launch],
                                        _max_err(*outs[launch]))
                    worst["rel"] = max(worst["rel"], rel)
                w = torch.as_tensor(np.random.default_rng(1300 + i).normal(
                    size=tuple(packed.shape)), dtype=torch.float32,
                    device=device)
                before = dict(scan_body.launch_counts)
                got = _cotangents(spec, packed, xs, w, "kernel")
                launched = {k: scan_body.launch_counts[k] - before[k]
                            for k in before}
                want = _cotangents(spec, packed, xs, w, "plain")
                torch.cuda.synchronize()
                err_state = _rel_err(got[:1], want[:1])
                err_coeff = _rel_err(got[1:], want[1:])
                print(f"[bf16-grad] {name}: state cotangent {err_state:.3e}, "
                      f"coefficient cotangents {err_coeff:.3e} (relative "
                      f"norm, rtol {BF16_GRAD_RTOL:g}), launches {launched}")
                if launched != {"fwd": 0, "fwd_bnd": 1, "adj": 1}:
                    raise AssertionError(f"ScanBodyFn on {name} launched "
                                         f"{launched}")
                _require(max(err_state, err_coeff), BF16_GRAD_RTOL,
                         f"bf16 kernel gradients on {name}")
                worst["grad"] = max(worst["grad"], err_state, err_coeff)
    print(f"[bf16-parity] tile paths: {i} cases in "
          f"{time.perf_counter() - t0:.2f} s (host clock)")
    return worst


def phase_kernel_parity(device, dtype=torch.float32) -> dict:
    """Launches A, B and C against their plain versions, in ``dtype`` (in
    bf16 also at the trainer's shapes): max abs error ≤ KERNEL_ATOL in
    f32, relative norm ≤ BF16_RTOL in bf16. Returns the worst max abs
    error of each launch (and in bf16 the worst relative norm, "rel")."""
    from qfedx_tpu_torch.ops import scan_body

    bf = _is_bf16(dtype)
    worst = {"A": 0.0, "B": 0.0, "C": 0.0}
    worst_rel = 0.0
    cases = [c + (8,) for c in parity_programs(device)]
    cases += width_and_tb_cases(device)
    if _is_bf16(dtype):
        cases += bf16_trainer_cases(device)
    instances = set()
    for i, (name, n, program, tb) in enumerate(cases):
        packed, spec, xs = kernel_inputs(
            random_state(n, tb, device, seed=100 + i, dtype=dtype), n,
            program
        )
        instances.add(scan_body._launch_config(spec).instance)
        aspec = scan_body._adjoint_spec(spec)
        axs = scan_body._adjoint_xs(spec, xs)
        cot = random_state(n, tb, device, seed=200 + i, dtype=dtype)
        cot = torch.stack([cot.re, cot.im]).reshape(packed.shape)
        with torch.no_grad():
            outs = {
                "A": ([scan_body.scan_body(packed, spec, xs)],
                      [scan_body.scan_body_plain(packed, spec, xs)]),
                "B": (scan_body.scan_body(packed, spec, xs,
                                          with_boundaries=True),
                      scan_body.scan_body_plain(packed, spec, xs, True)),
                "C": (scan_body.scan_body(cot, aspec, axs,
                                          with_boundaries=True, adjoint=True),
                      scan_body.scan_body_plain(cot, aspec, axs, True)),
            }
            torch.cuda.synchronize()
        errs = {k: _max_err(*o) for k, o in outs.items()}
        kinds = ",".join(op.kind for op in spec.ops)
        line = (f"{_tag('parity', dtype)} {name} tb={tb} "
                f"({config_text(spec)}) body=[{kinds}] max|kernel-plain|: "
                f"A {errs['A']:.3e}, B (final+boundaries) {errs['B']:.3e}, "
                f"C (adjoint+boundaries) {errs['C']:.3e}")
        if bf:
            rels = {k: _rel_err(*o) for k, o in outs.items()}
            peak = float(outs["A"][1][0].abs().max())
            print(f"{line}; max|plain| {peak:.3e}; ||kernel-plain||/||plain||"
                  f": A {rels['A']:.3e}, B {rels['B']:.3e}, C "
                  f"{rels['C']:.3e} (rtol {BF16_RTOL:g})")
        else:
            rels = errs
            print(f"{line} (atol {KERNEL_ATOL:g})")
        for launch, err in rels.items():
            _require(err, BF16_RTOL if bf else KERNEL_ATOL,
                     f"{spec.dtype} Launch {launch} disagrees with plain on "
                     f"{name} at tb={tb}")
            worst[launch] = max(worst[launch], errs[launch])
            worst_rel = max(worst_rel, rels[launch])
    if instances != {"cluster", "global"}:
        raise AssertionError(f"parity cases ran instances {instances}")
    return dict(worst, rel=worst_rel) if bf else worst


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


def phase_grad_parity(device, dtype=torch.float32) -> float:
    """``ScanBodyFn``'s cotangents against plain autograd on the seven
    programs: max abs error in f32 (≤ GRAD_ATOL), relative norm in bf16
    (≤ BF16_GRAD_RTOL; the cotangent fed to Launch C is bf16 there)."""
    from qfedx_tpu_torch.ops import scan_body

    bf = _is_bf16(dtype)
    worst = 0.0
    for i, (name, n, program) in enumerate(parity_programs(device)):
        packed, spec, xs = kernel_inputs(
            random_state(n, 8, device, seed=300 + i, dtype=dtype), n, program
        )
        w = torch.as_tensor(
            np.random.default_rng(400 + i).normal(size=tuple(packed.shape)),
            dtype=torch.float32, device=device,
        )
        before = dict(scan_body.launch_counts)
        before_dt = dict(scan_body.dtype_counts)
        got = _cotangents(spec, packed, xs, w, "kernel")
        launched = {k: scan_body.launch_counts[k] - before[k]
                    for k in before}
        by_dtype = {k: scan_body.dtype_counts[k] - before_dt[k]
                    for k in before_dt}
        want = _cotangents(spec, packed, xs, w, "plain")
        torch.cuda.synchronize()
        if bf:
            err_state = _rel_err(got[:1], want[:1])
            err_coeff = _rel_err(got[1:], want[1:])
            what = f"relative norm, rtol {BF16_GRAD_RTOL:g}"
        else:
            err_state = float((got[0] - want[0]).abs().max())
            err_coeff = _max_err(got[1:], want[1:])
            what = f"atol {GRAD_ATOL:g}"
        print(f"{_tag('grad', dtype)} {name} tb=8: |kernel-plain| state "
              f"cotangent {err_state:.3e}, coefficient cotangents "
              f"{err_coeff:.3e} ({what}), launches {launched}"
              + (f", by dtype {by_dtype}" if bf else ""))
        if launched != {"fwd": 0, "fwd_bnd": 1, "adj": 1}:
            raise AssertionError(f"ScanBodyFn on {name} launched {launched}")
        if by_dtype[spec.dtype] != 2:
            raise AssertionError(f"ScanBodyFn on {name} ran {by_dtype}")
        _require(max(err_state, err_coeff),
                 BF16_GRAD_RTOL if bf else GRAD_ATOL,
                 f"{spec.dtype} kernel gradients disagree with plain "
                 f"autograd on {name}")
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
    return {"launches": launches, "engine": engine, "logit_err": err,
            "logits": logits, "p50": float(np.percentile(lat_ms, 50)),
            "p95": float(np.percentile(lat_ms, 95))}


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
        require_cluster(spec, f"the served sweep at bucket {b}")
        with torch.no_grad():
            got = scan_body.scan_body(packed, spec, xs)
            torch.cuda.synchronize()
            want = scan_body.scan_body_plain(packed, spec, xs)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            if not err <= KERNEL_ATOL:
                raise AssertionError(f"kernel disagrees with plain at bucket "
                                     f"{b}: {err:.3e} > {KERNEL_ATOL:g}")
            ms = kernel_only_ms(packed, spec, xs)
            call_ms = event_ms(lambda: scan_body.scan_body(packed, spec, xs))
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
        rows[b] = {"ms": ms, "call_ms": call_ms, "plain_ms": plain,
                   "bound_ms": bms,
                   "bound_by": by, "flops": flops, "bytes": nbytes,
                   "forward_ms": fwd_ms, "max_abs_err": err}
        print(f"[time] bucket {b}: max|kernel-plain|={err:.3e}, "
              f"kernel alone {ms:.5f} ms, wrapper call {call_ms:.5f} ms "
              f"(CUDA events), plain {plain:.5f} ms,"
              f" bound {bms:.5f} ms ({by}; {flops:.4g} FLOP, "
              f"{nbytes:.4g} B), served forward {fwd_ms:.4f} ms (host "
              f"clock), body=[{','.join(op.kind for op in spec.ops)}], "
              f"{config_text(spec)}")
    return rows


def phase_breakdown(device, params, dtype=torch.float32,
                    tbs=BUCKETS) -> None:
    """Where a served sweep's time goes: the kernel alone (CUDA events) on
    the served program's body cut to one kind at a time — a lane CNOT
    alone gives the launch, input and output — at each of ``tbs`` (the
    buckets' inputs)."""
    from qfedx_tpu_torch.circuits.encoders import angle_amplitudes
    from qfedx_tpu_torch.ops.batched import bstate_product_tree
    from qfedx_tpu_torch.ops.cpx import CArray
    from qfedx_tpu_torch.ops.fuse import ScanProgram, StackedOp

    bf = _is_bf16(dtype)
    program = hea_program(N_QUBITS, N_LAYERS, params["ansatz"]["rx"],
                          params["ansatz"]["rz"])
    bodies = [("cnot", (StackedOp("cnot", (7, 10), None, False),))]
    bodies += [(op.kind, (op,)) for op in program.body]
    bodies += [("+".join(op.kind for op in program.body), program.body)]
    for b in tbs:
        x = torch.as_tensor(
            np.random.default_rng(b).uniform(0, 1, (b, N_QUBITS)),
            dtype=torch.float32, device=device,
        )
        state = bstate_product_tree(angle_amplitudes(x * math.pi))
        state = CArray(state.re.to(dtype), state.imag_or_zeros().to(dtype))
        parts = []
        with torch.no_grad():
            for name, body in bodies:
                packed, spec, xs = kernel_inputs(
                    state, N_QUBITS, ScanProgram(program.pre, body, N_LAYERS))
                parts.append(
                    f"[{name}] {kernel_only_ms(packed, spec, xs):.5f}")
        print(f"[time] {'bf16 ' if bf else ''}breakdown at tb={b} (kernel "
              f"alone, {N_LAYERS} layers of one body, ms): {', '.join(parts)}")


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
    require_cluster(spec, "the training sweep")
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
        ms_b = kernel_only_ms(packed, spec, xs, with_boundaries=True)
        call_b = event_ms(lambda: scan_body.scan_body(
            packed, spec, xs, with_boundaries=True))
        plain_b = event_ms(lambda: scan_body.scan_body_plain(
            packed, spec, xs, True), iters=20)
        ms_c = kernel_only_ms(cot, aspec, axs, with_boundaries=True)
        call_c = event_ms(lambda: scan_body.scan_body(
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
    for launch, ms, call, plain, err in (
        ("B", ms_b, call_b, plain_b, b_err),
        ("C", ms_c, call_c, plain_c, c_err),
    ):
        rows[launch] = {"ms": ms, "call_ms": call, "plain_ms": plain,
                        "bound_ms": bms, "bound_by": by, "max_abs_err": err}
        print(f"[time] Launch {launch} at the training shape (tb="
              f"{spec.tb}, G={spec.ops[0].groups}, body=[{kinds}]): "
              f"max|kernel-plain|={err:.3e}, kernel alone {ms:.5f} ms, "
              f"wrapper call {call:.5f} ms (CUDA events), plain "
              f"{plain:.5f} ms, bound {bms:.5f} ms ({by}; {flops:.4g} FLOP, "
              f"{nbytes:.4g} B with {spec.length} boundary states), "
              f"{config_text(spec)}")
    print(f"[time] coefficient cotangents (torch autograd of one layer per "
          f"layer over the boundaries) at the training shape: "
          f"{cotan_ms:.5f} ms (CUDA events)")
    rows["cotangent_ms"] = cotan_ms
    from qfedx_tpu_torch.fed.config import FedConfig

    leaves = {
        "ansatz": {"rx": rx.movedim(0, 1).contiguous(),
                   "rz": rz.movedim(0, 1).contiguous()},
        "readout": {k: v[None].repeat(FED_CLIENTS, 1)
                    for k, v in trained["params"]["readout"].items()},
    }
    cx, cy, _ = fed_data()
    rows["step"] = local_step_split(
        trained["model"], leaves, torch.as_tensor(cx[:, :FED_BATCH],
                                                  device=device),
        torch.as_tensor(cy[:, :FED_BATCH], device=device),
        FedConfig(optimizer="adam", learning_rate=0.1),
        "one local step at the training shape")
    return rows


def local_step_split(model, leaves: dict, xb, yb, cfg, label: str,
                     iters: int = 10) -> dict:
    """One folded local step — ``model.apply_clients`` on per-client
    ``leaves`` and (C, B, n) features — split on the host clock
    (synchronised): the forward (program build, encoder, sweep, readout,
    loss), the backward and the ``cfg`` optimizer's update."""
    from qfedx_tpu_torch.fed.client import _cross_entropy, make_optimizer

    opt = make_optimizer(cfg)
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
    print(f"[time] {label} (host clock, "
          f"synchronised, mean of {iters}): forward {parts['forward']:.4f} "
          f"ms, backward {parts['backward']:.4f} ms, optimizer "
          f"{parts['optimizer']:.4f} ms")
    return parts


def hea_grouped_program(groups: int, seed: int, device):
    """The n=12 L=3 HEA program with per-client (L, G, n) angles: the
    folded local step's program."""
    rng = np.random.default_rng(seed)
    rx, rz = (torch.as_tensor(rng.uniform(-2, 2, (N_LAYERS, groups, N_QUBITS)),
                              dtype=torch.float32, device=device)
              for _ in range(2))
    return hea_program(N_QUBITS, N_LAYERS, rx, rz)


def in_chunk_eval_tbs(n_val: int) -> list:
    """Launch A's tb in the trainer's in-chunk evaluation (one
    ``model.apply`` per round when ``--rounds-per-call`` > 1, the CLI's
    default): the CLI run's validation set, and the trainer's cap."""
    from qfedx_tpu_torch.run.trainer import _IN_CHUNK_EVAL_CAP

    return sorted({min(n_val, _IN_CHUNK_EVAL_CAP), _IN_CHUNK_EVAL_CAP})


def trainer_shape_cases(device, n_val: int) -> list:
    """(name, program, tb, launches) at the trainer's shapes: the HEA
    program at the evaluator's tb = 256 (A), the folded local step's
    tb = 128 with G = 4 (B, C) and the in-chunk evaluation's tb (A), and
    the all-kinds program at the first two."""
    rng = np.random.default_rng(31)
    rx, rz = (torch.as_tensor(rng.uniform(-2, 2, (N_LAYERS, N_QUBITS)),
                              dtype=torch.float32, device=device)
              for _ in range(2))
    hea = hea_program(N_QUBITS, N_LAYERS, rx, rz)
    return [
        ("hea n=12 L=3 G=1 (evaluator)", hea, EVAL_BATCH, "A"),
        ("hea n=12 L=3 G=4 (local step)", hea_grouped_program(
            TRAIN_CLIENTS, 32, device), TRAIN_CLIENTS * TRAIN_BATCH, "BC"),
        ("all-kinds n=12 G=1", kinds_program(12, 3, None, device, 33),
         EVAL_BATCH, "ABC"),
        ("all-kinds n=12 G=4", kinds_program(12, 3, TRAIN_CLIENTS, device, 34),
         TRAIN_CLIENTS * TRAIN_BATCH, "ABC"),
    ] + [("hea n=12 L=3 G=1 (in-chunk evaluation)", hea, tb, "A")
         for tb in in_chunk_eval_tbs(n_val)]


def phase_trainer_shapes(device, n_val: int) -> dict:
    """Launches A, B and C and ``ScanBodyFn``'s cotangents against their
    plain versions at the trainer's shapes (tb = 128, 256, the CLI run's
    validation set ``n_val`` and the in-chunk evaluation's cap of 2048,
    where ``_launch_config`` takes clusters of one CTA and the card runs
    the grid in one to sixteen waves), then their times there. Returns,
    per launch, the worst error, and the time rows keyed by (launch,
    tb)."""
    from qfedx_tpu_torch.ops import scan_body

    worst = {"A": 0.0, "B": 0.0, "C": 0.0}
    rows = {}
    for i, (name, program, tb, launches) in enumerate(
            trainer_shape_cases(device, n_val)):
        packed, spec, xs = kernel_inputs(
            random_state(N_QUBITS, tb, device, seed=500 + i), N_QUBITS,
            program)
        require_cluster(spec, f"{name} at tb={tb}")
        aspec = scan_body._adjoint_spec(spec)
        axs = scan_body._adjoint_xs(spec, xs)
        cot = random_state(N_QUBITS, tb, device, seed=600 + i)
        cot = torch.stack([cot.re, cot.im]).reshape(packed.shape)
        errs = {}
        with torch.no_grad():
            if "A" in launches:
                errs["A"] = _max_err(
                    [scan_body.scan_body(packed, spec, xs)],
                    [scan_body.scan_body_plain(packed, spec, xs)])
            if "B" in launches:
                errs["B"] = _max_err(
                    scan_body.scan_body(packed, spec, xs,
                                        with_boundaries=True),
                    scan_body.scan_body_plain(packed, spec, xs, True))
            if "C" in launches:
                errs["C"] = _max_err(
                    scan_body.scan_body(cot, aspec, axs, with_boundaries=True,
                                        adjoint=True),
                    scan_body.scan_body_plain(cot, aspec, axs, True))
            torch.cuda.synchronize()
        print(f"[parity] {name} tb={tb} ({config_text(spec)}) max|kernel-"
              "plain|: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (atol {KERNEL_ATOL:g})")
        for launch, err in errs.items():
            _require(err, KERNEL_ATOL, f"Launch {launch} disagrees with plain "
                     f"on {name} at tb={tb}")
            worst[launch] = max(worst[launch], err)
        if name.startswith("hea"):
            if "B" in launches:
                w = torch.as_tensor(np.random.default_rng(700 + i).normal(
                    size=tuple(packed.shape)), dtype=torch.float32,
                    device=device)
                before = dict(scan_body.launch_counts)
                got = _cotangents(spec, packed, xs, w, "kernel")
                launched = {k: scan_body.launch_counts[k] - before[k]
                            for k in before}
                want = _cotangents(spec, packed, xs, w, "plain")
                torch.cuda.synchronize()
                err_state = float((got[0] - want[0]).abs().max())
                err_coeff = _max_err(got[1:], want[1:])
                print(f"[grad] {name} tb={tb}: max|kernel-plain| state "
                      f"cotangent {err_state:.3e}, coefficient cotangents "
                      f"{err_coeff:.3e} (atol {GRAD_ATOL:g}), launches "
                      f"{launched}")
                if launched != {"fwd": 0, "fwd_bnd": 1, "adj": 1}:
                    raise AssertionError(f"ScanBodyFn launched {launched}")
                _require(max(err_state, err_coeff), GRAD_ATOL,
                         f"kernel gradients disagree with plain at {name}")
            rows.update(time_launches(name, packed, spec, xs, cot, aspec,
                                      axs, errs, launches))
    return {"worst": worst, "rows": rows}


def time_launches(name, packed, spec, xs, cot, aspec, axs, errs,
                  launches) -> dict:
    """Kernel alone, wrapper call, plain version and bound of each of
    ``launches`` at these inputs; one ``[time]`` line each. A bf16 cluster
    launch prints beside the bound the L2 bytes it moves as modelled from
    the code (``l2_bytes``, not measured)."""
    from qfedx_tpu_torch.ops import scan_body

    rows = {}
    with torch.no_grad():
        for launch in launches:
            bnd = launch != "A"
            s, x, st = (aspec, axs, cot) if launch == "C" else (spec, xs,
                                                                packed)
            ms = kernel_only_ms(st, s, x, with_boundaries=bnd)
            call = event_ms(lambda: scan_body.scan_body(
                st, s, x, with_boundaries=bnd, adjoint=launch == "C"))
            plain = event_ms(lambda: scan_body.scan_body_plain(st, s, x, bnd),
                             iters=10)
            bms, by = bound_ms(s, x, with_boundaries=bnd)
            flops, nbytes = sweep_work(s, x, with_boundaries=bnd)
            row = {"ms": ms, "call_ms": call, "plain_ms": plain,
                   "bound_ms": bms, "bound_by": by,
                   "max_abs_err": errs[launch]}
            ring = ""
            if scan_body._launch_config(s).products == "mma":
                ring = (f"; L2->SM bytes {l2_bytes(s, bnd):.4g}, modelled "
                        f"from the code's slab count, not measured")
            rows[launch, s.tb] = row
            print(f"[time] Launch {launch} at {name}, tb={s.tb}: kernel "
                  f"alone {ms:.5f} ms, wrapper call {call:.5f} ms (CUDA "
                  f"events), plain {plain:.5f} ms, bound {bms:.5f} ms ({by}; "
                  f"{flops:.4g} FLOP, {nbytes:.4g} B{ring}), "
                  f"{config_text(s)}")
    return rows


def _rows(run_dir) -> list:
    from qfedx_tpu_torch.run.metrics import validate_metrics_record

    return [validate_metrics_record(json.loads(line)) for line in
            (run_dir / "metrics.jsonl").read_text().splitlines()]


class _RoundCounts:
    """Wraps ``run.trainer.make_fed_round`` so each round's kernel
    launches and the build count after it are recorded (the launch
    counters move when a launch is enqueued, so a round's launches are
    those made inside its call)."""

    def __init__(self):
        from qfedx_tpu_torch.run import trainer

        self.trainer, self.orig = trainer, trainer.make_fed_round
        self.rounds: list = []

    def __enter__(self):
        from qfedx_tpu_torch.ops import scan_body

        def make(*args, **kwargs):
            fn = self.orig(*args, **kwargs)

            def counted(*a, **k):
                before = dict(scan_body.launch_counts)
                out = fn(*a, **k)
                self.rounds.append((
                    {key: scan_body.launch_counts[key] - before[key]
                     for key in before}, scan_body.build_count))
                return out

            return counted

        self.trainer.make_fed_round = make
        return self

    def __exit__(self, *exc):
        self.trainer.make_fed_round = self.orig


def cli_train(argv, device) -> tuple[dict, dict, list, dict]:
    """``run.cli.main(argv)`` in this process on ``device`` (None = the
    card) with the launch counters set to 0 just before; returns the
    summary, the launches read just after, each round's launches, and the
    launches by instance dtype."""
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.run import cli

    with _RoundCounts() as rc:
        scan_body.reset_counts()
        summary = cli.main(argv, device=device)
        launches = dict(scan_body.launch_counts)
        by_dtype = dict(scan_body.dtype_counts)
    return summary, launches, rc.rounds, by_dtype


def expected_shapes(argv) -> dict:
    """What the CLI's data gives the kernel: local steps per round
    (E·S_pad/B) and the evaluation sets' sizes."""
    from qfedx_tpu_torch.run import cli
    from qfedx_tpu_torch.run.config import build_data

    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    data = build_data(cfg)
    s_pad = data["cx"].shape[1]
    return {"steps": cfg.fed.local_epochs * s_pad // cfg.fed.batch_size,
            "s_pad": s_pad, "n_val": len(data["val"][1]),
            "n_test": len(data["test"][1]), "clients": data["cx"].shape[0]}


def _batches(n: int) -> int:
    return -(-n // EVAL_BATCH)


def phase_cli_train(root, shapes: dict) -> dict:
    """``python -m qfedx_tpu_torch train`` (in-process) on the card, then
    the same argv on the CPU: a complete run directory, every row on the
    schema, the card's rounds against the CPU's, the launches each round
    makes, and no build after the first round."""
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.run.checkpoint import Checkpointer

    argv = CLI_ARGV + ["--run-root", str(root), "--name", "smoke"]
    t0 = time.perf_counter()
    summary, launches, rounds, _ = cli_train(argv, None)
    wall = time.perf_counter() - t0
    run = root / "smoke"
    t0 = time.perf_counter()
    cpu_summary, _, _, _ = cli_train(
        CLI_ARGV + ["--run-root", str(root / "cpu"), "--name", "smoke"],
        "cpu")
    cpu_wall = time.perf_counter() - t0
    cpu_run = root / "cpu" / "smoke"
    print(f"[cli-train] {' '.join(argv)}: card {wall:.2f} s, cpu "
          f"{cpu_wall:.2f} s (host clock, in-process); {shapes['clients']} "
          f"clients x S_pad={shapes['s_pad']}, {shapes['steps']} local steps "
          f"per round at tb={shapes['clients'] * TRAIN_BATCH}; eval sets "
          f"{shapes['n_val']} (val) / {shapes['n_test']} (test)")
    for f in ("config.json", "metrics.jsonl", "summary.json"):
        if not (run / f).is_file():
            raise AssertionError(f"run directory lacks {f}")
    ckpt = Checkpointer(run / "checkpoints", every=1)
    for r in range(1, CLI_ROUNDS + 1):
        ckpt.verify(r)  # raises on a missing file or a bad sha256
    rows, cpu_rows = _rows(run), _rows(cpu_run)
    if [r["round"] for r in rows] != list(range(1, CLI_ROUNDS + 1)):
        raise AssertionError(f"metrics.jsonl rounds {rows}")
    for row, cpu in zip(rows, cpu_rows):
        loss_err = abs(row["loss"] - cpu["loss"])
        acc_err = abs(row["accuracy"] - cpu["accuracy"])
        print(f"[cli-train] round {row['round']}: loss card {row['loss']!r} "
              f"cpu {cpu['loss']!r} |err|={loss_err:.3e} (atol "
              f"{TRAINED_LOGIT_ATOL:g}), accuracy card {row['accuracy']!r} "
              f"cpu {cpu['accuracy']!r} (n={row['n']}), time_s "
              f"{row['time_s']:.4f} (host clock, drain to drain), "
              f"{shapes['clients'] / row['time_s']:.4f} client-rounds/s")
        _require(loss_err, TRAINED_LOGIT_ATOL, f"round {row['round']} loss")
        _require(acc_err, 1.0 / row["n"] + 1e-12,
                 f"round {row['round']} accuracy, card vs cpu")
    template = make_vqc_classifier(N_QUBITS, N_LAYERS, 2,
                                   device="cpu").init(0)
    theta = ckpt.restore(CLI_ROUNDS, template)
    cpu_theta = Checkpointer(cpu_run / "checkpoints").restore(CLI_ROUNDS,
                                                              template)
    theta_err = _max_err(
        [v for d in theta.values() for v in d.values()],
        [v for d in cpu_theta.values() for v in d.values()])
    print(f"[cli-train] final theta max|card-cpu|={theta_err:.3e} (atol "
          f"{TRAINED_LOGIT_ATOL:g}); summary card {json.dumps(summary)}; "
          f"cpu final_accuracy {cpu_summary['final_accuracy']!r}")
    _require(theta_err, TRAINED_LOGIT_ATOL, "final theta, card vs cpu")
    steps = shapes["steps"]
    want_round = {"fwd": 0, "fwd_bnd": steps, "adj": steps}
    evals = _batches(shapes["n_val"]) * (1 + CLI_ROUNDS) + _batches(
        shapes["n_test"])
    want = {"fwd": evals, "fwd_bnd": CLI_ROUNDS * steps,
            "adj": CLI_ROUNDS * steps}
    print(f"[cli-train] launches {launches} (expected {want}: "
          f"{steps} B + {steps} C per round, A = evaluation batches of "
          f"{EVAL_BATCH}); per round {[c for c, _ in rounds]}; builds after "
          f"each round {[b for _, b in rounds]}")
    if [c for c, _ in rounds] != [want_round] * CLI_ROUNDS:
        raise AssertionError(f"rounds launched {rounds}, each should "
                             f"launch {want_round}")
    if launches != want:
        raise AssertionError(f"the run launched {launches}, expected {want}")
    if len({b for _, b in rounds}) != 1 or scan_body.build_count != rounds[
            0][1]:
        raise AssertionError("the kernel library was built after round 1")
    times = [r["time_s"] for r in rows]
    print(f"[cli-train] {CLI_ROUNDS} rounds: time_s {times} (the "
          "reference's drain-to-drain increments: with the loop pipelined "
          "one chunk deep, round 1 holds the first use and round 2's "
          "dispatch and the last round only its drain, so these resolve no "
          "rate; [cli-rate] measures it)")
    return {"run": run, "rows": rows, "launches": launches, "times": times,
            "clients": shapes["clients"], "steps": steps,
            "theta_err": theta_err, "shapes": shapes, "summary": summary}


def phase_cli_chunked(root, unchunked: dict, argv=CLI_ARGV,
                      tag="cli-chunked", want=None) -> dict:
    """The same run with ``--rounds-per-call 3 --checkpoint-every 3``: one
    chunk of three rounds, each evaluated in the chunk (Launch A at the
    validation set's size, unless ``want`` gives other launches); rows
    equal the unchunked run's apart from ``chunk_rounds``, ``time_s``
    and ``eval_n``."""
    name = f"smoke-{tag}"
    argv = argv[:-2] + ["--checkpoint-every", "3", "--rounds-per-call",
                        "3", "--run-root", str(root), "--name", name]
    _, launches, rounds, _ = cli_train(argv, None)
    rows = _rows(root / name)
    shapes = unchunked["shapes"]
    for row, ref in zip(rows, unchunked["rows"]):
        loss_err = abs(row["loss"] - ref["loss"])
        acc_err = abs(row["accuracy"] - ref["accuracy"])
        print(f"[{tag}] round {row['round']}: chunk_rounds "
              f"{row['chunk_rounds']}, eval_n {row['eval_n']}, loss "
              f"|chunked-unchunked|={loss_err:.3e}, accuracy "
              f"|chunked-unchunked|={acc_err:.3e}, time_s "
              f"{row['time_s']:.4f}")
        _require(loss_err, 1e-6, f"chunked round {row['round']} loss")
        _require(acc_err, 1e-6, f"chunked round {row['round']} accuracy")
        if (row["chunk_rounds"], row["eval_n"]) != (3, shapes["n_val"]):
            raise AssertionError(f"chunked row {row}")
        if row["rejected_updates"] != ref["rejected_updates"]:
            raise AssertionError(f"chunked row {row} vs {ref}")
    if want is None:
        steps = shapes["steps"]
        want = {"fwd": _batches(shapes["n_val"]) + CLI_ROUNDS + _batches(
            shapes["n_test"]), "fwd_bnd": CLI_ROUNDS * steps,
            "adj": CLI_ROUNDS * steps}
    print(f"[{tag}] launches {launches} (expected {want}; the in-chunk "
          f"evaluation is one forward per round at tb={shapes['n_val']})")
    if launches != want or len(rows) != CLI_ROUNDS:
        raise AssertionError(f"chunked run launched {launches}")
    ckpts = sorted(p.name for p in (root / name /
                                    "checkpoints").glob("*.npz"))
    if ckpts != ["ckpt_000003.npz"]:
        raise AssertionError(f"chunked checkpoints {ckpts}")
    return {"launches": launches}


def phase_cli_rate(root, unchunked: dict, argv=CLI_ARGV, tag="cli-rate",
                   want_round=None) -> dict:
    """The round rate of the CLI run: the same argv for 1 + RATE_ROUNDS
    rounds with ``--pipeline-depth 0 --rounds-per-call 1``, so each row's
    ``time_s`` is one round from its dispatch to its stats on the host
    (the evaluation and checkpoint come after); the first round is the
    warm-up, and the rate is the other rounds' clients over their summed
    times. Its first rounds must equal the pipelined run's, and each
    round launch ``want_round`` (default: the run's B and C per step)."""
    name = f"smoke-{tag}"
    argv = list(argv)
    argv[argv.index("--rounds") + 1] = str(1 + RATE_ROUNDS)
    argv[argv.index("--checkpoint-every") + 1] = str(1 + RATE_ROUNDS)
    argv += ["--rounds-per-call", "1", "--pipeline-depth", "0",
             "--run-root", str(root), "--name", name]
    t0 = time.perf_counter()
    _, launches, rounds, _ = cli_train(argv, None)
    wall = time.perf_counter() - t0
    rows = _rows(root / name)
    clients = unchunked["clients"]
    if want_round is None:
        steps = unchunked["steps"]
        want_round = {"fwd": 0, "fwd_bnd": steps, "adj": steps}
    if [c for c, _ in rounds] != [want_round] * (1 + RATE_ROUNDS):
        raise AssertionError(f"rate run's rounds launched {rounds}")
    if len({b for _, b in rounds}) != 1:
        raise AssertionError("the kernel library was built after round 1")
    for row, ref in zip(rows, unchunked["rows"]):
        _require(abs(row["loss"] - ref["loss"]), 1e-6,
                 f"round {row['round']} loss at pipeline depth 0 vs 1")
    times = [r["time_s"] for r in rows]
    timed = sorted(times[1:])
    rate = clients * len(timed) / sum(timed)
    print(f"[{tag}] {' '.join(argv)}: warm-up round {times[0]:.5f} s; "
          f"{len(timed)} rounds (host clock, dispatch to stats, synchronous) "
          f"sum {sum(timed):.5f} s, min {timed[0]:.5f} median "
          f"{timed[len(timed) // 2]:.5f} max {timed[-1]:.5f} s per round, "
          f"{rate:.4f} client-rounds/s; whole run {wall:.2f} s with data, "
          "evaluation and checkpoints")
    return {"times": times, "rate": rate, "launches": launches}


def phase_cli_serve(root, run_dir, dtype=torch.float32,
                    shape=(N_QUBITS, N_LAYERS, 2), tag="cli-serve") -> dict:
    """``serve --run-dir`` (in-process) on the trained run: 64 requests
    and one malformed line, answered in order; the logits against the CPU
    port's ``model.apply`` on the restored checkpoint (in bf16 under the
    pin, which the caller sets: every launch on the bf16 instance).
    ``shape`` is the run's (qubits, layers, classes); below the slab
    widths the model runs no kernel and the phase requires 0 launches."""
    n_qubits, n_layers, n_classes = shape
    dense = n_qubits < 10
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.run import cli
    from qfedx_tpu_torch.run.checkpoint import Checkpointer

    x = np.random.default_rng(17).uniform(0, 1, (N_SERVE_REQUESTS, n_qubits))
    x = x.astype(np.float32)
    lines = [json.dumps({"id": f"q{i}", "features": v.tolist()})
             for i, v in enumerate(x)]
    lines.insert(10, "{malformed")
    (root / "requests.jsonl").write_text("\n".join(lines) + "\n")
    out = root / "responses.jsonl"
    scan_body.reset_counts()
    summary = cli.main(["serve", "--run-dir", str(run_dir), "--input",
                        str(root / "requests.jsonl"), "--output", str(out)])
    launches = dict(scan_body.launch_counts)
    by_dtype = dict(scan_body.dtype_counts)
    resp = [json.loads(line) for line in out.read_text().splitlines()]
    want_ids = [f"q{i}" for i in range(N_SERVE_REQUESTS)]
    want_ids.insert(10, 10)
    if [r["id"] for r in resp] != want_ids:
        raise AssertionError("responses out of order")
    bad = [r for r in resp if "error" in r]
    if len(bad) != 1 or bad[0]["code"] != 400 or bad[0]["id"] != 10:
        raise AssertionError(f"error responses {bad}")
    model = make_vqc_classifier(n_qubits, n_layers, n_classes, device="cpu")
    params, _ = Checkpointer(run_dir / "checkpoints").restore_latest(
        model.init(0))
    with torch.no_grad():
        ref = model.apply(params, x).numpy()
    got = np.array([r["logits"] for r in resp if "logits" in r])
    if got.shape != ref.shape or not np.isfinite(got).all():
        raise AssertionError(f"served logits of shape {got.shape}")
    err = float(np.abs(got - ref).max())
    atol = BF16_LOGIT_ATOL if _is_bf16(dtype) else LOGIT_ATOL
    print(f"{_tag(tag, dtype)} {summary['served']} served, "
          f"{summary['responses']} "
          f"responses, rejected {summary['rejected']}, shed "
          f"{summary['shed']}, batches {summary['batches']}, latency p50="
          f"{summary['p50_ms']} ms p95={summary['p95_ms']} ms; logits "
          f"max|card-cpu|={err:.3e} (atol {atol:g}); launches "
          f"{launches}, by dtype {by_dtype}")
    _require(err, atol, "served logits of the trained run vs cpu")
    if dense:
        if any(launches.values()):
            raise AssertionError(f"the dense model launched {launches}")
        return {"launches": launches, "logit_err": err,
                "p50": summary["p50_ms"], "p95": summary["p95_ms"]}
    if launches["fwd"] < summary["batches"] or launches["fwd_bnd"] or \
            launches["adj"]:
        raise AssertionError(f"serving launched {launches}")
    want_dt = "bfloat16" if _is_bf16(dtype) else "float32"
    if by_dtype[want_dt] != launches["fwd"]:
        raise AssertionError(f"serving ran instances {by_dtype}")
    return {"launches": launches, "logit_err": err,
            "p50": summary["p50_ms"], "p95": summary["p95_ms"]}


# --- bf16 states (QFEDX_DTYPE=bf16) ------------------------------------------


@contextlib.contextmanager
def env_pins(**values):
    """Set the QFEDX_* pins ``values`` for the block (the port reads its
    pins at every call), restored after."""
    before = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def bf16_pin():
    """``QFEDX_DTYPE=bf16`` for the block, restored after."""
    return env_pins(QFEDX_DTYPE="bf16")


def phase_bf16_serve(device, f32_served: dict) -> dict:
    """``[bf16-serve]``: the served slice of ``phase_serve`` (same weights,
    the same 256 requests in the same waves) under the pin: every launch
    Launch A on the bf16 instance, no build after warmup, logits within
    BF16_LOGIT_ATOL of the same port on the CPU in bf16; prints the largest
    difference from the card's f32 logits."""
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.serve import MicroBatcher, ServeConfig, ServeEngine

    with bf16_pin():
        model = make_vqc_classifier(N_QUBITS, N_LAYERS, N_CLASSES,
                                    init_scale=1.0)
        params = model.init(0)
        engine = ServeEngine(
            model, params, (N_QUBITS,),
            config=ServeConfig(buckets=BUCKETS, deadline_ms=2.0,
                               max_queue=512),
        )
        warm = engine.warmup()
        if warm["route_resolved"]["dtype"] != "bfloat16":
            raise AssertionError(f"bf16 warmup resolved {warm}")
        builds_after_warmup = scan_body.build_count
        x = np.random.default_rng(11).uniform(0, 1, (N_REQUESTS, N_QUBITS))
        x = x.astype(np.float32)
        scan_body.reset_counts()
        batcher = MicroBatcher(engine).start()
        futures = []
        for lo, hi in ((0, 1), (1, 6), (6, N_REQUESTS)):
            wave = [batcher.submit(x[i]) for i in range(lo, hi)]
            for f in wave:
                f.result(timeout=60)
            futures += wave
        batcher.close(drain=True)
        launches = dict(scan_body.launch_counts)
        by_dtype = dict(scan_body.dtype_counts)
        builds = scan_body.build_count - builds_after_warmup
        logits = np.stack([f.result()["logits"] for f in futures])
        lat_ms = np.array([(f.done_t - f.submit_t) * 1e3 for f in futures])
        cpu_model = make_vqc_classifier(N_QUBITS, N_LAYERS, N_CLASSES,
                                        init_scale=1.0, device="cpu")
        cpu_params = {g: {k: v.cpu() for k, v in d.items()}
                      for g, d in params.items()}
        with torch.no_grad():
            ref = cpu_model.apply(cpu_params, x).numpy()
    err = float(np.abs(logits - ref).max())
    f32_diff = float(np.abs(logits - f32_served["logits"]).max())
    p50, p95 = np.percentile(lat_ms, 50), np.percentile(lat_ms, 95)
    print(f"[bf16-serve] {N_REQUESTS} requests, batches="
          f"{batcher.stats['batches']}, launches {launches}, by dtype "
          f"{by_dtype}, builds after warmup={builds}; latency p50={p50:.4f} "
          f"ms p95={p95:.4f} ms (f32 run: p50={f32_served['p50']:.4f} ms "
          f"p95={f32_served['p95']:.4f} ms)")
    print(f"[bf16-serve] logits max|card-cpu| (both bf16)={err:.3e} (atol "
          f"{BF16_LOGIT_ATOL:g}); max|card bf16 - card f32|={f32_diff:.3e} "
          f"(the reference's bf16-vs-f32 bound on <Z> is 3e-2)")
    total = sum(launches.values())
    if total < batcher.stats["batches"] or launches["fwd"] != total:
        raise AssertionError(f"bf16 serving launched {launches}")
    if by_dtype != {"float32": 0, "bfloat16": total}:
        raise AssertionError(f"bf16 serving ran instances {by_dtype}")
    if builds:
        raise AssertionError("the kernel library was built after warmup")
    if logits.shape != (N_REQUESTS, N_CLASSES) or not np.isfinite(
            logits).all():
        raise AssertionError(f"bad bf16 logits: shape {logits.shape}")
    _require(err, BF16_LOGIT_ATOL, "bf16 served logits, card vs cpu")
    return {"launches": launches["fwd"], "logit_err": err,
            "f32_diff": f32_diff, "params": params}


def phase_bf16_times(device, params, f32_times: dict, f32_rows: dict,
                     f32_train: dict, n_val: int) -> dict:
    """``[time]`` in bf16: Launch A at each bucket's served inputs, at the
    evaluator's tb = 256 and the in-chunk evaluation's tb (the CLI run's
    ``n_val`` = 78), Launches B
    and C at the local step's tb = 128 (G = 4), and A, B and C at the
    training shape tb = 32 (G = 2) — kernel alone, wrapper call, plain
    version, the bound (2 B per element, FLOP at the bf16 tensor-core
    rate) with the modelled L2 bytes — each beside the f32 kernel's time
    at the same shape (from the f32 phases of this run)."""
    from qfedx_tpu_torch.circuits.encoders import angle_amplitudes
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.ops.batched import bstate_product_tree

    rows = {}

    def compare(launch, key, row, f32):
        print(f"[time] bf16 Launch {launch} at {key}: kernel alone "
              f"{row['ms']:.5f} ms vs f32 {f32['ms']:.5f} ms (bf16/f32 = "
              f"{row['ms'] / f32['ms']:.3f}); bound "
              f"{row['bound_ms']:.5f} ms vs f32 {f32['bound_ms']:.5f} ms "
              f"(bf16 kernel/bound = {row['ms'] / row['bound_ms']:.1f})")
        rows[launch, key] = dict(row, f32_ms=f32["ms"])

    with bf16_pin(), torch.no_grad():
        program = hea_program(N_QUBITS, N_LAYERS, params["ansatz"]["rx"],
                              params["ansatz"]["rz"])
        for b in BUCKETS:
            x = torch.as_tensor(
                np.random.default_rng(b).uniform(0, 1, (b, N_QUBITS)),
                dtype=torch.float32, device=device,
            )
            state = bstate_product_tree(angle_amplitudes(x * math.pi))
            packed, spec, xs = kernel_inputs(state, N_QUBITS, program)
            require_cluster(spec, f"the bf16 served sweep at bucket {b}")
            if spec.dtype != "bfloat16":
                raise AssertionError(f"bucket {b} sweep is {spec.dtype}")
            got = [scan_body.scan_body(packed, spec, xs)]
            want = [scan_body.scan_body_plain(packed, spec, xs)]
            err, rel = _max_err(got, want), _rel_err(got, want)
            _require(rel, BF16_RTOL, f"bf16 kernel vs plain at bucket {b}")
            print(f"[time] bf16 bucket {b}: max|kernel-plain|={err:.3e}, "
                  f"||kernel-plain||/||plain||={rel:.3e} (rtol "
                  f"{BF16_RTOL:g})")
            row = time_launches(f"bf16 bucket {b}", packed, spec, xs, None,
                                None, None, {"A": err}, "A")["A", b]
            compare("A", f"bucket {b}", row, f32_times[b])
        rng = np.random.default_rng(31)
        rx, rz = (torch.as_tensor(rng.uniform(-2, 2, (N_LAYERS, N_QUBITS)),
                                  dtype=torch.float32, device=device)
                  for _ in range(2))
        hea = hea_program(N_QUBITS, N_LAYERS, rx, rz)
        cases = [("hea n=12 L=3 G=1 (evaluator)", hea, EVAL_BATCH, "A"),
                 ("hea n=12 L=3 G=4 (local step)",
                  hea_grouped_program(TRAIN_CLIENTS, 32, device),
                  TRAIN_CLIENTS * TRAIN_BATCH, "BC"),
                 ("hea n=12 L=3 G=1 (in-chunk evaluation)", hea, n_val,
                  "A"),
                 ("hea n=12 L=3 G=2 (training shape)",
                  hea_grouped_program(FED_CLIENTS, 35, device),
                  FED_CLIENTS * FED_BATCH, "BC")]
        for i, (name, prog, tb, launches) in enumerate(cases):
            packed, spec, xs = kernel_inputs(
                random_state(N_QUBITS, tb, device, seed=800 + i,
                             dtype=torch.bfloat16), N_QUBITS, prog)
            require_cluster(spec, f"bf16 {name}")
            aspec = scan_body._adjoint_spec(spec)
            axs = scan_body._adjoint_xs(spec, xs)
            cot = random_state(N_QUBITS, tb, device, seed=900 + i,
                               dtype=torch.bfloat16)
            cot = torch.stack([cot.re, cot.im]).reshape(packed.shape)
            errs = {}
            for launch in launches:
                bnd = launch != "A"
                st, sp, x_ = (cot, aspec, axs) if launch == "C" else (
                    packed, spec, xs)
                got = scan_body.scan_body(st, sp, x_, with_boundaries=bnd,
                                          adjoint=launch == "C")
                want = scan_body.scan_body_plain(st, sp, x_, bnd)
                got, want = (got, want) if bnd else ([got], [want])
                errs[launch] = _max_err(got, want)
                rel = _rel_err(got, want)
                print(f"[time] bf16 Launch {launch} at {name}: "
                      f"||kernel-plain||/||plain||={rel:.3e} (rtol "
                      f"{BF16_RTOL:g})")
                _require(rel, BF16_RTOL,
                         f"bf16 Launch {launch} vs plain at {name}")
            timed = time_launches(f"bf16 {name}", packed, spec, xs, cot,
                                  aspec, axs, errs, launches)
            for (launch, t), row in timed.items():
                f32 = (f32_train[launch] if t == FED_CLIENTS * FED_BATCH
                       else f32_rows[launch, t])
                compare(launch, f"tb={t}", row, f32)
    return rows


def phase_bf16_cli_train(root, shapes: dict, f32_run: dict) -> dict:
    """``[bf16-cli-train]``: CLI_ARGV under the pin on the card and on the
    CPU: each round exactly E·S_pad/B Launch-B and as many Launch-C
    launches, Launch A only from evaluation, every launch on the bf16
    instance, no build after round 1; per-round loss card vs CPU within
    BF16_LOSS_ATOL; the final accuracy within the reference's convergence band
    (``tests/test_bf16.py::test_convergence_parity_bf16``: 0.12 on an
    accelerator) of the same run in f32 (``[cli-train]``)."""
    from qfedx_tpu_torch.ops import scan_body

    argv = CLI_ARGV + ["--run-root", str(root), "--name", "smoke-bf16"]
    with bf16_pin():
        t0 = time.perf_counter()
        summary, launches, rounds, by_dtype = cli_train(argv, None)
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu_summary, _, _, _ = cli_train(
            CLI_ARGV + ["--run-root", str(root / "cpu"), "--name",
                        "smoke-bf16"], "cpu")
        cpu_wall = time.perf_counter() - t0
    run = root / "smoke-bf16"
    rows, cpu_rows = _rows(run), _rows(root / "cpu" / "smoke-bf16")
    print(f"[bf16-cli-train] QFEDX_DTYPE=bf16 {' '.join(argv)}: card "
          f"{wall:.2f} s, cpu {cpu_wall:.2f} s (host clock, in-process)")
    if [r["round"] for r in rows] != list(range(1, CLI_ROUNDS + 1)):
        raise AssertionError(f"bf16 metrics.jsonl rounds {rows}")
    for row, cpu, f32 in zip(rows, cpu_rows, f32_run["rows"]):
        loss_err = abs(row["loss"] - cpu["loss"])
        print(f"[bf16-cli-train] round {row['round']}: loss card "
              f"{row['loss']!r} cpu {cpu['loss']!r} |err|={loss_err:.3e} "
              f"(atol {BF16_LOSS_ATOL:g}), f32 card {f32['loss']!r}; accuracy "
              f"card {row['accuracy']!r} cpu {cpu['accuracy']!r} f32 card "
              f"{f32['accuracy']!r} (n={row['n']}); time_s "
              f"{row['time_s']:.4f}")
        _require(loss_err, BF16_LOSS_ATOL,
                 f"bf16 round {row['round']} loss")
    steps = shapes["steps"]
    want_round = {"fwd": 0, "fwd_bnd": steps, "adj": steps}
    evals = _batches(shapes["n_val"]) * (1 + CLI_ROUNDS) + _batches(
        shapes["n_test"])
    want = {"fwd": evals, "fwd_bnd": CLI_ROUNDS * steps,
            "adj": CLI_ROUNDS * steps}
    print(f"[bf16-cli-train] launches {launches} (expected {want}), by "
          f"dtype {by_dtype}; per round {[c for c, _ in rounds]}; builds "
          f"after each round {[b for _, b in rounds]}")
    if [c for c, _ in rounds] != [want_round] * CLI_ROUNDS:
        raise AssertionError(f"bf16 rounds launched {rounds}")
    if launches != want:
        raise AssertionError(f"the bf16 run launched {launches}")
    if by_dtype != {"float32": 0, "bfloat16": sum(want.values())}:
        raise AssertionError(f"the bf16 run ran instances {by_dtype}")
    if len({b for _, b in rounds}) != 1 or scan_body.build_count != rounds[
            0][1]:
        raise AssertionError("the kernel library was built after round 1")
    acc, acc_f32 = summary["final_accuracy"], f32_run["summary"][
        "final_accuracy"]
    print(f"[bf16-cli-train] final accuracy bf16 {acc!r} (cpu bf16 "
          f"{cpu_summary['final_accuracy']!r}), f32 {acc_f32!r}: band "
          "bf16 >= f32 - 0.12")
    if not acc >= acc_f32 - 0.12:
        raise AssertionError(f"bf16 final accuracy {acc} below the f32 "
                             f"run's {acc_f32} - 0.12")
    return {"run": run, "launches": launches}


# --- the dense engine (below n = 10, QFEDX_BATCHED=0, remat) -----------------

# The reference CLI's defaults: n = 8, L = 2, classes 0,1,2 (no --qubits).
DENSE_ARGV = ["train", "--model", "vqc", "--clients", "4", "--rounds",
              str(CLI_ROUNDS), "--checkpoint-every", "1"]
# BASELINE.md config 1: a 4-qubit VQC, binary MNIST, 2 clients.
CONFIG1_ARGV = ["train", "--model", "vqc", "--qubits", "4", "--classes", "0,1",
                "--clients", "2", "--rounds", str(CLI_ROUNDS),
                "--checkpoint-every", "1"]
REMAT_ATOL = 1e-6  # remat vs the same per-layer route without checkpoints
NO_LAUNCH = {"fwd": 0, "fwd_bnd": 0, "adj": 0}


def _run_shape(argv) -> tuple:
    """(qubits, layers, classes, clients) the CLI builds from ``argv``."""
    from qfedx_tpu_torch.run import cli

    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    return (cfg.model.n_qubits, cfg.model.n_layers, len(cfg.data.classes),
            cfg.data.num_clients)


def phase_dense_cli_train(root, argv, name: str, tag: str,
                          dtype=torch.float32, f32_run=None) -> dict:
    """``python -m qfedx_tpu_torch train`` (in-process) below the slab
    widths on the card, then the same argv on the CPU: a complete run
    directory, the model on the "vmap" engine, no scan-body launch and no
    kernel build; per-round loss card vs CPU within TRAINED_LOGIT_ATOL
    (bf16: BF16_LOSS_ATOL), in f32 the final θ within TRAINED_LOGIT_ATOL
    and accuracy within one evaluation sample; in bf16 the final accuracy
    within 0.12 of the f32 run's (``f32_run``)."""
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.run.checkpoint import Checkpointer

    n, layers, classes, clients = _run_shape(argv)
    bf = _is_bf16(dtype)
    builds = scan_body.build_count
    t0 = time.perf_counter()
    summary, launches, rounds, _ = cli_train(
        argv + ["--run-root", str(root), "--name", name], None)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_summary, _, _, _ = cli_train(
        argv + ["--run-root", str(root / "cpu"), "--name", name], "cpu")
    cpu_wall = time.perf_counter() - t0
    run, cpu_run = root / name, root / "cpu" / name
    template = make_vqc_classifier(n, layers, classes, device="cpu")
    print(f"{_tag(tag, dtype)} {' '.join(argv)}: n={n} L={layers} "
          f"classes={classes} clients={clients}, engine "
          f"{template.engine()}; card {wall:.2f} s, cpu {cpu_wall:.2f} s "
          "(host clock, in-process)")
    if template.engine() != "vmap":
        raise AssertionError(f"n={n} runs the {template.engine()} engine")
    for f in ("config.json", "metrics.jsonl", "summary.json"):
        if not (run / f).is_file():
            raise AssertionError(f"run directory lacks {f}")
    ckpt = Checkpointer(run / "checkpoints", every=1)
    for r in range(1, CLI_ROUNDS + 1):
        ckpt.verify(r)
    rows, cpu_rows = _rows(run), _rows(cpu_run)
    if [r["round"] for r in rows] != list(range(1, CLI_ROUNDS + 1)):
        raise AssertionError(f"metrics.jsonl rounds {rows}")
    loss_atol = BF16_LOSS_ATOL if bf else TRAINED_LOGIT_ATOL
    for row, cpu in zip(rows, cpu_rows):
        loss_err = abs(row["loss"] - cpu["loss"])
        acc_err = abs(row["accuracy"] - cpu["accuracy"])
        print(f"{_tag(tag, dtype)} round {row['round']}: loss card "
              f"{row['loss']!r} cpu {cpu['loss']!r} |err|={loss_err:.3e} "
              f"(atol {loss_atol:g}), accuracy card {row['accuracy']!r} cpu "
              f"{cpu['accuracy']!r} (n={row['n']}), time_s "
              f"{row['time_s']:.4f} (host clock, drain to drain)")
        _require(loss_err, loss_atol, f"{tag} round {row['round']} loss")
        if not bf:
            _require(acc_err, 1.0 / row["n"] + 1e-12,
                     f"{tag} round {row['round']} accuracy, card vs cpu")
    theta = ckpt.restore(CLI_ROUNDS, template.init(0))
    cpu_theta = Checkpointer(cpu_run / "checkpoints").restore(
        CLI_ROUNDS, template.init(0))
    theta_err = _max_err(
        [v for d in theta.values() for v in d.values()],
        [v for d in cpu_theta.values() for v in d.values()])
    print(f"{_tag(tag, dtype)} final theta max|card-cpu|={theta_err:.3e}; "
          f"launches {launches} per round {[c for c, _ in rounds]}, kernel "
          f"builds {scan_body.build_count - builds}; summary card "
          f"{json.dumps(summary)}; cpu final_accuracy "
          f"{cpu_summary['final_accuracy']!r}")
    if not bf:
        _require(theta_err, TRAINED_LOGIT_ATOL, f"{tag} final theta")
    if launches != NO_LAUNCH or any(c != NO_LAUNCH for c, _ in rounds):
        raise AssertionError(f"the dense run launched {launches}")
    if scan_body.build_count != builds:
        raise AssertionError("the dense run built the kernel library")
    if bf:
        acc, acc_f32 = summary["final_accuracy"], f32_run["summary"][
            "final_accuracy"]
        print(f"{_tag(tag, dtype)} final accuracy bf16 {acc!r}, f32 "
              f"{acc_f32!r}: band bf16 >= f32 - 0.12")
        if not acc >= acc_f32 - 0.12:
            raise AssertionError(f"bf16 final accuracy {acc} below the f32 "
                                 f"run's {acc_f32} - 0.12")
    return {"run": run, "rows": rows, "summary": summary,
            "launches": launches, "theta_err": theta_err, "clients": clients,
            "shapes": expected_shapes(argv),
            "shape": (n, layers, classes), "times": [r["time_s"] for r in
                                                     rows]}


def _client_batch(n: int, layers: int, classes: int, clients: int,
                  batch: int, device, seed: int):
    """Seeded per-client parameters (C, …) spread from one init, and a
    (C, B, n) batch with labels: one folded local step's inputs."""
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier

    rng = np.random.default_rng(seed)
    base = make_vqc_classifier(n, layers, classes, init_scale=1.0,
                               device=device).init(seed)
    leaves = {g: {k: (v[None] + torch.as_tensor(
        0.1 * rng.normal(size=(clients,) + tuple(v.shape)),
        dtype=torch.float32, device=device)).contiguous()
        for k, v in d.items()} for g, d in base.items()}
    xb = torch.as_tensor(rng.uniform(0, 1, (clients, batch, n)),
                         dtype=torch.float32, device=device)
    yb = torch.as_tensor(rng.integers(0, classes, (clients, batch)),
                         device=device)
    return base, leaves, xb, yb


def _step_grads(model, leaves, xb, yb) -> list:
    """Gradients of one folded local step's loss (Σ_c mean-CE_c) with
    respect to every leaf, in sorted leaf order."""
    from qfedx_tpu_torch.fed.client import _cross_entropy

    p = {g: {k: v.detach().requires_grad_(True) for k, v in d.items()}
         for g, d in leaves.items()}
    flat = [p[g][k] for g in sorted(p) for k in sorted(p[g])]
    loss = _cross_entropy(model.apply_clients(p, xb), yb).mean(1).sum()
    return list(torch.autograd.grad(loss, flat))


def phase_dense_route(device) -> dict:
    """``[dense-route]``: the n=12 L=3 VQC under QFEDX_BATCHED=0 (the
    dense engine, its state reshaped to the batched slab) against the
    batched route on the card: served logits at the bucket 32 and one
    folded local step's gradients (4 clients x 32) within LOGIT_ATOL and
    GRAD_ATOL, and the same Launch A/B/C counts."""
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.ops import scan_body

    model = make_vqc_classifier(N_QUBITS, N_LAYERS, N_CLASSES)
    params, leaves, xb, yb = _client_batch(
        N_QUBITS, N_LAYERS, N_CLASSES, TRAIN_CLIENTS, TRAIN_BATCH, device, 19)
    x = torch.as_tensor(np.random.default_rng(20).uniform(
        0, 1, (BUCKETS[-1], N_QUBITS)), dtype=torch.float32, device=device)

    def run():
        scan_body.reset_counts()
        with torch.no_grad():
            logits = model.apply(params, x)
        served = dict(scan_body.launch_counts)
        scan_body.reset_counts()
        grads = _step_grads(model, leaves, xb, yb)
        torch.cuda.synchronize()
        return logits, grads, served, dict(scan_body.launch_counts), \
            model.engine()

    batched = run()
    with env_pins(QFEDX_BATCHED="0"):
        dense = run()
    logit_err = _max_err([dense[0]], [batched[0]])
    grad_err = _max_err(dense[1], batched[1])
    print(f"[dense-route] n={N_QUBITS} L={N_LAYERS}: engines {dense[4]} "
          f"(QFEDX_BATCHED=0) vs {batched[4]}; served logits at tb="
          f"{BUCKETS[-1]} max|dense-batched|={logit_err:.3e} (atol "
          f"{LOGIT_ATOL:g}), local step ({TRAIN_CLIENTS} clients x "
          f"{TRAIN_BATCH}) gradients {grad_err:.3e} (atol {GRAD_ATOL:g}); "
          f"launches served {dense[2]} vs {batched[2]}, step {dense[3]} vs "
          f"{batched[3]}")
    if (dense[4], batched[4]) != ("vmap", "batched"):
        raise AssertionError(f"engines {dense[4]}, {batched[4]}")
    _require(logit_err, LOGIT_ATOL, "dense-route served logits")
    _require(grad_err, GRAD_ATOL, "dense-route local-step gradients")
    if dense[2:4] != batched[2:4] or batched[2]["fwd"] != 1 or \
            batched[3]["fwd_bnd"] != 1 or batched[3]["adj"] != 1:
        raise AssertionError(f"dense-route launches {dense[2:4]} vs "
                             f"{batched[2:4]}")
    return {"served": dense[2], "step": dense[3]}


def phase_remat(device) -> dict:
    """``[remat]``: one folded local step (4 clients x 32) with
    ``remat=True`` at n=8 (L=2) and n=12 (L=3): gradients against the same
    per-layer route without checkpoints (QFEDX_SCAN_LAYERS=0,
    QFEDX_BATCHED=0) within REMAT_ATOL and against the default route (at
    n=12 the kernel's) within GRAD_ATOL; each run's peak device memory
    (``torch.cuda.max_memory_allocated`` after a reset) printed."""
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.ops import scan_body

    out = {}
    for n, layers in ((8, 2), (N_QUBITS, N_LAYERS)):
        _, leaves, xb, yb = _client_batch(n, layers, N_CLASSES,
                                          TRAIN_CLIENTS, TRAIN_BATCH,
                                          device, 21 + n)
        runs = {}
        for name, remat, pins in (
            ("remat", True, {}),
            ("per-layer", False, {"QFEDX_SCAN_LAYERS": "0",
                                  "QFEDX_BATCHED": "0"}),
            ("default", False, {}),
        ):
            with env_pins(**pins):
                model = make_vqc_classifier(n, layers, N_CLASSES,
                                            remat=remat)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                start = torch.cuda.memory_allocated()
                scan_body.reset_counts()
                grads = _step_grads(model, leaves, xb, yb)
                torch.cuda.synchronize()
                runs[name] = (grads, torch.cuda.max_memory_allocated(),
                              start, dict(scan_body.launch_counts),
                              model.engine())
        e_layer = _max_err(runs["remat"][0], runs["per-layer"][0])
        e_default = _max_err(runs["remat"][0], runs["default"][0])
        print(f"[remat] n={n} L={layers}: gradients max|remat-per-layer|="
              f"{e_layer:.3e} (atol {REMAT_ATOL:g}), max|remat-default|="
              f"{e_default:.3e} (atol {GRAD_ATOL:g}); " + "; ".join(
                  f"{k} ({r[4]}, launches {r[3]}): max_memory_allocated "
                  f"{r[1]} B ({r[1] - r[2]} B above the {r[2]} B before)"
                  for k, r in runs.items()))
        _require(e_layer, REMAT_ATOL, f"remat vs per-layer at n={n}")
        _require(e_default, GRAD_ATOL, f"remat vs default route at n={n}")
        if runs["remat"][3] != NO_LAUNCH or runs["remat"][4] != "vmap":
            raise AssertionError(f"remat at n={n} ran {runs['remat'][3:]}")
        out[n] = {k: r[1] - r[2] for k, r in runs.items()}
    return out


def _profile_forward(fn, device, iters: int = 10) -> tuple:
    """(device kernels per call, copies and sets per call, the device ms
    of both per call, host ms per call) of ``fn`` under
    ``torch.profiler``. On the card a trace with no device event raises;
    a CPU rehearsal gets (None, None, None, host): not measured."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    on_card = device.type == "cuda"
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if on_card else [])) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / iters * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [e for e in events if not e.name.startswith(("Memcpy",
                                                           "Memset"))]
    if not events:
        if on_card:
            raise RuntimeError("[time] dense: the profiler's trace holds no "
                               "device event")
        return None, None, None, host
    device_us = sum(e.time_range.elapsed_us() for e in events)
    return (len(kernels) / iters, (len(events) - len(kernels)) / iters,
            device_us / iters / 1e3, host)


def phase_dense_times(device) -> dict:
    """``[time] dense``: the n=8 L=2 served forward (``ServeEngine``, seeded
    weights, 3 classes) at buckets 1/8/32 on the host clock (fetch
    included), with the profiler's device kernels per forward and their
    device time; then one folded local step at the CLI's shape (4 clients
    x 32, SGD lr 0.01) split into forward, backward and optimizer."""
    from qfedx_tpu_torch.fed.config import FedConfig
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.serve import ServeConfig, ServeEngine

    n, layers, classes, clients = _run_shape(DENSE_ARGV)
    model = make_vqc_classifier(n, layers, classes, init_scale=1.0)
    engine = ServeEngine(model, model.init(0), (n,),
                         config=ServeConfig(buckets=BUCKETS))
    engine.warmup()
    rows = {}
    for b in BUCKETS:
        xb = np.random.default_rng(b).uniform(0, 1, (b, n)).astype(
            np.float32)
        engine._forward(xb)
        t0 = time.perf_counter()
        for _ in range(20):
            engine._forward(xb)
        fwd_ms = (time.perf_counter() - t0) / 20 * 1e3
        kernels, copies, dev_ms, host_ms = _profile_forward(
            lambda: engine._forward(xb), device)
        prof = ("profiler: CPU rehearsal (not measured)"
                if kernels is None else
                f"profiler: {kernels:g} device kernels and {copies:g} "
                f"copies/sets per forward, {dev_ms:.5f} ms of device time "
                f"against {host_ms:.4f} ms of host clock per forward under "
                f"the profiler ({100 * dev_ms / host_ms:.2f}% busy)")
        rows[b] = {"forward_ms": fwd_ms, "kernels": kernels,
                   "device_ms": dev_ms, "profiled_host_ms": host_ms}
        print(f"[time] dense served forward n={n} L={layers} at bucket {b}: "
              f"{fwd_ms:.4f} ms (host clock, mean of 20, fetch included); "
              f"{prof}")
    _, leaves, xb, yb = _client_batch(n, layers, classes, clients,
                                      TRAIN_BATCH, device, 23)
    rows["step"] = local_step_split(
        model, leaves, xb, yb, FedConfig(),
        f"dense one local step at the CLI's shape (n={n}, {clients} clients "
        f"x {TRAIN_BATCH}, SGD lr 0.01)")
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
    grad_err = phase_grad_parity(device)
    served = phase_serve(device)
    times = phase_times(device, served["engine"])
    phase_breakdown(device, served["engine"].params)
    trained = phase_train(device)
    train_times = phase_train_times(device, trained)
    cli_shapes = expected_shapes(CLI_ARGV)
    shapes = phase_trainer_shapes(device, cli_shapes["n_val"])
    bf16 = torch.bfloat16
    bf16_worst = phase_kernel_parity(device, bf16)
    bf16_grad_err = phase_grad_parity(device, bf16)
    bf16_tiles = phase_bf16_tiles(device)
    bf16_served = phase_bf16_serve(device, served)
    bf16_times = phase_bf16_times(device, bf16_served["params"], times,
                                  shapes["rows"], train_times,
                                  cli_shapes["n_val"])
    phase_breakdown(device, bf16_served["params"], bf16,
                    BUCKETS + (EVAL_BATCH,))
    root = Path(tempfile.mkdtemp(prefix="qfedx-smoke-"))
    try:
        cli_run = phase_cli_train(root, cli_shapes)
        chunked = phase_cli_chunked(root, cli_run)
        rate = phase_cli_rate(root, cli_run)
        cli_served = phase_cli_serve(root, cli_run["run"])
        bf16_cli = phase_bf16_cli_train(root, cli_shapes, cli_run)
        with bf16_pin():
            bf16_cli_served = phase_cli_serve(root, bf16_cli["run"], bf16)
        dense_run = phase_dense_cli_train(root, DENSE_ARGV, "dense",
                                          "dense-cli-train")
        phase_cli_chunked(root, dense_run, DENSE_ARGV, "dense-cli-chunked",
                          NO_LAUNCH)
        dense_rate = phase_cli_rate(root, dense_run, DENSE_ARGV,
                                    "dense-cli-rate", NO_LAUNCH)
        dense_served = phase_cli_serve(root, dense_run["run"],
                                       shape=dense_run["shape"],
                                       tag="dense-cli-serve")
        config1 = phase_dense_cli_train(root, CONFIG1_ARGV, "config1",
                                        "dense-config1")
        phase_cli_serve(root, config1["run"], shape=config1["shape"],
                        tag="dense-config1")
        with bf16_pin():
            phase_dense_cli_train(root, DENSE_ARGV, "dense-bf16",
                                  "dense-cli-train", bf16, dense_run)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    dense_route = phase_dense_route(device)
    remat = phase_remat(device)
    dense_times = phase_dense_times(device)
    source = "qfedx_tpu_torch/ops/csrc/scan_body.cu"
    kernel = "qfedx_tpu/ops/pallas_body.py:401"
    by_path = {
        "serve": {"fwd": served["launches"], "fwd_bnd": 0, "adj": 0},
        "train": trained["launches"],
        "cli-train": cli_run["launches"],
        "cli-chunked": chunked["launches"],
        "cli-rate": rate["launches"],
        "cli-serve": cli_served["launches"],
        "dense-route-serve": dense_route["served"],
        "dense-route-step": dense_route["step"],
        "dense-cli-train (n=8)": dense_run["launches"],
    }
    keys = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err")

    def entry(name, launch, key, replaces, earlier, earlier_shape, tb):
        # ms/plain_ms/bound_ms at the main path's shape (the CLI run's,
        # tb); the other shapes held here and the earlier slices' stay
        # under "shapes".
        row = shapes["rows"][launch, tb]
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": f"{kernel} via _run :491 from {replaces}",
            "launches": cli_run["launches"][key],
            "max_abs_err": max(shapes["worst"][launch],
                               earlier["max_abs_err"], worst[launch]),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "bound_by")},
            "library_ms": None,
            "launches_by_path": {p: c[key] for p, c in by_path.items()},
            "shapes": {**{f"tb={t}": {k: r[k] for k in keys}
                          for (l, t), r in shapes["rows"].items()
                          if l == launch},
                       earlier_shape: {k: earlier[k] for k in keys
                                       if k in earlier}},
        }

    bf16_paths = {
        "bf16-serve": {"fwd": bf16_served["launches"], "fwd_bnd": 0,
                       "adj": 0},
        "bf16-cli-train": bf16_cli["launches"],
        "bf16-cli-serve": bf16_cli_served["launches"],
    }

    def bf16_entry(name, launch, key, replaces, tb):
        # The bf16 instance (tensor-core products) at the bf16 CLI run's
        # shape; the other shapes under "shapes".
        row = bf16_times[launch, f"tb={tb}"]
        return {
            "name": name,
            "route": "cuda",
            "source": source,
            "replaces": f"{kernel} via _run :491 from {replaces} "
                        "(its bf16 instance: _run :498, _emit :279-282)",
            "launches": bf16_cli["launches"][key],
            "max_abs_err": max(bf16_worst[launch], bf16_tiles[launch],
                               *(r["max_abs_err"] for (lk, _), r in
                                 bf16_times.items() if lk == launch)),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "bound_by")},
            "library_ms": None,
            "launches_by_path": {p: c[key] for p, c in bf16_paths.items()},
            "shapes": {s: {k: r[k] for k in keys + ("f32_ms",)}
                       for (lk, s), r in bf16_times.items() if lk == launch},
        }

    kernels = {"kernels": [
        entry("scan_body Launch A (forward)", "A", "fwd", "_pallas_scan :618",
              dict(times[BUCKETS[-1]], max_abs_err=max(
                  r["max_abs_err"] for r in times.values())),
              f"bucket {BUCKETS[-1]}", EVAL_BATCH),
        entry("scan_body Launch B (forward with boundaries)", "B", "fwd_bnd",
              "_pallas_scan_fwd :624", train_times["B"], "tb=32 G=2",
              TRAIN_CLIENTS * TRAIN_BATCH),
        entry("scan_body Launch C (adjoint sweep)", "C", "adj",
              "_pallas_scan_bwd :629", train_times["C"], "tb=32 G=2",
              TRAIN_CLIENTS * TRAIN_BATCH),
        bf16_entry("scan_body Launch A bf16 (forward)", "A", "fwd",
                   "_pallas_scan :618", EVAL_BATCH),
        bf16_entry("scan_body Launch B bf16 (forward with boundaries)", "B",
                   "fwd_bnd", "_pallas_scan_fwd :624",
                   TRAIN_CLIENTS * TRAIN_BATCH),
        bf16_entry("scan_body Launch C bf16 (adjoint sweep)", "C", "adj",
                   "_pallas_scan_bwd :629", TRAIN_CLIENTS * TRAIN_BATCH),
    ]}
    print(f"[summary] gradient max|kernel-plain| {grad_err:.3e}; trained "
          f"logits max|card-cpu| {trained['logit_err']:.3e}; round loss "
          f"max|card-cpu| {trained['loss_err']:.3e}; CLI run theta "
          f"max|card-cpu| {cli_run['theta_err']:.3e}; CLI round rate "
          f"{rate['rate']:.4f} client-rounds/s; served logits of the "
          "trained run "
          f"max|card-cpu| {cli_served['logit_err']:.3e}")
    print(f"[summary] dense: n=8 CLI run theta max|card-cpu| "
          f"{dense_run['theta_err']:.3e}, round rate {dense_rate['rate']:.4f} "
          f"client-rounds/s, served logits max|card-cpu| "
          f"{dense_served['logit_err']:.3e}; config 1 theta "
          f"{config1['theta_err']:.3e}; remat peak memory above the start "
          f"(B) {remat}; served forward at buckets "
          + ", ".join(f"{b}: {dense_times[b]['forward_ms']:.4f} ms"
                      for b in BUCKETS))
    print(f"[summary] bf16: kernel max|kernel-plain| A "
          f"{bf16_worst['A']:.3e} B {bf16_worst['B']:.3e} C "
          f"{bf16_worst['C']:.3e} (relative norm {bf16_worst['rel']:.3e});"
          f" gradient relative norm "
          f"{bf16_grad_err:.3e}; tile paths: relative norm "
          f"{bf16_tiles['rel']:.3e}, gradients {bf16_tiles['grad']:.3e}; "
          "served logits max|card-cpu| "
          f"{bf16_served['logit_err']:.3e} (vs the f32 logits "
          f"{bf16_served['f32_diff']:.3e}); trained run served "
          f"max|card-cpu| {bf16_cli_served['logit_err']:.3e}")
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

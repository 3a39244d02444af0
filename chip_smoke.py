"""On-card smoke of the PyTorch/CUDA port: build, check, serve, train, time.

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

For a rehearsal of the tuning and tool phases alone (item 21 below),
``python3 chip_smoke.py --only tune,sweep`` (any of ``TOOL_PHASES``; a
phase that reads another's output brings it along) builds the kernel,
trains one traced and profiled [cli-train] run on the card to read from,
and runs those phases; ``--only mesh-round,sv-sharded`` (any of
``MESH_PHASES``, item 22) builds the kernel and runs those; ``--only
lint`` runs item 23 alone (no build: lint launches no kernel). A
selected run prints no ``kernels`` line and no final line.

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
   this process, so that the counters can be read) on the card and its
   first CPU_TWIN_ROUNDS round(s) on the CPU: a complete run directory
   (config.json, schema-1 metrics.jsonl rows, summary.json, checkpoints
   whose sha256 verify), those rounds' loss and θ card vs CPU within
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
14. the reupload and amplitude encodings and secure aggregation (the
   CLI runs of phases 14, 15 and 17 run their first CPU_TWIN_ROUNDS
   round(s) on the CPU, held against the same rounds on the card):
   ``[reupload-parity]`` (and its bf16 twin) holds Launches A, B and C
   against their plain versions on the port's own reupload programs —
   served (per-sample stacks, G = tb) at n = 10, 12, 15 for tb = 1, 8,
   32 and n = 16 at tb = 8, folded (per-sample beside per-client stacks)
   at (C, B) = (2, 16) and (4, 8) — and ``ScanBodyFn``'s cotangents
   (``[reupload-grad]``: the per-sample coefficient cotangents come back
   as (L−1, tb, …) stacks) against plain autograd, and times A, B and C
   at the (2, 16) fold; ``[reupload-serve]`` serves 256 requests of
   ``make_vqc_classifier(12, 3, 2, encoding="reupload")`` (logits within
   LOGIT_ATOL of the CPU port, exactly one Launch A per batch, no build
   after warmup) and times A at each bucket's served program;
   ``[reupload-cli-train]`` runs REUPLOAD_ARGV on the card and the CPU
   (E·S_pad/B Launch B and as many C per round, no A: the evaluator's
   tb = 256 leaves a stacked g1, as in the reference) and
   ``[reupload-cli-serve]`` serves it; ``[amplitude-cli-train]`` and
   ``[amplitude-cli-serve]`` do the same for AMPLITUDE_ARGV (n = 11 on
   CIFAR-10, the widest the data allow; A in every evaluation);
   ``[config4]`` runs BASELINE.md config 4 (CONFIG4_ARGV: 64 clients,
   ring masks), the same with pairwise masks and without masks, on the
   card, and one round of one local step of it on the card and the CPU:
   masked runs equal the unmasked one within MASK_ATOL, the card the CPU
   within TRAINED_LOGIT_ATOL, no kernel launch, and each round's wall
   and client-rounds/s;
15. the rest of the federation options: ``[dp-client]`` runs
   DP_CLIENT_ARGV (client-mode DP, ``--client-fraction 0.5``) on the card
   and the CPU (loss and θ within TRAINED_LOGIT_ATOL, ε per row and
   final_epsilon equal, one B and one C per local step, A in
   evaluation, no build after round 1); ``[spsa]`` runs SPSA_ARGV (one
   Launch A per local step on θ ± cΔ as 2C client groups, no B or C) and
   holds and times A on that forward's program; ``[dp-example]`` runs
   DP_EXAMPLE_ARGV (per-example DP, C = 2, B = 16: one B and one C per
   step on 32 one-sample groups) and holds A, B, C and ScanBodyFn's
   cotangents on that per-sample program (G = tb), timing B and C;
   ``[config2]`` runs BASELINE.md config 2 (CONFIG2_ARGV: n = 8, eight
   classes, 10 Dirichlet clients, DP-SGD σ = 1.4) on the card and the CPU
   (no launch, θ within TRAINED_LOGIT_ATOL, a finite final_epsilon equal
   to the CPU's, round walls and client-rounds/s); ``[robust]`` runs
   library rounds at n = 12 under mean, trimmed_mean, median and
   clip_mean with a byzantine input (and one absent client) on the card
   and the CPU (θ within ROUND_ATOL, the ledgers equal, each rule closer
   to the honest round than plain mean, NaN sorted last on the card);
16. the other model families, on which no kernel runs in either
   package (cuDNN convolutions, batched ``torch.linalg.svd`` and
   elementwise torch instead): ``[cnn]`` holds the TinyCNN at 28×28×1 and
   32×32×3 card vs CPU (logits, ``apply_train`` under a fixed keep mask,
   one step's gradients; CNN_ATOL) under the process's TF32 settings,
   printing them and whether its convolutions rounded to TF32, and times
   config 3's step; ``[config3]`` trains BASELINE.md config 3
   (CONFIG3_ARGV: TinyCNN, synthetic CIFAR-10, 32 clients, FedProx) on
   the card and the CPU (loss and θ within CNN_ATOL, one client at a
   time, 0 launches, round walls and client-rounds/s) and serves it (64
   image requests and a malformed line); ``[config5]`` trains BASELINE.md
   config 5 (CONFIG5_ARGV: the 20-qubit kernel head, 256 clients) on the
   folded route (QKERNEL_ATOL); ``[mps]`` holds the MPS at n = 8, χ = 16
   against the dense statevector on the card (MPS_Z_ATOL,
   MPS_GRAD_ATOL), counts and times the batched SVDs of an n = 24
   forward and says whether each synchronises the host, and trains
   MPS_ARGV (n = 24, χ = 16) card vs CPU (MPS_CLI_ATOL, every update
   finite);
17. noise on the VQC: ``[noise-readout]`` trains NOISE_ARGV (n = 12,
   L = 3, depolarizing, damping, readout flip, 1024 shots, readout
   placement) on the card and the CPU (loss and θ within
   TRAINED_LOGIT_ATOL, one Launch A per client per local step, A in
   evaluation, the ansatz leaves of every checkpoint equal to their
   initial values: shot counts carry no gradient) and serves it
   (``[noise-readout-serve]``: logits within LOGIT_ATOL, one A per batch
   and per warmed bucket); ``[noise-circuit]`` does the same under
   ``--noise-placement circuit`` (no launch in a local step, the Kraus
   branch choices that differ card vs CPU printed, round time and
   client-rounds/s) and serves it on the composed strengths;
   ``[noise-trajectory]`` holds 4096 trajectories of depolarizing and of
   damping at n = 12 within TRAJECTORY_SIGMAS of the analytic ⟨Z⟩ map,
   their first TRAJECTORY_TWINS against the CPU; ``[noise-probe]`` counts
   the launches of one evaluation and one local step under each noise
   mode (NOISE_PROBE, the port's column of the CPU test's probe);
18. streamed waves and staleness (``run/trainer.
   train_federated_streamed``): ``[streamed]`` trains bench.py's streamed
   row at full size (a 2^20-client ``SyntheticRegistry``, cohort 4096 in
   16 waves of 256, the n = 8, L = 3 VQC, Adam, client fraction 0.5,
   ring masks; depth 1) for 3 rounds — no kernel launch, every update
   finite — printing each round's wall, client-rounds/s over the rounds
   after the first, comm_mb_per_round, the peak device memory and the
   sync/overlap ratio against 2 rounds at QFEDX_STREAM=0; one round of
   a cohort of 512 (2 waves) on the card and the CPU agrees on the
   logits and the loss within TRAINED_LOGIT_ATOL;
   ``[streamed-kernel]`` trains the n = 12, L = 3 VQC (cohort 256 of a
   2^16-client registry in waves of 32, batch 8, 3 rounds): exactly one
   Launch B and one C per wave per local step, A only in evaluation, no
   build after round 1, the logits and loss of one round of a cohort of
   64 card vs CPU within TRAINED_LOGIT_ATOL (θ printed:
   one Adam step is a sign step on the zero-gradient angles), and A, B
   and C held and B and C timed on a wave's own program; ``[streamed-stale]`` runs QFEDX_STALE=1 at n = 12
   (cohort 64 in waves of 16) with one wave of round 1 held past the
   0.5 s wave deadline by a gated registry and released when round 1
   ends (late in round 1, folded in at age 1 in round 2; SGD, θ card vs
   CPU within TRAINED_LOGIT_ATOL), then a registry that fails one wave
   under ring masks (the wave dropped; θ within MASK_ATOL of the round
   with its clients as non-survivors and no masks);
19. fault plans (``utils/faults.FaultPlan`` at the port's seams):
   ``[chaos]`` trains bench.py's fault_tolerance row at its 20% point
   (a 2^18-client registry, cohort 128 in waves of 64, n = 8, L = 3,
   Adam, ring masks, 10% drops and 10% NaN clients) for 3 rounds — no
   launch, θ finite, each row's dropped/rejected/participants equal to
   the plan's draws, its round 0 card vs CPU within TRAINED_LOGIT_ATOL;
   ``[chaos-kernel]`` trains the n = 12 VQC in 8 waves of 32 under
   clip_mean with one drop, one NaN, one Inf, one scale:100 and one
   label_flip client a round and a transient registry.fetch and
   ingest.h2d fault: one B and one C per wave per step, the ledger
   (clipped_clients included) equal to the plan's, and one round of a
   32-client cohort (one wave) card vs CPU: under SGD with the whole
   plan θ within TRAINED_LOGIT_ATOL, under Adam without the attacker the
   logits (with it printed only);
   ``[chaos-isolation]`` and ``[bf16-chaos-isolation]`` hold a wave's
   partial with a NaN client against the same wave with that client
   dropped (Δ sums within ISOLATION_ATOL, counts apart only in rejected
   vs dropped) and the kernel's A, B and C on the poisoned wave's
   program (the NaN rows stay NaN, the others agree with plain);
   ``[chaos-straggler]`` declares round 0's second wave late (delay
   0.5 s, deadline 0.05 s) under QFEDX_STALE and folds it in round 1,
   card vs CPU; ``[chaos-serve]`` serves [serve]'s 256 requests with 10%
   corrupted (each rejected alone, as planned) and one failed compute
   (retried), the rest equal to the clean engine's logits, no build after
   warmup, p50/p95 printed; ``[chaos-checkpoint]`` recovers a failed
   async checkpoint write and ``[sigterm]`` stops a run at a SIGTERM
   raised when round 1 ends (the last completed round checkpointed, the
   handler restored) and resumes it to the uninterrupted run's θ;
20. observability (``qfedx_tpu_torch/obs``): ``[obs-train]`` runs
   [cli-train]'s argv with ``--trace --profile``: ``trace.json`` with its
   device lane and ``profile_summary.json`` written, the profiler's
   scan-body kernel events by launch kind (``obs.profile.
   kernel_launches``) equal to the wrapper's launches inside the
   capture, the launches and θ equal to [cli-train]'s untraced run
   (θ within OBS_THETA_ATOL), and the first device timeline of the
   n = 12 round printed: busy share under the profiler, top device ops,
   inter-op gaps, device time per phase; ``[obs-serve]`` serves
   [cli-serve]'s requests from that run with ``--trace``, the /metrics
   endpoint on a free port, the watchdog and the flight recorder on and
   the p95 SLO set below any latency, under a profiler capture, fed
   through a FIFO so that ``qfedx_serve_batches`` is scraped mid-stream
   against the Launch A count, ``serve.p95_slo`` is named on /healthz
   (503) and ``flight.json`` dumped; the profiler's Launch A events equal
   the warmup's plus one per served batch; the logits equal
   [cli-serve]'s, no build after warmup, the histogram's p50/p95 beside
   the exact ones and the served stream's device timeline printed;
   ``[obs-streamed]`` runs one round of [chaos-kernel]'s shape untraced
   and traced: the same launches and θ (within OBS_THETA_ATOL), the
   ``faults.injected.*`` counters equal to the plan's injected errors,
   the ``fed.*`` counters to its ledger, one ``ingest.h2d`` span per
   wave;
21. tuning and the tools, on [obs-train]'s run directory: ``[tune]``
   sweeps two bucket sets × two deadlines through ``tune --run-dir``,
   TUNE_REQUESTS requests at each offered load (every cell warms without a build and launches one A per forward, the
   warmed buckets plus the batches served, each at a warmed bucket;
   each cell's throughput_at_slo, p50/p95 and capacity printed);
   ``[serve-tuned]`` replays the sidecar (its buckets served, logits
   within LOGIT_ATOL of the CPU port); ``[tune-controller]`` runs the
   reference's drifting-load script with ticks by hand (QFEDX_TUNE=60:
   shrink, tighten, the alert's revert) into the run's metrics.jsonl,
   then a live stream under QFEDX_TUNE=TUNE_LIVE_PERIOD (singles, then
   bursts): decisions = the ``tune.decisions`` counter = event rows =
   flight entries, no build, every forward at a warmed bucket, logits
   within LOGIT_ATOL of the CPU port; ``[tune-cli]`` trains one round
   of [cli-train]'s argv untuned and ``--tuned`` (θ equal, exactly;
   ``tuned_from`` recorded); ``[sweep]`` runs the quick preset's cells
   on the card and the CPU (accuracy within SWEEP_ACC_ATOL, ε equal),
   the aggregates and the table, and ``run_sweep`` only where matplotlib
   imports; ``[demo]`` holds the encoder walkthrough's numbers against
   the CPU (DEMO_ATOL); ``[inspect]`` reads the run directory (rounds,
   tune and alert rows, flight recorder, sidecar, floor row);
   ``[bench-history]`` reads the checkout's BENCH_r*.json and a regressed
   and an empty fixture (exit codes 0, 1, 2);
22. the device mesh and the sharded statevector (``qfedx_tpu_torch/
   parallel``): ``[mesh-round]`` runs 2 rounds at n = 12, L = 3, 4
   clients × 16 samples, batch 16 over a 2 × 1 client mesh with both
   slots on the card (SGD: θ and loss against the one-slot round on the
   card within MESH_SLOT_ATOL and the CPU's 2-slot round within
   MESH_CPU_ATOL; one B and one C per local step per slot, no A, no
   build after round 0; an Adam twin gated on logits); ``[sv-sharded]``
   holds the n = 22 one-layer forward on 8 sv slots against the dense
   engine on the card (SV_WIDE_ATOL), prints both forwards' times, and
   one SGD round of 2 clients × 2 samples on the (1, 8) mesh against the
   dense model's round (SV_ROUND_ATOL; no launch); ``[sv-noise]`` holds
   n = 10 trajectories on 4 sv slots against the dense noisy model on
   the same draws (no branch choice differs, logits within
   SV_NOISE_ATOL); ``[sv-cli]`` trains SV_CLI_ARGV (c5-svqc's widths:
   n = 8, sv 4, 32 clients) over 8 slots on the card, and the same 2
   rounds over 8 on the CPU (rows and θ of both rounds within
   SV_CLI_ATOL; each side's round cost its window over its rounds); ``[distributed]`` joins a one-rank
   NCCL process group and reruns [mesh-round]'s SGD rounds through
   ``torch.distributed.all_reduce`` (θ equal exactly; no two-GPU path
   is measured on the one card); ``[sv-processes]``, with W =
   min(GPUs, SV_PROC_MAX) ≥ 2, starts W processes of this script
   (``--sv-process``), one per GPU on NCCL, runs the n = 22 forward and
   one SGD round on a (1, W) mesh whose sv group spans them, and with
   W = 4 one round on a (2, 2) mesh at [mesh-round]'s widths, each held
   against the same run on a lockstep mesh over the same W GPUs in this
   process (SV_PROC_ATOL) and the forward against the dense ⟨Z⟩
   (SV_WIDE_ATOL), and prints the times, the bytes a global-qubit gate
   sends and the subgroup's size; with one GPU it runs nothing and says
   so in one line. ``--only`` takes these names too;
23. ``[lint]``: ``python3 -m qfedx_tpu_torch lint --json`` in a
   subprocess from the checkout's root, within LINT_TIMEOUT_S: exit 0,
   ``ok`` true and exactly the port's rule set (LINT_RULES) run — the
   port's lint needs nothing of the reference on a machine with no JAX.
   It launches no kernel; the line gives the report's delta and the
   seconds;
24. print one JSON line describing each launch of the kernel, f32 and
   bf16 instances (launches on the CLI run, and per path, the dense,
   reupload, amplitude, config-4, federation-option, model-family,
   noise, streamed, fault-plan, observability, tool and mesh paths
   included;
   max error; kernel-alone, plain and bound at the CLI run's shape, and
   at the earlier slices', the reupload, SPSA and per-example shapes);
25. print the final ``{"ok": true, "device": {...}}`` line.
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
RATE_ROUNDS = 8  # timed rounds of [cli-rate], after one warm-up round
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
    print(f"[build] scan_body.cu built (its f32 and its bf16 instances by "
          f"two concurrent nvcc processes) and loaded in {secs:.2f} s "
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


def cli_train(argv, device, data=None) -> tuple[dict, dict, list, dict]:
    """``run.cli.main(argv)`` in this process on ``device`` (None = the
    card) with the launch counters set to 0 just before; returns the
    summary, the launches read just after, each round's launches, and the
    launches by instance dtype. Given ``data`` (``cli_data(argv)``), the
    run goes to ``run.cli.run_train`` with it in place of its own build."""
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.run import cli

    with _RoundCounts() as rc:
        scan_body.reset_counts()
        if data is None:
            summary = cli.main(argv, device=device)
        else:
            cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
            summary = cli.run_train(cfg, device=device, data=data)
        launches = dict(scan_body.launch_counts)
        by_dtype = dict(scan_body.dtype_counts)
    return summary, launches, rc.rounds, by_dtype


def cli_data(argv) -> dict:
    """``run.config.build_data`` of ``argv``'s config (host numpy, the
    same for the card and the CPU), built once for a phase's shape probe
    and its CPU twin."""
    from qfedx_tpu_torch.run import cli
    from qfedx_tpu_torch.run.config import build_data

    return build_data(cli.config_from_args(cli.build_parser().parse_args(
        argv)))


def expected_shapes(argv, data=None) -> dict:
    """What the CLI's data (``data``, else built) gives the kernel: local
    steps per round (E·S_pad/B) and the evaluation sets' sizes."""
    from qfedx_tpu_torch.run import cli

    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    data = cli_data(argv) if data is None else data
    s_pad = data["cx"].shape[1]
    return {"steps": cfg.fed.local_epochs * s_pad // cfg.fed.batch_size,
            "s_pad": s_pad, "n_val": len(data["val"][1]),
            "n_test": len(data["test"][1]), "clients": data["cx"].shape[0]}


def _batches(n: int) -> int:
    return -(-n // EVAL_BATCH)


def phase_cli_train(root, shapes: dict) -> dict:
    """``python -m qfedx_tpu_torch train`` (in-process) on the card, then
    its first CPU_TWIN_ROUNDS rounds on the CPU: a complete run
    directory, every row on the schema, those rounds and their θ against
    the CPU's, the launches each round makes, and no build after the
    first round."""
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.run.checkpoint import Checkpointer

    argv = CLI_ARGV + ["--run-root", str(root), "--name", "smoke"]
    t0 = time.perf_counter()
    summary, launches, rounds, _ = cli_train(argv, None)
    wall = time.perf_counter() - t0
    run = root / "smoke"
    t0 = time.perf_counter()
    cpu_argv, cpu_rounds = twin_argv(CLI_ARGV)
    cpu_summary, _, _, _ = cli_train(
        cpu_argv + ["--run-root", str(root / "cpu"), "--name", "smoke"],
        "cpu")
    cpu_wall = time.perf_counter() - t0
    cpu_run = root / "cpu" / "smoke"
    print(f"[cli-train] {' '.join(argv)}: card {wall:.2f} s, cpu "
          f"{cpu_wall:.2f} s for {cpu_rounds} round(s) (host clock, "
          f"in-process); {shapes['clients']} "
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
    theta = ckpt.restore(cpu_rounds, template)
    cpu_theta = Checkpointer(cpu_run / "checkpoints").restore(cpu_rounds,
                                                              template)
    theta_err = _max_err(
        [v for d in theta.values() for v in d.values()],
        [v for d in cpu_theta.values() for v in d.values()])
    print(f"[cli-train] theta after round {cpu_rounds} max|card-cpu|="
          f"{theta_err:.3e} (atol "
          f"{TRAINED_LOGIT_ATOL:g}); summary card {json.dumps(summary)}; "
          f"cpu final_accuracy after {cpu_rounds} round(s) "
          f"{cpu_summary['final_accuracy']!r}")
    _require(theta_err, TRAINED_LOGIT_ATOL, "theta, card vs cpu")
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
    final = ckpt.restore(CLI_ROUNDS, template)
    return {"run": run, "rows": rows, "launches": launches, "times": times,
            "clients": shapes["clients"], "steps": steps,
            "theta_err": theta_err, "shapes": shapes, "summary": summary,
            "theta": [v for d in final.values() for v in d.values()]}


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
                    shape=(N_QUBITS, N_LAYERS, 2), tag="cli-serve",
                    encoding="angle") -> dict:
    """``serve --run-dir`` (in-process) on the trained run: 64 requests
    and one malformed line, answered in order; the logits against the CPU
    port's ``model.apply`` on the restored checkpoint (in bf16 under the
    pin, which the caller sets: every launch on the bf16 instance).
    ``shape`` is the run's (qubits, layers, classes) and ``encoding`` its
    encoding (amplitude requests carry 2^n features); below the slab
    widths the model runs no kernel and the phase requires 0 launches."""
    n_qubits, n_layers, n_classes = shape
    dense = n_qubits < 10
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.run import cli
    from qfedx_tpu_torch.run.checkpoint import Checkpointer

    width = (1 << n_qubits) if encoding == "amplitude" else n_qubits
    x = np.random.default_rng(17).uniform(0, 1, (N_SERVE_REQUESTS, width))
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
    model = make_vqc_classifier(n_qubits, n_layers, n_classes,
                                encoding=encoding, device="cpu")
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
    if encoding == "reupload" and launches["fwd"] != summary["batches"] + len(
            BUCKETS):
        raise AssertionError(f"{summary['batches']} served batches and a "
                             f"warmup of {len(BUCKETS)} buckets launched "
                             f"{launches}: one A each")
    want_dt = "bfloat16" if _is_bf16(dtype) else "float32"
    if by_dtype[want_dt] != launches["fwd"]:
        raise AssertionError(f"serving ran instances {by_dtype}")
    return {"launches": launches, "logit_err": err, "logits": got,
            "p50": summary["p50_ms"], "p95": summary["p95_ms"]}


# --- bf16 states (QFEDX_DTYPE=bf16) ------------------------------------------


@contextlib.contextmanager
def env_pins(*restore, **values):
    """Set the QFEDX_* pins ``values`` for the block (the port reads its
    pins at every call); those and the pins named in ``restore`` (which
    the block may write itself, as ``--tuned`` does through utils/pins)
    are restored after."""
    before = {k: os.environ.get(k) for k in (*restore, *values)}
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
            twin_argv(CLI_ARGV)[0] + ["--run-root", str(root / "cpu"),
                                     "--name", "smoke-bf16"], "cpu")
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
    print(f"[bf16-cli-train] final accuracy bf16 {acc!r} (cpu bf16 after "
          f"its {cpu_summary['rounds']} round(s) "
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

    from qfedx_tpu_torch.serve.engine import infer_num_classes

    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    return (cfg.model.n_qubits, cfg.model.n_layers, infer_num_classes(cfg),
            cfg.data.num_clients)


def phase_dense_cli_train(root, argv, name: str, tag: str,
                          dtype=torch.float32, f32_run=None) -> dict:
    """``python -m qfedx_tpu_torch train`` (in-process) below the slab
    widths on the card, then its first CPU_TWIN_ROUNDS round(s) on the
    CPU: a complete run directory, the model on the "vmap" engine, no
    scan-body launch and no kernel build; those rounds' loss card vs CPU
    within TRAINED_LOGIT_ATOL (bf16: BF16_LOSS_ATOL), in f32 their θ
    within TRAINED_LOGIT_ATOL and accuracy within one evaluation sample;
    in bf16 the final accuracy within 0.12 of the f32 run's
    (``f32_run``)."""
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
    cpu_argv, cpu_rounds = twin_argv(argv)
    cpu_summary, _, _, _ = cli_train(
        cpu_argv + ["--run-root", str(root / "cpu"), "--name", name], "cpu")
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
    theta = ckpt.restore(cpu_rounds, template.init(0))
    cpu_theta = Checkpointer(cpu_run / "checkpoints").restore(
        cpu_rounds, template.init(0))
    theta_err = _max_err(
        [v for d in theta.values() for v in d.values()],
        [v for d in cpu_theta.values() for v in d.values()])
    print(f"{_tag(tag, dtype)} theta after round {cpu_rounds} "
          f"max|card-cpu|={theta_err:.3e}; "
          f"launches {launches} per round {[c for c, _ in rounds]}, kernel "
          f"builds {scan_body.build_count - builds}; summary card "
          f"{json.dumps(summary)}; cpu final_accuracy after {cpu_rounds} "
          f"round(s) {cpu_summary['final_accuracy']!r}")
    if not bf:
        _require(theta_err, TRAINED_LOGIT_ATOL, f"{tag} theta")
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


# --- reupload and amplitude encodings, secure aggregation --------------------

# The reupload CLI run: BASELINE.md config 4's model at a fold the kernel
# takes (2 clients x batch 16: tb = 32, the mixed-group body), one local
# epoch so that the CPU twin stays short.
REUPLOAD_ARGV = ["train", "--model", "vqc", "--qubits", "12", "--layers",
                 "3", "--encoding", "reupload", "--classes", "0,1",
                 "--clients", "2", "--batch-size", "16", "--rounds",
                 str(CLI_ROUNDS), "--local-epochs", "1",
                 "--checkpoint-every", "1"]
# Amplitude at the widest width the data allow: CIFAR-10's 3072 features
# give 2^11 = 2048 PCA components (MNIST's 784 stop at n = 9).
AMPLITUDE_ARGV = ["train", "--model", "vqc", "--qubits", "11", "--layers",
                  "3", "--encoding", "amplitude", "--dataset", "cifar10",
                  "--classes", "all", "--clients", "4", "--rounds", "2",
                  "--local-epochs", "1", "--checkpoint-every", "1"]
# BASELINE.md config 4: 12-qubit reupload VQC, Fashion-MNIST, 64 clients,
# secure-aggregation masks (ring), 2 rounds; each round synchronous so
# that time_s is its wall.
CONFIG4_ARGV = ["train", "--model", "vqc", "--qubits", "12", "--layers", "3",
                "--encoding", "reupload", "--dataset", "fashion_mnist",
                "--clients", "64", "--secure-agg", "--rounds", "2",
                "--checkpoint-every", "1", "--pipeline-depth", "0"]
MASK_ATOL = 1e-5  # a masked run vs the same run without masks
# Rounds of the CPU twin of each run of phase_encoding_cli_train (the
# encodings, the federation options, noise): its first rounds, held
# against the card run's rows and checkpoints of the same rounds.
CPU_TWIN_ROUNDS = 1


class _Captured(Exception):
    def __init__(self, state, program):
        super().__init__("captured")
        self.state, self.program = state, program


@contextlib.contextmanager
def capture_scan():
    """Inside the block, the kernel branch of ``fuse.apply_scan`` raises
    ``_Captured`` with the state and program it was handed instead of
    launching: the main path's exact kernel inputs."""
    from qfedx_tpu_torch.ops import scan_body

    orig = scan_body.apply_scan_pallas

    def grab(state, n, program, batched=False):
        raise _Captured(state, program)

    scan_body.apply_scan_pallas = grab
    try:
        yield
    finally:
        scan_body.apply_scan_pallas = orig


def reupload_scan_inputs(n: int, tb: int, clients, device, seed: int,
                         dtype=torch.float32):
    """(packed, spec, xs) of the reupload circuit's scanned blocks: served
    (``clients`` None: ``data_reuploading_b`` on (tb, n) features) or
    folded (``data_reuploading_cb`` on C clients of tb/C samples), with
    seeded parameters; in ``dtype``'s state under its pin."""
    from qfedx_tpu_torch.circuits import ansatz

    rng = np.random.default_rng(seed)
    shape = ((clients,) if clients else ()) + (N_LAYERS, n)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    p = {"rx": t(rng.uniform(-2, 2, shape)), "rz": t(rng.uniform(-2, 2, shape)),
         "enc_w": t(1 + 0.5 * rng.normal(size=shape)),
         "enc_b": t(rng.uniform(-1, 1, shape))}
    x = t(rng.uniform(0, 1, (tb, n)))
    pins = {"QFEDX_DTYPE": "bf16"} if _is_bf16(dtype) else {}
    with env_pins(**pins), capture_scan():
        try:
            if clients:
                ansatz.data_reuploading_cb(x.reshape(clients, -1, n), p)
            else:
                ansatz.data_reuploading_b(x, p)
        except _Captured as got:
            return kernel_inputs(got.state, n, got.program)
    raise AssertionError(f"the reupload program at n={n} tb={tb} "
                         "C={clients} did not reach the kernel")


def reupload_cases() -> list:
    """(name, n, tb, clients) of ``[reupload-parity]``: the served program
    (per-sample stacks, G = tb) at the engine's buckets and widths n = 10,
    12, 15 (and 16 at tb = 8), and the folded one (per-sample beside
    per-client stacks) at the trainer's (C, B) = (2, 16) and (4, 8)."""
    cases = [(f"served n={n} tb={tb}", n, tb, None)
             for n in (10, 12, 15) for tb in BUCKETS]
    cases.append(("served n=16 tb=8", 16, 8, None))
    cases += [(f"folded n=12 C={c} B={b}", 12, c * b, c)
              for c, b in ((2, 16), (4, 8))]
    return cases


def phase_reupload_parity(device, dtype=torch.float32) -> dict:
    """``[reupload-parity]``: Launches A, B and C against their plain
    versions on the port's own reupload programs (``reupload_cases``):
    max abs ≤ KERNEL_ATOL in f32, relative norm ≤ BF16_RTOL in bf16 (each
    bf16 line says whether the kernel equals the plain sweep bit for
    bit); ``ScanBodyFn``'s state and coefficient cotangents (Launch C and
    the per-sample (L−1, tb, …) coefficient stacks) against plain
    autograd, ≤ GRAD_ATOL (bf16: BF16_GRAD_RTOL). Times A, B and C at the
    reupload CLI run's fold (C = 2, B = 16)."""
    from qfedx_tpu_torch.ops import scan_body

    bf = _is_bf16(dtype)
    worst = {"A": 0.0, "B": 0.0, "C": 0.0, "rel": 0.0, "grad": 0.0}
    rows = {}
    bit_equal = []
    t0 = time.perf_counter()
    for i, (name, n, tb, clients) in enumerate(reupload_cases()):
        packed, spec, xs = reupload_scan_inputs(n, tb, clients, device,
                                                seed=500 + i, dtype=dtype)
        groups = sorted({op.groups for op in spec.ops if op.stacked})
        if tb > 1 and tb not in groups:
            raise AssertionError(f"{name}: no per-sample stack ({groups})")
        aspec = scan_body._adjoint_spec(spec)
        axs = scan_body._adjoint_xs(spec, xs)
        cot = random_state(n, tb, device, seed=600 + i, dtype=dtype)
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
        rels = {k: _rel_err(*o) for k, o in outs.items()} if bf else errs
        body = ",".join(f"{op.kind}(G={op.groups})" if op.stacked else op.kind
                        for op in spec.ops)
        extra = ""
        if bf:
            equal = all(e == 0.0 for e in errs.values())
            bit_equal.append(equal)
            extra = (f"; ||kernel-plain||/||plain||: A {rels['A']:.3e}, B "
                     f"{rels['B']:.3e}, C {rels['C']:.3e} (rtol "
                     f"{BF16_RTOL:g}); bit for bit: {equal}")
        print(f"{_tag('reupload-parity', dtype)} {name} ({config_text(spec)}) "
              f"body=[{body}] max|kernel-plain|: A {errs['A']:.3e}, B "
              f"{errs['B']:.3e}, C {errs['C']:.3e}"
              + (extra if bf else f" (atol {KERNEL_ATOL:g})"))
        for launch in ("A", "B", "C"):
            _require(rels[launch], BF16_RTOL if bf else KERNEL_ATOL,
                     f"{spec.dtype} Launch {launch} on reupload {name}")
            worst[launch] = max(worst[launch], errs[launch])
            worst["rel"] = max(worst["rel"], rels[launch])
        w = torch.as_tensor(np.random.default_rng(700 + i).normal(
            size=tuple(packed.shape)), dtype=torch.float32, device=device)
        before = dict(scan_body.launch_counts)
        got = _cotangents(spec, packed, xs, w, "kernel")
        launched = {k: scan_body.launch_counts[k] - before[k] for k in before}
        want = _cotangents(spec, packed, xs, w, "plain")
        torch.cuda.synchronize()
        if bf:
            e_state, e_coeff = _rel_err(got[:1], want[:1]), _rel_err(
                got[1:], want[1:])
        else:
            e_state = float((got[0] - want[0]).abs().max())
            e_coeff = _max_err(got[1:], want[1:])
        per_sample = [tuple(g.shape[:2]) for g in got[1:]
                      if g.shape[1] == tb and tb > 1]
        print(f"{_tag('reupload-grad', dtype)} {name}: state cotangent "
              f"{e_state:.3e}, coefficient cotangents {e_coeff:.3e} ("
              + (f"relative norm, rtol {BF16_GRAD_RTOL:g}" if bf else
                 f"atol {GRAD_ATOL:g}")
              + f"), per-sample cotangent stacks {len(per_sample)}, "
              f"launches {launched}")
        if launched != {"fwd": 0, "fwd_bnd": 1, "adj": 1}:
            raise AssertionError(f"ScanBodyFn on {name} launched {launched}")
        _require(max(e_state, e_coeff), BF16_GRAD_RTOL if bf else GRAD_ATOL,
                 f"{spec.dtype} gradients on reupload {name}")
        worst["grad"] = max(worst["grad"], e_state, e_coeff)
        if name == "folded n=12 C=2 B=16":
            rows.update(time_launches(f"the reupload fold ({name}, mixed G "
                                      f"{groups})", packed, spec, xs, cot,
                                      aspec, axs, errs, ("A", "B", "C")))
    print(f"{_tag('reupload-parity', dtype)} {len(reupload_cases())} cases "
          f"in {time.perf_counter() - t0:.2f} s (host clock)"
          + (f"; bit for bit on {sum(bit_equal)} of {len(bit_equal)}"
             if bf else ""))
    return dict(worst, rows=rows)


def phase_reupload_serve(device) -> dict:
    """``[reupload-serve]``: ``make_vqc_classifier(12, 3, 2,
    encoding="reupload")`` with seeded weights behind ``ServeEngine``
    (buckets 1/8/32) and ``MicroBatcher``, 256 requests in waves of 1, 5
    and 250: logits within LOGIT_ATOL of the CPU port, exactly one Launch
    A per batch, no build after warmup; then at each bucket the served
    program's kernel inputs (per-sample stacks, G = tb): kernel vs plain,
    kernel alone, wrapper call, plain and bound."""
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.serve import MicroBatcher, ServeConfig, ServeEngine

    model = make_vqc_classifier(N_QUBITS, N_LAYERS, N_CLASSES,
                                encoding="reupload", init_scale=1.0)
    params = model.init(0)
    engine = ServeEngine(
        model, params, (N_QUBITS,),
        config=ServeConfig(buckets=BUCKETS, deadline_ms=2.0, max_queue=512),
    )
    engine.warmup()
    builds_after_warmup = scan_body.build_count
    x = np.random.default_rng(19).uniform(0, 1, (N_REQUESTS, N_QUBITS))
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
    batches = batcher.stats["batches"]
    builds = scan_body.build_count - builds_after_warmup
    logits = np.stack([f.result()["logits"] for f in futures])
    lat_ms = np.array([(f.done_t - f.submit_t) * 1e3 for f in futures])
    cpu_model = make_vqc_classifier(N_QUBITS, N_LAYERS, N_CLASSES,
                                    encoding="reupload", init_scale=1.0,
                                    device="cpu")
    cpu_params = {g: {k: v.cpu() for k, v in d.items()}
                  for g, d in params.items()}
    with torch.no_grad():
        ref = cpu_model.apply(cpu_params, x).numpy()
    err = float(np.abs(logits - ref).max())
    print(f"[reupload-serve] {N_REQUESTS} requests, batches={batches}, "
          f"kernel launches {launches}, builds after warmup={builds}; latency"
          f" p50={np.percentile(lat_ms, 50):.4f} ms p95="
          f"{np.percentile(lat_ms, 95):.4f} ms; logits max|card-cpu|="
          f"{err:.3e} (atol {LOGIT_ATOL:g})")
    if launches != {"fwd": batches, "fwd_bnd": 0, "adj": 0}:
        raise AssertionError(f"{batches} batches launched {launches}: "
                             "exactly one Launch A each")
    if builds:
        raise AssertionError("the kernel library was built after warmup")
    if logits.shape != (N_REQUESTS, N_CLASSES) or not np.isfinite(
            logits).all():
        raise AssertionError(f"bad logits: shape {logits.shape}")
    _require(err, LOGIT_ATOL, "reupload served logits vs cpu")
    rows = {}
    for b in BUCKETS:
        xb = torch.as_tensor(x[:b], device=device)
        with capture_scan():
            try:
                model.apply(params, xb)
                raise AssertionError(f"bucket {b} did not reach the kernel")
            except _Captured as got:
                packed, spec, xs = kernel_inputs(got.state, N_QUBITS,
                                                 got.program)
        require_cluster(spec, f"the reupload sweep at bucket {b}")
        with torch.no_grad():
            kerr = float((scan_body.scan_body(packed, spec, xs)
                          - scan_body.scan_body_plain(packed, spec, xs))
                         .abs().max())
        _require(kerr, KERNEL_ATOL, f"reupload kernel at bucket {b}")
        row = time_launches(f"reupload bucket {b} (G=tb)", packed, spec, xs,
                            None, None, None, {"A": kerr}, ("A",))[("A", b)]
        engine._forward(x[:b])
        t0 = time.perf_counter()
        for _ in range(20):
            engine._forward(x[:b])
        row["forward_ms"] = (time.perf_counter() - t0) / 20 * 1e3
        rows[b] = row
        print(f"[time] reupload bucket {b}: served forward "
              f"{row['forward_ms']:.4f} ms (host clock), body=["
              + ",".join(f"{op.kind}(G={op.groups})" for op in spec.ops)
              + "]")
    return {"launches": launches, "logit_err": err, "rows": rows,
            "p50": float(np.percentile(lat_ms, 50)),
            "p95": float(np.percentile(lat_ms, 95))}


def twin_argv(argv) -> tuple[list, int]:
    """The CPU twin's argv (the run's first CPU_TWIN_ROUNDS rounds: the
    CPU takes tens of seconds a round at n = 12) and its round count."""
    at = argv.index("--rounds") + 1
    rounds = min(int(argv[at]), CPU_TWIN_ROUNDS)
    return argv[:at] + [str(rounds)] + argv[at + 1:], rounds


def phase_encoding_cli_train(root, argv, name: str, tag: str,
                             encoding: str, per_step=None,
                             record=None, own_data: bool = False) -> dict:
    """``train`` of a run at n >= 10 (in-process) on the card, then its
    first CPU_TWIN_ROUNDS rounds on the CPU: a complete run directory,
    those rounds' loss and θ card vs CPU within TRAINED_LOGIT_ATOL,
    accuracy within one evaluation sample, the row fields of
    EXACT_ROW_KEYS (ε, the defenses' ledgers) equal, the CPU's
    ``final_epsilon`` equal to the card row's ε, ``per_step`` launches per
    local step on the card (default one Launch B and one C), and Launch A
    in evaluation only where the evaluator's tb = 256 reaches the kernel
    (the HEA body of the angle and amplitude encodings; reupload's
    per-sample banks at 256 groups do not, as in the reference), no build
    after round 1. ``record`` (a dict) receives each run's Kraus branch
    choices under "card" and "cpu". The card run takes the data built for
    the shape probe, unless ``own_data`` (its wall then holds the build
    too: the noise phases price a round from it)."""
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.noise.trajectory import record_branches
    from qfedx_tpu_torch.run.checkpoint import Checkpointer

    n, layers, classes, clients = _run_shape(argv)
    data = cli_data(argv)
    shapes = expected_shapes(argv, data)
    rounds_n = int(argv[argv.index("--rounds") + 1])
    record = {} if record is None else record
    t0 = time.perf_counter()
    with record_branches() as record["card"]:
        summary, launches, rounds, _ = cli_train(
            argv + ["--run-root", str(root), "--name", name], None,
            None if own_data else data)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_argv, cpu_rounds = twin_argv(argv)
    with record_branches() as record["cpu"]:
        cpu_summary, _, _, _ = cli_train(
            cpu_argv + ["--run-root", str(root / "cpu"), "--name", name],
            "cpu", data)
    cpu_wall = time.perf_counter() - t0
    run, cpu_run = root / name, root / "cpu" / name
    batch = int(argv[argv.index("--batch-size") + 1]) if (
        "--batch-size" in argv) else 32
    print(f"[{tag}] {' '.join(argv)}: n={n} L={layers} classes={classes} "
          f"{clients} clients x S_pad={shapes['s_pad']}, {shapes['steps']} "
          f"local steps per round at tb={clients * batch}; eval sets "
          f"{shapes['n_val']} / {shapes['n_test']}; card {wall:.2f} s "
          f"({rounds_n} rounds{', its data build included' if own_data else ''}"
          f"), cpu {cpu_wall:.2f} s ({cpu_rounds}) (host clock, in-process)")
    ckpt = Checkpointer(run / "checkpoints", every=1)
    for r in range(1, rounds_n + 1):
        ckpt.verify(r)
    rows, cpu_rows = _rows(run), _rows(cpu_run)
    if [r["round"] for r in rows] != list(range(1, rounds_n + 1)):
        raise AssertionError(f"metrics.jsonl rounds {rows}")
    for row, cpu in zip(rows, cpu_rows):
        loss_err = abs(row["loss"] - cpu["loss"])
        print(f"[{tag}] round {row['round']}: loss card {row['loss']!r} cpu "
              f"{cpu['loss']!r} |err|={loss_err:.3e} (atol "
              f"{TRAINED_LOGIT_ATOL:g}), accuracy card {row['accuracy']!r} "
              f"cpu {cpu['accuracy']!r} (n={row['n']}), time_s "
              f"{row['time_s']:.4f} (host clock, drain to drain)")
        _require(loss_err, TRAINED_LOGIT_ATOL, f"{tag} round loss")
        _require(abs(row["accuracy"] - cpu["accuracy"]),
                 1.0 / row["n"] + 1e-12, f"{tag} accuracy, card vs cpu")
        exact = {k: row[k] for k in EXACT_ROW_KEYS if k in row}
        if exact:
            print(f"[{tag}] round {row['round']}: {exact}")
        if exact != {k: cpu[k] for k in EXACT_ROW_KEYS if k in cpu}:
            raise AssertionError(f"{tag} round {row['round']}: {exact} vs "
                                 f"the cpu row {cpu}")
    if rows[cpu_rounds - 1].get("epsilon") != cpu_summary["final_epsilon"]:
        raise AssertionError(f"{tag} round {cpu_rounds} epsilon "
                             f"{rows[cpu_rounds - 1]} vs {cpu_summary}")
    template = make_vqc_classifier(n, layers, classes, encoding=encoding,
                                   device="cpu").init(0)
    theta = ckpt.restore(cpu_rounds, template)
    cpu_theta = Checkpointer(cpu_run / "checkpoints").restore(cpu_rounds,
                                                              template)
    theta_err = _max_err(
        [v for d in theta.values() for v in d.values()],
        [v for d in cpu_theta.values() for v in d.values()])
    steps = shapes["steps"]
    want_round = {k: steps * v for k, v in (per_step or STEP_BC).items()}
    evals = 0
    if encoding != "reupload":
        evals = _batches(shapes["n_val"]) * (1 + rounds_n) + _batches(
            shapes["n_test"])
    want = {k: rounds_n * v for k, v in want_round.items()}
    want["fwd"] += evals
    print(f"[{tag}] theta after round {cpu_rounds} max|card-cpu|="
          f"{theta_err:.3e} (atol {TRAINED_LOGIT_ATOL:g}); launches "
          f"{launches} (expected {want}); "
          f"per round {[c for c, _ in rounds]}; builds after each round "
          f"{[b for _, b in rounds]}; summary {json.dumps(summary)}")
    _require(theta_err, TRAINED_LOGIT_ATOL, f"{tag} theta")
    if [c for c, _ in rounds] != [want_round] * rounds_n or launches != want:
        raise AssertionError(f"{tag} launched {launches}, rounds {rounds}")
    if len({b for _, b in rounds}) != 1:
        raise AssertionError(f"{tag}: the kernel library was built after "
                             "round 1")
    return {"run": run, "rows": rows, "launches": launches,
            "theta_err": theta_err, "shape": (n, layers, classes),
            "summary": summary, "wall": wall, "cpu_wall": cpu_wall,
            "cpu_rounds": cpu_rounds}


def _round_rows(root, argv, name, device) -> tuple:
    """A config-4 run: its rows, θ after each round (from its
    checkpoints, as flat leaves) and its launches."""
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.run.checkpoint import Checkpointer

    summary, launches, rounds, _ = cli_train(
        argv + ["--run-root", str(root), "--name", name], device)
    n, layers, classes, _ = _run_shape(argv)
    template = make_vqc_classifier(n, layers, classes, encoding="reupload",
                                   device="cpu").init(0)
    ckpt = Checkpointer(root / name / "checkpoints")
    rows = _rows(root / name)
    thetas = [[v for d in ckpt.restore(r["round"], template).values()
               for v in d.values()] for r in rows]
    return rows, thetas, launches, rounds, summary


def phase_config4(root) -> dict:
    """``[config4]``: BASELINE.md config 4 (CONFIG4_ARGV: reupload n = 12,
    L = 3, Fashion-MNIST, 64 clients, ring masks) on the card, the same
    with ``--secure-agg-mode pairwise`` and without masks, and the ring
    run on the CPU: masked losses and θ equal the unmasked run's within
    MASK_ATOL; one round of one local step (the fold, masks and
    aggregation of config 4, a fifth of its local work: a full round
    takes minutes on the host's CPU) on the card and the CPU, within
    TRAINED_LOGIT_ATOL; no
    kernel launch anywhere (the fold is C·B = 2048 samples: 2048-group
    banks leave a stacked g1, so ``route_ok`` refuses, as in the
    reference); each round's wall (synchronous) and client-rounds/s with
    masks on and off."""
    plain_argv = [a for a in CONFIG4_ARGV if a != "--secure-agg"]
    runs = {}
    for label, argv in (("ring", CONFIG4_ARGV),
                        ("pairwise", CONFIG4_ARGV + ["--secure-agg-mode",
                                                     "pairwise"]),
                        ("no masks", plain_argv)):
        t0 = time.perf_counter()
        runs[label] = _round_rows(root, argv, f"c4-{label.replace(' ', '')}",
                                  None) + (time.perf_counter() - t0,)
    short = list(CONFIG4_ARGV) + ["--local-epochs", "1"]
    short[short.index("--rounds") + 1] = "1"
    card = _round_rows(root, short, "c4-short", None)
    t0 = time.perf_counter()
    cpu = _round_rows(root / "cpu", short, "c4-short", "cpu")
    cpu_wall = time.perf_counter() - t0
    shapes = expected_shapes(CONFIG4_ARGV)
    clients = shapes["clients"]
    plain_rows, plain_theta = runs["no masks"][0], runs["no masks"][1][-1]
    out = {"launches": {}, "rates": {}}
    for label, (rows, theta, launches, rounds, summary, wall) in runs.items():
        times = [r["time_s"] for r in rows]
        loss_err = max(abs(r["loss"] - p["loss"])
                       for r, p in zip(rows, plain_rows))
        theta_err = _max_err(theta[-1], plain_theta)
        rate = clients / times[-1]
        out["launches"][label] = launches
        out["rates"][label] = {"round_s": times, "rate": rate}
        print(f"[config4] {label}: {clients} clients x S_pad="
              f"{shapes['s_pad']}, {shapes['steps']} local steps per round "
              f"at tb={clients * 32}; round wall (synchronous, host clock) "
              f"{', '.join(f'{t:.5f}' for t in times)} s, last round "
              f"{rate:.4f} client-rounds/s; whole run {wall:.2f} s; losses "
              f"{[r['loss'] for r in rows]}; vs no masks: loss "
              f"{loss_err:.3e}, theta {theta_err:.3e} (atol {MASK_ATOL:g}); "
              f"launches {launches}; final accuracy "
              f"{summary['final_accuracy']!r}")
        _require(loss_err, MASK_ATOL, f"config4 {label} loss vs no masks")
        _require(theta_err, MASK_ATOL, f"config4 {label} theta vs no masks")
        if launches != NO_LAUNCH or any(c != NO_LAUNCH for c, _ in rounds):
            raise AssertionError(f"config4 {label} launched {launches}")
    loss_err = abs(card[0][0]["loss"] - cpu[0][0]["loss"])
    theta_err = _max_err(card[1][0], cpu[1][0])
    if card[2] != NO_LAUNCH:
        raise AssertionError(f"config4 short run launched {card[2]}")
    print(f"[config4] {' '.join(short)}, card vs cpu: loss {loss_err:.3e}, "
          f"theta "
          f"{theta_err:.3e} (atol {TRAINED_LOGIT_ATOL:g}); cpu run "
          f"{cpu_wall:.2f} s, cpu round wall "
          f"{[round(r['time_s'], 5) for r in cpu[0]]} s")
    _require(loss_err, TRAINED_LOGIT_ATOL, "config4 loss, card vs cpu")
    _require(theta_err, TRAINED_LOGIT_ATOL, "config4 theta, card vs cpu")
    out["theta_err"] = theta_err
    return out


# --- the rest of the federation options: DP, robust rules, sampling, SPSA ---

# Client-mode DP with sampling below 1 at the CLI run's width.
DP_CLIENT_ARGV = ["train", "--model", "vqc", "--qubits", "12", "--layers",
                  "3", "--classes", "0,1", "--clients", "4", "--rounds", "2",
                  "--local-epochs", "1", "--dp-clip", "1.0", "--dp-sigma",
                  "1.0", "--client-fraction", "0.5", "--checkpoint-every",
                  "1"]
SPSA_ARGV = ["train", "--model", "vqc", "--qubits", "12", "--layers", "3",
             "--classes", "0,1", "--clients", "4", "--rounds", "1",
             "--local-epochs", "1", "--optimizer", "spsa",
             "--checkpoint-every", "1"]
# Per-example DP: C = 2 clients x B = 16, one-sample groups (C*B = 32,
# the most one stacked program hands the kernel).
DP_EXAMPLE_ARGV = ["train", "--model", "vqc", "--qubits", "12", "--layers",
                   "3", "--classes", "0,1", "--clients", "2", "--batch-size",
                   "16", "--dp-clip", "1.0", "--dp-sigma", "1.0",
                   "--dp-mode", "example", "--rounds", "1", "--local-epochs",
                   "1", "--checkpoint-every", "1"]
# BASELINE.md config 2: 8-qubit VQC, MNIST, 10 non-IID clients, FedAvg +
# DP-SGD (sigma 1.4, C 1.0: the README's DP-SGD line). Eight classes, not
# ten: the VQC needs n >= classes.
CONFIG2_ARGV = ["train", "--model", "vqc", "--qubits", "8", "--layers", "2",
                "--classes", "0,1,2,3,4,5,6,7", "--clients", "10",
                "--partition", "dirichlet", "--dp-clip", "1.0", "--dp-sigma",
                "1.4", "--dp-mode", "example", "--rounds", "2",
                "--local-epochs", "1", "--pipeline-depth", "0"]
ROUND_ATOL = 1e-5  # library rounds, card vs CPU (the SGD round tolerance)
# Row fields that must equal card vs CPU: the accountant's and the
# defenses' ledgers depend on the config and the counts alone.
EXACT_ROW_KEYS = ("epsilon", "epsilon_accounting", "aggregator",
                  "clipped_clients", "trimmed_fraction")
STEP_BC = {"fwd": 0, "fwd_bnd": 1, "adj": 1}  # a local step's launches


def hold_program(tag: str, name: str, packed, spec, xs, seed: int,
                 timed=()) -> tuple[dict, dict]:
    """Launches A, B and C on a main-path program against the plain
    sweep (KERNEL_ATOL), ``ScanBodyFn``'s cotangents against plain
    autograd (GRAD_ATOL, one B and one C), and ``timed`` launches timed;
    returns the errors and the timing rows."""
    from qfedx_tpu_torch.ops import scan_body

    aspec = scan_body._adjoint_spec(spec)
    axs = scan_body._adjoint_xs(spec, xs)
    cot = random_state(spec.n, spec.tb, packed.device, seed=seed)
    cot = torch.stack([cot.re, cot.im]).reshape(packed.shape)
    with torch.no_grad():
        outs = {
            "A": ([scan_body.scan_body(packed, spec, xs)],
                  [scan_body.scan_body_plain(packed, spec, xs)]),
            "B": (scan_body.scan_body(packed, spec, xs, with_boundaries=True),
                  scan_body.scan_body_plain(packed, spec, xs, True)),
            "C": (scan_body.scan_body(cot, aspec, axs, with_boundaries=True,
                                      adjoint=True),
                  scan_body.scan_body_plain(cot, aspec, axs, True)),
        }
        torch.cuda.synchronize()
    errs = {k: _max_err(*o) for k, o in outs.items()}
    body = ",".join(f"{op.kind}(G={op.groups})" if op.stacked else op.kind
                    for op in spec.ops)
    print(f"[{tag}] {name} ({config_text(spec)}) body=[{body}] "
          f"max|kernel-plain|: A {errs['A']:.3e}, B {errs['B']:.3e}, C "
          f"{errs['C']:.3e} (atol {KERNEL_ATOL:g})")
    for launch in ("A", "B", "C"):
        _require(errs[launch], KERNEL_ATOL, f"{tag} Launch {launch}")
    w = torch.as_tensor(np.random.default_rng(seed + 1).normal(
        size=tuple(packed.shape)), dtype=torch.float32, device=packed.device)
    before = dict(scan_body.launch_counts)
    got = _cotangents(spec, packed, xs, w, "kernel")
    launched = {k: scan_body.launch_counts[k] - before[k] for k in before}
    want = _cotangents(spec, packed, xs, w, "plain")
    torch.cuda.synchronize()
    e_state = float((got[0] - want[0]).abs().max())
    e_coeff = _max_err(got[1:], want[1:])
    print(f"[{tag}] {name}: ScanBodyFn state cotangent {e_state:.3e}, "
          f"coefficient cotangents {e_coeff:.3e} (atol {GRAD_ATOL:g}), "
          f"launches {launched}")
    if launched != STEP_BC:
        raise AssertionError(f"ScanBodyFn on {name} launched {launched}")
    _require(max(e_state, e_coeff), GRAD_ATOL, f"{tag} gradients")
    errs["grad"] = max(e_state, e_coeff)
    rows = (time_launches(name, packed, spec, xs, cot, aspec, axs, errs,
                          timed) if timed else {})
    return errs, rows


def captured_program(forward, n: int):
    """(packed, spec, xs) that ``forward()`` hands the kernel first."""
    with capture_scan():
        try:
            forward()
        except _Captured as cap:
            return kernel_inputs(cap.state, n, cap.program)
    raise AssertionError("the forward never reached the kernel")


def phase_spsa(root, device) -> dict:
    """``[spsa]``: ``train --optimizer spsa`` at n = 12 (SPSA_ARGV) on the
    card and the CPU: exactly one Launch A per local step (θ ± cΔ of the
    4 clients as the 8 client groups of one forward under no_grad) and
    none of B or C, A also in evaluation; θ and loss card vs CPU within
    TRAINED_LOGIT_ATOL. Then Launch A on that forward's own program (2C
    groups at tb = 2·C·B) against the plain sweep, and timed."""
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier

    run = phase_encoding_cli_train(root, SPSA_ARGV, "spsa", "spsa", "angle",
                                   per_step={"fwd": 1, "fwd_bnd": 0,
                                             "adj": 0})
    n, layers, classes, clients = _run_shape(SPSA_ARGV)
    base, leaves, xb, _ = _client_batch(n, layers, classes, 2 * clients,
                                        TRAIN_BATCH, device, seed=910)
    model = make_vqc_classifier(n, layers, classes, device=device)

    def forward():
        with torch.no_grad():
            model.apply_clients(leaves, xb)

    errs, rows = hold_program("spsa", f"SPSA forward, {2 * clients} client "
                              f"groups x {TRAIN_BATCH}",
                              *captured_program(forward, n), seed=911,
                              timed=("A",))
    run.update(errs=errs, rows=rows)
    return run


def phase_dp_example(root, device) -> dict:
    """``[dp-example]``: per-example DP at n = 12, C = 2, B = 16
    (DP_EXAMPLE_ARGV) on the card and the CPU: one Launch B and one C per
    local step on the C·B one-sample groups (G = tb = 32), A in
    evaluation, θ and loss card vs CPU within TRAINED_LOGIT_ATOL, ε equal.
    Then Launches A, B and C on that per-sample program against the plain
    sweep and ScanBodyFn's cotangents (the coefficient cotangents as
    (L, tb, …) stacks) against plain autograd, as [reupload-parity] holds
    G = tb; B and C timed."""
    from qfedx_tpu_torch.fed.client import apply_groups
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier

    run = phase_encoding_cli_train(root, DP_EXAMPLE_ARGV, "dp-example",
                                   "dp-example", "angle")
    n, layers, classes, clients = _run_shape(DP_EXAMPLE_ARGV)
    batch = 16
    groups = clients * batch
    base, leaves, xb, _ = _client_batch(n, layers, classes, groups, 1,
                                        device, seed=920)
    model = make_vqc_classifier(n, layers, classes, device=device)
    packed, spec, xs = captured_program(
        lambda: apply_groups(model, leaves, xb), n)
    stacked = sorted({op.groups for op in spec.ops if op.stacked})
    if stacked != [groups] or spec.tb != groups:
        raise AssertionError(f"the per-example program has groups {stacked}"
                             f" at tb={spec.tb}, expected G = tb = {groups}")
    errs, rows = hold_program("dp-example", f"per-example groups C={clients} "
                              f"B={batch} (G=tb={groups})", packed, spec, xs,
                              seed=921, timed=("B", "C"))
    run.update(errs=errs, rows=rows)
    return run


def phase_dp_client(root) -> dict:
    """``[dp-client]``: client-mode DP with sampling (DP_CLIENT_ARGV) on
    the card and the CPU: loss and θ within TRAINED_LOGIT_ATOL, ε per row
    equal, E·S_pad/B Launch B and as many C per round, A in evaluation,
    no build after round 1."""
    return phase_encoding_cli_train(root, DP_CLIENT_ARGV, "dp-client",
                                    "dp-client", "angle")


def phase_robust(device) -> dict:
    """``[robust]``: library rounds at n = 12, L = 3, 4 clients x 16
    samples, batch 8 (tb = 32: two local steps) under mean, trimmed_mean,
    median and clip_mean (finite bound), with a byzantine input (client 1
    scale:100, client 2 sign_flip) and once with client 3 absent (a NaN
    in every coordinate's sort), on the card and the CPU: θ within
    ROUND_ATOL, clipped_clients and trimmed_fraction equal, 2 B + 2 C per
    round, and each rule's θ closer to the honest round's than plain
    mean's under the same attack; a client-mode DP round beside them. Each
    card round runs twice and the second is timed (synchronised, host
    clock): what the rule's post-processing adds to a round. ``torch.sort``
    puts NaN last on the card as on the CPU."""
    from qfedx_tpu_torch.fed.config import DPConfig, FedConfig
    from qfedx_tpu_torch.fed.round import RoundDraws, make_fed_round
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.ops import scan_body

    v = torch.tensor([[3.0, float("nan")], [float("nan"), -1.0],
                      [-2.0, 5.0]])
    on_card = torch.sort(v.to(device), dim=0).values.cpu()
    if not torch.equal(torch.nan_to_num(on_card, nan=9.0), torch.nan_to_num(
            torch.sort(v, dim=0).values, nan=9.0)):
        raise AssertionError(f"torch.sort with NaN on the card: {on_card}")
    n, layers, clients, samples, batch = 12, 3, 4, 16, 8
    rng = np.random.default_rng(930)
    data = (rng.uniform(0, 1, (clients, samples, n)).astype(np.float32),
            rng.integers(0, 2, (clients, samples)),
            np.ones((clients, samples), np.float32))
    perms = torch.stack([torch.stack([torch.randperm(
        samples, generator=torch.Generator().manual_seed(c))])
        for c in range(clients)])
    byz = np.array([[1, 0], [100, 0], [-1, 0], [1, 0]], np.float32)
    cases = [("mean", {}, None, None), ("mean", {}, byz, None),
             ("trimmed_mean", dict(aggregator="trimmed_mean",
                                   trim_fraction=0.25), byz, None),
             ("median", dict(aggregator="median"), byz, None),
             ("clip_mean", dict(aggregator="clip_mean", clip_bound=0.05),
              byz, None),
             ("median", dict(aggregator="median"), byz,
              np.array([1, 1, 1, 0], np.float32)),
             ("mean, client DP", dict(dp=DPConfig(clip_norm=1.0)), None,
              None)]
    steps = samples // batch
    out = {"launches": dict(NO_LAUNCH), "theta_err": 0.0}
    thetas = {}
    for agg, kw, attack, survivors in cases:
        cfg = FedConfig(local_epochs=1, batch_size=batch, learning_rate=0.1,
                        momentum=0.9, **kw)
        res = {}
        for timed, dev in ((True, device), (False, "cpu")):
            model = make_vqc_classifier(n, layers, 2, device=dev)
            params = {g: {k: t * 8.0 for k, t in d.items()}
                      for g, d in model.init(7).items()}
            rf = make_fed_round(model, cfg, num_clients=clients)
            tdata = [torch.as_tensor(a, device=dev) for a in data]

            def run():
                return rf(params, *tdata, perms=perms, byzantine=attack,
                          survivors=survivors, draws=RoundDraws(930, 0))

            before = dict(scan_body.launch_counts)
            theta, stats = run()
            stats = {k: float(t) for k, t in stats._asdict().items()}
            launched = {k: scan_body.launch_counts[k] - before[k]
                        for k in before}
            wall = None
            if timed:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            res[timed] = (theta, stats, launched, wall)
        (theta, stats, launched, wall), (ctheta, cstats, _, _) = res[
            True], res[False]
        flat = [t for d in theta.values() for t in d.values()]
        err = _max_err([t.cpu() for t in flat],
                       [t for d in ctheta.values() for t in d.values()])
        label = (f"{agg}" + (", byzantine" if attack is not None else "")
                 + (", client 3 absent" if survivors is not None else ""))
        thetas[label] = [t.cpu() for t in flat]
        print(f"[robust] {label}: theta max|card-cpu| {err:.3e} (atol "
              f"{ROUND_ATOL:g}); clipped_clients {stats['clipped_clients']}"
              f" (cpu {cstats['clipped_clients']}), trimmed_fraction "
              f"{stats['trimmed_fraction']} (cpu "
              f"{cstats['trimmed_fraction']}), participants "
              f"{stats['num_participants']}, loss {stats['mean_loss']!r}; "
              f"launches {launched}; round wall {wall:.3f} ms (second "
              "call, synchronised, host clock)")
        _require(err, ROUND_ATOL, f"robust {label} theta, card vs cpu")
        for k in ("clipped_clients", "trimmed_fraction", "num_participants",
                  "dropped_clients"):
            if stats[k] != cstats[k]:
                raise AssertionError(f"robust {label} {k}: {stats[k]} vs "
                                     f"{cstats[k]}")
        if launched != {k: steps * v for k, v in STEP_BC.items()}:
            raise AssertionError(f"robust {label} launched {launched}")
        out["launches"] = {k: out["launches"][k] + launched[k]
                           for k in launched}
        out["theta_err"] = max(out["theta_err"], err)
        out.setdefault("walls", {})[label] = wall

    def dist(a, b):
        return math.sqrt(sum(float(((x - y) ** 2).sum())
                             for x, y in zip(a, b)))

    honest = thetas["mean"]
    pull = {k: dist(t, honest) for k, t in thetas.items()
            if k not in ("mean", "mean, client DP")}
    print("[robust] distance of theta from the honest mean round: "
          + ", ".join(f"{k} {v:.5f}" for k, v in pull.items()))
    for k, v in pull.items():
        if "absent" not in k and k != "mean, byzantine" and not (
                v < pull["mean, byzantine"]):
            raise AssertionError(f"{k} pulled {v} >= plain mean's "
                                 f"{pull['mean, byzantine']}")
    out["pull"] = pull
    return out


def phase_config2(root) -> dict:
    """``[config2]``: BASELINE.md config 2 (CONFIG2_ARGV) on the card and
    the CPU: the dense engine (no launch, no build), loss per round and
    the final θ within TRAINED_LOGIT_ATOL, a finite final_epsilon equal
    to the CPU run's and ε per row equal; the synchronous round walls
    and client-rounds/s (host clock)."""
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.run.checkpoint import Checkpointer

    n, layers, classes, clients = _run_shape(CONFIG2_ARGV)
    data = cli_data(CONFIG2_ARGV)
    shapes = expected_shapes(CONFIG2_ARGV, data)
    builds = scan_body.build_count
    t0 = time.perf_counter()
    summary, launches, rounds, _ = cli_train(
        CONFIG2_ARGV + ["--run-root", str(root), "--name", "config2"], None,
        data)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_summary, _, _, _ = cli_train(
        CONFIG2_ARGV + ["--run-root", str(root / "cpu"), "--name",
                        "config2"], "cpu", data)
    cpu_wall = time.perf_counter() - t0
    rows, cpu_rows = _rows(root / "config2"), _rows(root / "cpu" / "config2")
    print(f"[config2] {' '.join(CONFIG2_ARGV)}: n={n} L={layers} "
          f"classes={classes} {clients} clients x S_pad={shapes['s_pad']}, "
          f"{shapes['steps']} local steps per round, each {clients} x 32 "
          f"one-sample groups; card {wall:.2f} s, cpu {cpu_wall:.2f} s "
          "(host clock, in-process; the data built once, before both)")
    for row, cpu in zip(rows, cpu_rows):
        loss_err = abs(row["loss"] - cpu["loss"])
        print(f"[config2] round {row['round']}: loss card {row['loss']!r} "
              f"cpu {cpu['loss']!r} |err|={loss_err:.3e}, epsilon "
              f"{row['epsilon']!r} (cpu {cpu['epsilon']!r}), accuracy "
              f"{row['accuracy']!r}, time_s {row['time_s']!r} (cpu "
              f"{cpu['time_s']!r}; rounds of one chunk share its wall)")
        _require(loss_err, TRAINED_LOGIT_ATOL, "config2 round loss")
        for k in EXACT_ROW_KEYS:
            if row.get(k) != cpu.get(k):
                raise AssertionError(f"config2 {k}: {row.get(k)!r} vs "
                                     f"{cpu.get(k)!r}")
    template = make_vqc_classifier(n, layers, classes, device="cpu").init(0)
    rounds_n = len(rows)
    theta = Checkpointer(root / "config2" / "checkpoints").restore(
        rounds_n, template)
    cpu_theta = Checkpointer(root / "cpu" / "config2" / "checkpoints"
                             ).restore(rounds_n, template)
    theta_err = _max_err([v for d in theta.values() for v in d.values()],
                         [v for d in cpu_theta.values() for v in d.values()])
    eps, cpu_eps = summary["final_epsilon"], cpu_summary["final_epsilon"]
    times = [r["time_s"] for r in rows]
    rate = clients * len(times) / sum(times)
    print(f"[config2] final theta max|card-cpu| {theta_err:.3e} (atol "
          f"{TRAINED_LOGIT_ATOL:g}); final_epsilon {eps!r} (cpu {cpu_eps!r},"
          f" delta 1e-5); launches {launches}, kernel builds "
          f"{scan_body.build_count - builds}; round walls (synchronous, "
          f"host clock) {times} s, {rate:.4f} client-rounds/s; final "
          f"accuracy {summary['final_accuracy']!r}")
    _require(theta_err, TRAINED_LOGIT_ATOL, "config2 final theta")
    if not (eps is not None and math.isfinite(eps) and eps == cpu_eps):
        raise AssertionError(f"config2 final_epsilon {eps!r} vs {cpu_eps!r}")
    if launches != NO_LAUNCH or scan_body.build_count != builds:
        raise AssertionError(f"config2 launched {launches} or built")
    return {"launches": launches, "rate": rate, "times": times,
            "epsilon": eps, "theta_err": theta_err}


# --- the other model families: TinyCNN, kernel head, MPS (no kernel) ------

# BASELINE.md config 3: the classical TinyCNN on CIFAR-10, 32 clients,
# FedProx (the original QFedX's own main path). Synthetic CIFAR-10 here:
# the checkout carries no CIFAR files.
CONFIG3_ARGV = ["train", "--model", "cnn", "--dataset", "cifar10",
                "--clients", "32", "--algorithm", "fedprox", "--prox-mu",
                "0.01", "--rounds", "2", "--local-epochs", "1",
                "--pipeline-depth", "0", "--checkpoint-every", "1"]
# BASELINE.md config 5: the 20-qubit quantum-kernel head, 256 clients.
CONFIG5_ARGV = ["train", "--model", "qkernel", "--qubits", "20",
                "--landmarks", "16", "--clients", "256", "--rounds", "2",
                "--local-epochs", "1", "--pipeline-depth", "0",
                "--checkpoint-every", "1"]
# The MPS classifier at a width the dense engine cannot hold (2^24
# amplitudes a sample).
MPS_ARGV = ["train", "--model", "mps", "--qubits", "24", "--layers", "2",
            "--bond-dim", "16", "--classes", "0,1", "--clients", "4",
            "--rounds", "2", "--local-epochs", "1", "--pipeline-depth", "0",
            "--checkpoint-every", "1"]
# TinyCNN card vs CPU: logits, and one step's gradients by relative norm.
# f32 convolutions either side (TF32 off inside the module); cuDNN's
# backward may sum in another order from run to run (~1e-7 relative).
CNN_ATOL = 1e-4
QKERNEL_ATOL = 1e-5  # the closed form's logits, loss and θ, card vs CPU
# MPS at χ = 2^{n/2} against the dense statevector: the reference's own
# bounds (tests/test_mps.py: ⟨Z⟩ 1e-4, ∂/∂θ 2e-3).
MPS_Z_ATOL = 1e-4
MPS_GRAD_ATOL = 2e-3
# The n = 24 MPS run, loss and θ card vs CPU. The splits zero their null
# space (ops/mps.py), so the SVD routine's basis choice does not enter;
# what stays route-dependent is the kept subspace where two singular
# values at the χ cutoff are within rounding of each other, and SGD over
# 2 rounds of 6 steps carries the f32 differences of 46 SVDs a forward.
# [cli-train]'s bound.
MPS_CLI_ATOL = 1e-4


# The TF32 settings a user's process starts with, read before ``main``
# turns TF32 off for the kernel phases.
PROCESS_TF32 = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)


@contextlib.contextmanager
def process_tf32():
    """``PROCESS_TF32`` for the block, the smoke's settings restored
    after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = PROCESS_TF32
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def _flat(params) -> list:
    from qfedx_tpu_torch.utils import trees

    return [v.detach().cpu() for v in trees.tree_leaves(params)]


def _grads(model, params, x, y, keep=None) -> list:
    """∂ mean-CE / ∂θ of one batch (through ``apply_train`` with
    ``keep``)."""
    from qfedx_tpu_torch.fed.client import _cross_entropy
    from qfedx_tpu_torch.utils import trees

    leaves = trees.tree_map(lambda p: p.detach().requires_grad_(True),
                            params)
    logits = (model.apply(leaves, x) if keep is None
              else model.apply_train(leaves, x, {"dropout_keep": keep}))
    loss = _cross_entropy(logits, y).mean()
    return [g.cpu() for g in torch.autograd.grad(
        loss, trees.tree_leaves(leaves))]


def phase_cnn(device) -> dict:
    """``[cnn]``: the TinyCNN at 28×28×1 (3 classes) and 32×32×3 (10) on
    64 images, card vs CPU on the same weights: logits and the
    ``apply_train`` logits under one fixed keep mask within CNN_ATOL, one
    step's gradients (with that mask) within CNN_ATOL by relative norm.
    Under the process's TF32 settings: prints them, and the error of the
    module's convolution (``_Conv5x5``) at Conv_1's shape beside a plain
    cuDNN convolution's with TF32 on and off, against an f64 CPU
    convolution; where TF32 shows in the plain one, the module's must
    stay at the f32 level. Times one forward and one local step at
    config 3's shape (B = 32, 32×32×3) with CUDA events."""
    import torch.nn.functional as F

    from qfedx_tpu_torch.models.cnn import _Conv5x5, make_tiny_cnn
    from qfedx_tpu_torch.utils import trees

    out = {}
    with process_tf32():
        print(f"[cnn] process TF32 settings: cudnn.allow_tf32="
              f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32="
              f"{torch.backends.cuda.matmul.allow_tf32} (the module runs "
              "its convolutions with cudnn TF32 off)")
        for (h, w, c, k) in ((28, 28, 1, 3), (32, 32, 3, 10)):
            card = make_tiny_cnn(k, h, w, c, device=device)
            cpu = make_tiny_cnn(k, h, w, c, device="cpu")
            params = cpu.init(7)
            dparams = trees.tree_map(lambda v: v.to(device), params)
            g = torch.Generator().manual_seed(h + c)
            x = torch.rand((64, h, w, c), generator=g)
            if c == 1:
                x = x[..., 0]
            y = torch.randint(0, k, (64,), generator=g)
            keep = torch.rand((64, 64), generator=g) < 0.5
            errs = {
                "logits": _max_err([card.apply(dparams, x.to(device)).cpu()],
                                   [cpu.apply(params, x)]),
                "apply_train": _max_err(
                    [card.apply_train(dparams, x.to(device), {
                        "dropout_keep": keep.to(device)}).cpu()],
                    [cpu.apply_train(params, x, {"dropout_keep": keep})]),
                "grad_rel": _rel_err(
                    _grads(card, dparams, x.to(device), y.to(device),
                           keep.to(device)),
                    _grads(cpu, params, x, y, keep)),
            }
            # Conv_1's input shape (16 channels at H/2 × W/2), TF32 on/off.
            xin = torch.rand((64, 16, h // 2, w // 2), generator=g)
            wk = params["Conv_1"]["kernel"].permute(3, 2, 0, 1)
            want = F.conv2d(xin.double(), wk.double(), padding=2)
            conv = {}
            for tf32 in (True, False):
                torch.backends.cudnn.allow_tf32 = tf32
                got = F.conv2d(xin.to(device), wk.to(device), padding=2)
                conv[tf32] = float((got.double().cpu() - want).abs().max())
            torch.backends.cudnn.allow_tf32 = PROCESS_TF32[0]
            got = _Conv5x5.apply(xin.to(device), wk.to(device),
                                 torch.zeros(wk.shape[0], device=device))
            conv["module"] = float((got.double().cpu() - want).abs().max())
            tf32_shows = conv[True] > 4 * conv[False]
            print(f"[cnn] {h}x{w}x{c}, {k} classes, B=64: logits max|card-"
                  f"cpu| {errs['logits']:.3e}, apply_train (fixed keep "
                  f"mask) {errs['apply_train']:.3e}, one step's gradients "
                  f"relative norm {errs['grad_rel']:.3e} (atol {CNN_ATOL:g});"
                  f" Conv_1's convolution vs f64: the module's "
                  f"{conv['module']:.3e}, plain cuDNN with TF32 on "
                  f"{conv[True]:.3e}, off {conv[False]:.3e} ("
                  + ("TF32 shows; the module's is at the f32 level"
                     if tf32_shows else "cuDNN's algorithm for this shape "
                     "does not round to TF32 either way") + ")")
            for what, err in errs.items():
                _require(err, CNN_ATOL, f"cnn {h}x{w}x{c} {what}")
            if tf32_shows and conv["module"] > 4 * conv[False]:
                raise AssertionError(f"cnn {h}x{w}x{c}: the module's "
                                     f"convolution ran in TF32 ({conv})")
            out[f"{h}x{w}x{c}"] = errs
        card = make_tiny_cnn(3, 32, 32, 3, device=device)
        dparams = card.init(0)
        x = torch.rand((32, 32, 32, 3), device=device)
        y = torch.randint(0, 3, (32,), device=device)
        keep = torch.rand((32, 64), device=device) < 0.5
        fwd = event_ms(lambda: card.apply(dparams, x), iters=50)
        step = event_ms(lambda: _grads(card, dparams, x, y, keep), iters=20)
        print(f"[time] cnn B=32 32x32x3 (config 3's step): forward "
              f"{fwd:.5f} ms, forward+backward {step:.5f} ms (CUDA events; "
              "cuDNN convolutions and torch elementwise, no hand kernel)")
    out["forward_ms"], out["step_ms"] = fwd, step
    out["logit_err"] = max(v["logits"] for k, v in out.items()
                           if isinstance(v, dict))
    return out


def _run_theta(run_dir, rnd: int) -> list:
    """θ of a run's checkpoint ``rnd`` as CPU tensors, the model built
    from the run's own config.json."""
    from qfedx_tpu_torch.run.checkpoint import Checkpointer
    from qfedx_tpu_torch.run.config import (
        build_model,
        experiment_config_from_dict,
    )
    from qfedx_tpu_torch.serve.engine import infer_num_classes

    cfg = experiment_config_from_dict(
        json.loads((run_dir / "config.json").read_text()))
    model = build_model(cfg, infer_num_classes(cfg), device="cpu")
    return _flat(Checkpointer(run_dir / "checkpoints").restore(
        rnd, model.init(0)))


def family_cli_train(root, argv, name: str, tag: str, atol: float,
                     expect_folded: bool) -> dict:
    """A CLI run of a non-VQC family on the card, then its first
    CPU_TWIN_ROUNDS round(s) on the CPU (the run saves every round): no
    scan-body launch and no build, those rounds' loss and θ card vs CPU
    within ``atol``, no quarantined update, every θ finite; the
    local-update route (folded or one client at a time) as
    ``expect_folded`` says; the synchronous round walls and
    client-rounds/s (host clock)."""
    from qfedx_tpu_torch.fed import round as fround
    from qfedx_tpu_torch.ops import scan_body

    routes = []
    folded_fn, client_fn = (fround.make_local_update_clients,
                            fround.make_local_update)

    def spy(route, fn):
        def build(*a, **k):
            routes.append(route)
            return fn(*a, **k)
        return build

    data = cli_data(argv)
    shapes = expected_shapes(argv, data)
    builds = scan_body.build_count
    fround.make_local_update_clients = spy("folded", folded_fn)
    fround.make_local_update = spy("one client at a time", client_fn)
    try:
        t0 = time.perf_counter()
        summary, launches, rounds, _ = cli_train(
            argv + ["--run-root", str(root), "--name", name], None, data)
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        cpu_argv, cpu_rounds = twin_argv(argv)
        cpu_summary, _, _, _ = cli_train(
            cpu_argv + ["--run-root", str(root / "cpu"), "--name", name],
            "cpu", data)
        cpu_wall = time.perf_counter() - t0
    finally:
        fround.make_local_update_clients = folded_fn
        fround.make_local_update = client_fn
    run, cpu_run = root / name, root / "cpu" / name
    rows, cpu_rows = _rows(run), _rows(cpu_run)
    clients = shapes["clients"]
    print(f"[{tag}] {' '.join(argv)}: {clients} clients x S_pad="
          f"{shapes['s_pad']}, {shapes['steps']} local steps per round, "
          f"route {sorted(set(routes))}; card {wall:.2f} s, cpu "
          f"{cpu_wall:.2f} s for {cpu_rounds} round(s) (host clock, "
          "in-process; the data built once, before both)")
    want_route = "folded" if expect_folded else "one client at a time"
    if set(routes) != {want_route}:
        raise AssertionError(f"{tag} trained {routes}, not {want_route}")
    for row, cpu in zip(rows, cpu_rows):
        loss_err = abs(row["loss"] - cpu["loss"])
        print(f"[{tag}] round {row['round']}: loss card {row['loss']!r} cpu "
              f"{cpu['loss']!r} |err|={loss_err:.3e} (atol {atol:g}), "
              f"accuracy card {row['accuracy']!r} cpu {cpu['accuracy']!r}, "
              f"rejected {row['rejected_updates']}, time_s "
              f"{row['time_s']!r} (cpu {cpu['time_s']!r}; a chunk of "
              f"{row['chunk_rounds']} round(s) shares its wall)")
        _require(loss_err, atol, f"{tag} round {row['round']} loss")
        if row["rejected_updates"] or cpu["rejected_updates"]:
            raise AssertionError(f"{tag}: a non-finite update was "
                                 "quarantined")
    theta = _run_theta(run, len(rows))
    theta_err = _max_err(_run_theta(run, cpu_rounds),
                         _run_theta(cpu_run, cpu_rounds))
    if not all(bool(torch.isfinite(t).all()) for t in theta):
        raise AssertionError(f"{tag}: non-finite θ")
    times = [r["time_s"] for r in rows]
    rate = clients * len(times) / sum(times)
    print(f"[{tag}] theta after round {cpu_rounds} max|card-cpu| "
          f"{theta_err:.3e} (atol "
          f"{atol:g}); launches {launches}, kernel builds "
          f"{scan_body.build_count - builds}; round walls (synchronous, host "
          f"clock) {times} s, {rate:.4f} client-rounds/s; final accuracy "
          f"card {summary['final_accuracy']!r}, cpu after {cpu_rounds} "
          f"round(s) {cpu_summary['final_accuracy']!r}")
    _require(theta_err, atol, f"{tag} theta")
    if launches != NO_LAUNCH or any(c != NO_LAUNCH for c, _ in rounds) or \
            scan_body.build_count != builds:
        raise AssertionError(f"{tag} launched {launches} or built")
    return {"run": run, "launches": launches, "theta_err": theta_err,
            "rate": rate, "times": times, "summary": summary,
            "shapes": shapes}


def phase_config3(root) -> dict:
    """``[config3]``: BASELINE.md config 3 (CONFIG3_ARGV) through the CLI
    under the process's TF32 settings, card vs CPU (loss and θ within
    CNN_ATOL under SGD, 0 launches, one client at a time: dropout), then
    ``serve --run-dir`` of it: 64 image requests and one malformed line,
    logits card vs CPU within CNN_ATOL."""
    from qfedx_tpu_torch.models.cnn import make_tiny_cnn
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.run import cli
    from qfedx_tpu_torch.run.checkpoint import Checkpointer

    print("[config3] no --raw-folder and no CIFAR-10 files in the "
          "checkout: build_data takes its synthetic CIFAR-10 (32x32x3, the "
          "real set's shapes; real CIFAR-10 waits until its files are in "
          "the repository)")
    with process_tf32():
        run = family_cli_train(root, CONFIG3_ARGV, "config3", "config3",
                               CNN_ATOL, expect_folded=False)
        x = np.random.default_rng(23).uniform(0, 1, (N_SERVE_REQUESTS, 32,
                                                     32, 3))
        x = x.astype(np.float32)
        lines = [json.dumps({"id": i, "features": v.tolist()})
                 for i, v in enumerate(x)]
        lines.insert(10, "{malformed")
        (root / "images.jsonl").write_text("\n".join(lines) + "\n")
        out = root / "image-responses.jsonl"
        scan_body.reset_counts()
        summary = cli.main(["serve", "--run-dir", str(run["run"]),
                            "--input", str(root / "images.jsonl"),
                            "--output", str(out)])
        launches = dict(scan_body.launch_counts)
    resp = [json.loads(line) for line in out.read_text().splitlines()]
    bad = [r for r in resp if "error" in r]
    if len(resp) != N_SERVE_REQUESTS + 1 or len(bad) != 1 or \
            bad[0]["code"] != 400:
        raise AssertionError(f"config3 serve answered {len(resp)} lines, "
                             f"errors {bad}")
    model = make_tiny_cnn(3, 32, 32, 3, device="cpu")
    params, _ = Checkpointer(run["run"] / "checkpoints").restore_latest(
        model.init(0))
    with torch.no_grad():
        want = model.apply(params, x).numpy()
    got = np.array([r["logits"] for r in resp if "logits" in r])
    err = float(np.abs(got - want).max())
    print(f"[config3] serve --run-dir: {summary['served']} image requests "
          f"served, {summary['responses']} responses, batches "
          f"{summary['batches']}, latency p50={summary['p50_ms']} ms p95="
          f"{summary['p95_ms']} ms; logits max|card-cpu|={err:.3e} (atol "
          f"{CNN_ATOL:g}); launches {launches}")
    _require(err, CNN_ATOL, "config3 served logits vs cpu")
    if launches != NO_LAUNCH:
        raise AssertionError(f"config3 serve launched {launches}")
    return {**run, "serve_launches": launches, "serve_err": err}


def phase_config5(root) -> dict:
    """``[config5]``: BASELINE.md config 5 (CONFIG5_ARGV) through the CLI,
    card vs CPU: the folded route (one program of 256 clients), loss and
    θ within QKERNEL_ATOL, 0 launches; round walls and client-rounds/s."""
    return family_cli_train(root, CONFIG5_ARGV, "config5", "config5",
                            QKERNEL_ATOL, expect_folded=True)


def phase_mps(root, device) -> dict:
    """``[mps]``: the MPS classifier.

    - library, exact bond dimension (n = 8, χ = 16, L = 2, 64 samples):
      ⟨Z⟩ and one loss's ∂/∂θ against the port's dense RY + CNOT-line
      statevector on the card (MPS_Z_ATOL, MPS_GRAD_ATOL);
    - the batched SVD at n = 24, χ = 16, B = 32: calls per forward
      (L·(n−1)), one call's time (CUDA events), whether a call
      synchronises the host (``torch.cuda.set_sync_debug_mode``), and its
      share of one local step's forward+backward;
    - MPS_ARGV through the CLI, card vs CPU within MPS_CLI_ATOL, every
      update finite (no quarantined client), 0 launches, one client at a
      time."""
    import warnings

    from qfedx_tpu_torch.circuits.encoders import angle_encode
    from qfedx_tpu_torch.models.vqc_mps import _ry_mats, make_mps_classifier
    from qfedx_tpu_torch.ops import gates, linalg, mps
    from qfedx_tpu_torch.ops import statevector as sv

    n, layers, chi = 8, 2, 16
    g = torch.Generator().manual_seed(8)
    ry = (0.8 * torch.randn((layers, n), generator=g)).to(device)
    x = torch.rand((64, n), generator=g).to(device)
    w = torch.randn(n, generator=g).to(device)

    def mps_z(theta):
        sites = mps.product_mps(_ry_mats(x * math.pi)[..., 0], chi)
        for layer in range(layers):
            sites = mps.apply_1q_all(sites, _ry_mats(theta[layer]))
            sites = mps.apply_cnot_chain(sites)
        return mps.expect_z_all(sites)

    def dense_z(theta):
        state = angle_encode(x)
        for layer in range(layers):
            for q in range(n):
                state = sv.apply_gate(state, gates.ry(theta[layer, q]), q, n)
            for q in range(n - 1):
                state = sv.apply_gate_2q(state, gates.CNOT, q, q + 1, n)
        return sv.expect_z_all(state, n)

    def z_and_grad(fn):
        theta = ry.clone().requires_grad_(True)
        z = fn(theta)
        loss = torch.sum(z * w) / z.shape[0]
        return z.detach(), torch.autograd.grad(loss, theta)[0]

    (zm, gm), (zd, gd) = z_and_grad(mps_z), z_and_grad(dense_z)
    z_err, g_err = float((zm - zd).abs().max()), float((gm - gd).abs().max())
    print(f"[mps] library n={n} chi={chi} L={layers}, 64 samples, on the "
          f"card: <Z> max|mps-dense| {z_err:.3e} (atol {MPS_Z_ATOL:g}), "
          f"d(mean w.<Z>)/dtheta max|mps-dense| {g_err:.3e} (atol "
          f"{MPS_GRAD_ATOL:g}; max|grad| {float(gd.abs().max()):.3f})")
    _require(z_err, MPS_Z_ATOL, "mps <Z> vs dense")
    _require(g_err, MPS_GRAD_ATOL, "mps gradient vs dense")

    n, layers, bsz = 24, 2, 32
    model = make_mps_classifier(n, layers, 2, chi, device=device)
    params = model.init(0)
    xb = torch.rand((bsz, n), generator=g).to(device)
    yb = torch.randint(0, 2, (bsz,), generator=g).to(device)
    calls = []
    stock = linalg.truncated_svd

    def counted(m, k, eps=1e-10):
        calls.append(tuple(m.shape))
        return stock(m, k, eps)

    mps.truncated_svd = counted
    try:
        model.apply(params, xb)
    finally:
        mps.truncated_svd = stock
    m = torch.rand((bsz, 2 * chi, 2 * chi), generator=g).to(device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as syncs:
            warnings.simplefilter("always")
            torch.linalg.svd(m, full_matrices=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    n_sync = sum("synchronizing" in str(s.message) for s in syncs)
    svd_ms = event_ms(lambda: torch.linalg.svd(m, full_matrices=False),
                      iters=50)
    step_ms = event_ms(lambda: _grads(model, params, xb, yb), iters=10)
    share = len(calls) * svd_ms / step_ms
    print(f"[mps] n={n} chi={chi} L={layers} B={bsz}: {len(calls)} batched "
          f"SVD calls per forward (L*(n-1) = {layers * (n - 1)}) of "
          f"{calls[0]}; one call {svd_ms:.5f} ms (CUDA events); each call "
          f"synchronises the host: {'yes' if n_sync else 'no'} ({n_sync} "
          f"sync points flagged by torch's sync debug mode: cuSOLVER's info "
          f"check); one local step forward+backward {step_ms:.5f} ms, the "
          f"forward's SVDs {share:.1%} of it")
    if len(calls) != layers * (n - 1):
        raise AssertionError(f"{len(calls)} SVD calls per forward")
    run = family_cli_train(root, MPS_ARGV, "mps-cli", "mps", MPS_CLI_ATOL,
                           expect_folded=False)
    return {**run, "z_err": z_err, "grad_err": g_err, "svd_ms": svd_ms,
            "step_ms": step_ms, "svd_calls": len(calls), "syncs": n_sync}


# --- noise on the VQC (noise/) -----------------------------------------------

NOISE_ARGV = ["train", "--model", "vqc", "--qubits", "12", "--layers", "3",
              "--classes", "0,1", "--clients", "4", "--rounds", "3",
              "--local-epochs", "1", "--checkpoint-every", "1",
              "--depolarizing", "0.02", "--damping", "0.01",
              "--readout-flip", "0.02", "--shots", "1024"]
NOISE_CIRCUIT_ARGV = NOISE_ARGV + ["--noise-placement", "circuit"]
TRAJECTORIES = 4096
TRAJECTORY_SIGMAS = 4.0  # trajectory mean vs the analytic map, in σ
# Beyond the σ bound: f32 rounding of the trajectories' mean ⟨Z⟩ (a
# qubit near |0⟩ has σ ≈ 0 under damping).
TRAJECTORY_ROUND = 2e-6
TRAJECTORY_TWINS = 256  # trajectories rerun on the CPU on the same draws


def _noise_model_of(argv, device="cpu"):
    from qfedx_tpu_torch.run import cli
    from qfedx_tpu_torch.run.config import build_model
    from qfedx_tpu_torch.serve.engine import infer_num_classes

    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    return cfg, build_model(cfg, infer_num_classes(cfg), device=device)


def noisy_step_ms(argv, batch: int = 32, iters: int = 10) -> float:
    """One local step's ``apply_train`` at ``batch`` on the card, no
    autograd (under shots the step's only forward): host clock around
    ``synchronize``, mean of ``iters`` calls after one warm-up."""
    from qfedx_tpu_torch.fed.round import RoundDraws
    from qfedx_tpu_torch.utils import pins

    device = pins.resolve_device(None)
    cfg, model = _noise_model_of(argv, device)
    params = model.init(cfg.seed)
    x = torch.rand((batch, cfg.model.n_qubits),
                   generator=torch.Generator().manual_seed(940)).to(device)
    draws = {k: v[0, 0] for k, v in RoundDraws(cfg.seed, 0).train_draws(
        model.train_draws, 1, 1, batch, device).items()}
    with torch.no_grad():
        model.apply_train(params, x, draws)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            model.apply_train(params, x, draws)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def phase_noise_cli(root, argv, name: str, tag: str) -> dict:
    """``[noise-readout]``/``[noise-circuit]``: a noisy ``train`` at
    n = 12 (``argv``) on the card and the CPU through
    ``phase_encoding_cli_train``: loss and θ within TRAINED_LOGIT_ATOL,
    Launch A in evaluation; per local step one Launch A for each client
    under readout shots (the counts carry no gradient, so the state runs
    without autograd, and the clients train one at a time), none under
    circuit placement (the channels after every layer keep the per-layer
    loop). With shots the ansatz leaves of every checkpoint equal their
    initial values bit for bit. Prints the Kraus branch choices that
    differ between the card and the CPU (0 expected; a near-tie of Born
    weights may flip one) and the round time."""
    from qfedx_tpu_torch.run.checkpoint import Checkpointer

    cfg, model = _noise_model_of(argv)
    circuit = cfg.model.noise_placement == "circuit"
    clients = cfg.data.num_clients
    per_step = {"fwd": 0 if circuit else clients, "fwd_bnd": 0, "adj": 0}
    record: dict = {}
    run = phase_encoding_cli_train(root, argv, name, tag, "angle",
                                   per_step=per_step, record=record,
                                   own_data=True)
    cpu = record["cpu"]
    # The branch choices of the rounds the CPU twin ran come first.
    card = [t.cpu() for t in record["card"][:len(cpu)]]
    if len(card) != len(cpu) or any(a.shape != b.shape
                                    for a, b in zip(card, cpu)):
        raise AssertionError(f"{tag}: the card made {len(card)} branch "
                             f"calls, the CPU {len(cpu)}")
    choices = sum(int(a.numel()) for a in card)
    differ = sum(int((a != b).sum()) for a, b in zip(card, cpu))
    if circuit and choices == 0:
        raise AssertionError(f"{tag}: no Kraus branch was drawn")
    init = model.init(cfg.seed)
    ckpt = Checkpointer(run["run"] / "checkpoints")
    moved = []
    for r in range(1, cfg.num_rounds + 1):
        theta = ckpt.restore(r, init)
        moved += [f"round {r} {k}" for k in ("rx", "rz")
                  if not torch.equal(theta["ansatz"][k], init["ansatz"][k])]
        if torch.equal(theta["readout"]["scale"], init["readout"]["scale"]):
            raise AssertionError(f"{tag}: the readout did not learn")
    # The pipelined rows' time_s are drain-to-drain increments and
    # resolve no rate; the whole card run bounds a round from above.
    round_s = run["wall"] / cfg.num_rounds
    print(f"[{tag}] Kraus branch choices card vs cpu over the first "
          f"{run['cpu_rounds']} round(s): {differ} of {choices} "
          "differ (0 expected; a near-tie of Born weights may flip one); "
          f"ansatz leaves moved: {moved or 'none'} (shots: the counts carry "
          f"no gradient); round time {round_s:.4f} s, "
          f"{clients / round_s:.4f} client-rounds/s (the whole card run over "
          f"its {cfg.num_rounds} rounds, host clock, data, evaluation and "
          "checkpoints included; rows' drain-to-drain time_s "
          f"{[row['time_s'] for row in run['rows']]}); whole run card "
          f"{run['wall']:.2f} s, cpu {run['cpu_wall']:.2f} s")
    if moved:
        raise AssertionError(f"{tag}: shots moved the ansatz: {moved}")
    step_ms = noisy_step_ms(argv)
    print(f"[{tag}] a local step's forward (apply_train, B = 32, the "
          f"card): {step_ms:.4f} ms (host clock around synchronize, 10 "
          "calls)")
    run.update(branch_choices=choices, branch_differ=differ, round_s=round_s,
               rate=clients / round_s, step_ms=step_ms)
    return run


def phase_noise_serve(root, run_dir, argv, tag: str) -> dict:
    """``serve --run-dir`` of a noisy run (in-process) on the card: 64
    requests and one malformed line, the logits against the CPU port's
    run restored through ``serve.engine_from_run_dir`` (the evaluator's
    noise: no shots, composed strengths under circuit placement) within
    LOGIT_ATOL, and exactly one Launch A per served batch and per warmed
    bucket."""
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.run import cli
    from qfedx_tpu_torch.serve import engine_from_run_dir

    cfg, _ = _noise_model_of(argv)
    n = cfg.model.n_qubits
    x = np.random.default_rng(19).uniform(0, 1, (N_SERVE_REQUESTS, n))
    x = x.astype(np.float32)
    lines = [json.dumps({"id": f"q{i}", "features": v.tolist()})
             for i, v in enumerate(x)]
    lines.insert(10, "{malformed")
    (root / "noise-requests.jsonl").write_text("\n".join(lines) + "\n")
    out = root / "noise-responses.jsonl"
    scan_body.reset_counts()
    summary = cli.main(["serve", "--run-dir", str(run_dir), "--input",
                        str(root / "noise-requests.jsonl"), "--output",
                        str(out)])
    launches = dict(scan_body.launch_counts)
    resp = [json.loads(line) for line in out.read_text().splitlines()]
    bad = [r for r in resp if "error" in r]
    if len(bad) != 1 or bad[0]["code"] != 400 or bad[0]["id"] != 10:
        raise AssertionError(f"{tag}: error responses {bad}")
    got = np.array([r["logits"] for r in resp if "logits" in r])
    engine, _ = engine_from_run_dir(run_dir, device="cpu")
    with torch.no_grad():
        want = engine.model.apply(engine.params, x).numpy()
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{tag}: served logits of shape {got.shape}")
    err = float(np.abs(got - want).max())
    eval_noise = cfg.model
    print(f"[{tag}] {summary['served']} served, batches "
          f"{summary['batches']}, latency p50={summary['p50_ms']} ms p95="
          f"{summary['p95_ms']} ms (host clock); logits max|card-cpu|="
          f"{err:.3e} (atol {LOGIT_ATOL:g}); launches {launches} (one A per "
          f"batch and per warmed bucket {BUCKETS}); noise "
          f"p={eval_noise.depolarizing_p} gamma={eval_noise.amp_damping_gamma}"
          f" flip={eval_noise.readout_flip} placement "
          f"{eval_noise.noise_placement}")
    _require(err, LOGIT_ATOL, f"{tag} served logits vs cpu")
    want_l = {"fwd": summary["batches"] + len(BUCKETS), "fwd_bnd": 0,
              "adj": 0}
    if launches != want_l:
        raise AssertionError(f"{tag}: serving launched {launches}, "
                             f"expected {want_l}")
    return {"launches": launches, "logit_err": err,
            "p50": summary["p50_ms"], "p95": summary["p95_ms"]}


def branch_moments(kraus, amps) -> tuple:
    """Per qubit of a product state, the mean and variance of ⟨Z⟩ after
    one sampled branch of ``kraus`` ((k, 2, 2) complex numpy) on its
    single-qubit amplitudes ``amps`` ((n, 2) complex): branch i with
    probability p_i = ‖K_i a‖² leaves ⟨Z⟩ = z_i. The other qubits'
    branches leave a product state's marginal alone, so these are exact,
    rare branches included."""
    out = np.einsum("kij,nj->nki", kraus, amps)
    p = np.sum(np.abs(out) ** 2, axis=-1)
    z = (np.abs(out[..., 0]) ** 2 - np.abs(out[..., 1]) ** 2) / np.maximum(
        p, 1e-300)
    mean = np.sum(p * z, axis=-1)
    return mean, np.sum(p * z * z, axis=-1) - mean ** 2


def phase_noise_trajectory(device) -> dict:
    """``[noise-trajectory]``: 4096 trajectories at n = 12 on the card,
    one of depolarizing (p = 0.3) and one of damping (γ = 0.3) on every
    qubit of an angle-encoded product state: ``trajectory_average``'s
    ⟨Z_q⟩ within TRAJECTORY_SIGMAS standard errors (plus
    TRAJECTORY_ROUND) of ``NoiseModel.apply_to_z``'s analytic value,
    exact for a product state, σ the branch distribution's own standard
    deviation over √T (``branch_moments``, whose mean must equal the
    analytic map); and the first TRAJECTORY_TWINS trajectories rerun on
    the CPU on the same Gumbel draws (their ⟨Z⟩ within LOGIT_ATOL, branch
    choices counted)."""
    from qfedx_tpu_torch.circuits.encoders import angle_amplitudes, angle_encode
    from qfedx_tpu_torch.noise import NoiseModel, trajectory
    from qfedx_tpu_torch.ops.cpx import to_complex
    from qfedx_tpu_torch.ops.statevector import expect_z_all

    n, t = 12, TRAJECTORIES
    gen = torch.Generator().manual_seed(930)
    feats = torch.rand((1, n), generator=gen)
    amps = to_complex(angle_amplitudes(feats[0] * math.pi, "ry"))
    out = {}
    for name, nm in (("depolarizing", NoiseModel(depolarizing_p=0.3)),
                     ("damping", NoiseModel(amp_damping_gamma=0.3))):
        u = torch.clamp(torch.rand((t, n, 4), generator=gen),
                        min=torch.finfo(torch.float32).tiny)
        g = -torch.log(-torch.log(u))

        def observable(draws, dev):
            kraus = nm.kraus_channels(dev)[0]
            state = angle_encode(feats.to(dev).expand(draws.shape[0], n))
            state = trajectory.apply_channel_all(state, kraus, draws, n)
            return expect_z_all(state, n)

        with trajectory.record_branches() as card_log:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mean = trajectory.trajectory_average(
                lambda d: observable(d, device), t)(g.to(device))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        mean = mean.cpu().double()
        z0 = expect_z_all(angle_encode(feats), n)[0]
        want = nm.apply_to_z(z0).double()
        b_mean, b_var = branch_moments(to_complex(nm.kraus_channels(
            "cpu")[0]), amps)
        _require(float((torch.as_tensor(b_mean) - want).abs().max()), 1e-6,
                 f"noise-trajectory {name}: branch moments vs apply_to_z")
        sigma = torch.as_tensor(np.sqrt(np.maximum(b_var, 0.0) / t))
        excess = torch.clamp((mean - want).abs() - TRAJECTORY_ROUND, min=0)
        worst = float((excess / torch.clamp(sigma, min=1e-12)).max())
        with trajectory.record_branches() as cpu_log:
            z_cpu = observable(g[:TRAJECTORY_TWINS], "cpu")
        with torch.no_grad():
            z_twin = observable(g[:TRAJECTORY_TWINS].to(device), device)
        twin_err = float((z_twin.cpu() - z_cpu).abs().max())
        differ = sum(int((a[:TRAJECTORY_TWINS].cpu() != b).sum())
                     for a, b in zip(card_log, cpu_log))
        print(f"[noise-trajectory] {name} at n={n}, {t} trajectories on the "
              f"card: max (|mean - analytic| - {TRAJECTORY_ROUND:g}) / sigma "
              f"over the {n} qubits {worst:.3f} (limit "
              f"{TRAJECTORY_SIGMAS:g}; sigma from the branch distribution, "
              f"{float(sigma.min()):.3e} to {float(sigma.max()):.3e}); max "
              f"|mean - analytic| {float((mean - want).abs().max()):.3e}; "
              f"{ms:.3f} ms for the {n} channel applications and the mean "
              f"(host clock around synchronize); CPU twin of "
              f"{TRAJECTORY_TWINS} trajectories: <Z> max|card-cpu| "
              f"{twin_err:.3e} (atol {LOGIT_ATOL:g}), {differ} of "
              f"{TRAJECTORY_TWINS * n} branch choices differ")
        if worst > TRAJECTORY_SIGMAS:
            raise AssertionError(f"noise-trajectory {name}: the trajectory "
                                 f"mean is {worst:.2f} sigma from the "
                                 "analytic map")
        _require(twin_err, LOGIT_ATOL, f"noise-trajectory {name} cpu twin")
        out[name] = {"sigmas": worst, "ms": ms, "twin_err": twin_err,
                     "differ": differ}
    return out


# The port's launches per noise mode at n = 12, L = 3 (evaluation, one
# local step), as tests/test_torch_noise.py::test_route_probe holds them
# against the reference's on the CPU.
NOISE_PROBE = {
    "readout": ({"fwd": 1, "fwd_bnd": 0, "adj": 0},
                {"fwd": 0, "fwd_bnd": 1, "adj": 1}),
    "shots": ({"fwd": 1, "fwd_bnd": 0, "adj": 0},
              {"fwd": 1, "fwd_bnd": 0, "adj": 0}),
    "circuit": ({"fwd": 1, "fwd_bnd": 0, "adj": 0}, NO_LAUNCH),
    "circuit-spsa": ({"fwd": 1, "fwd_bnd": 0, "adj": 0}, NO_LAUNCH),
}


def phase_noise_probe(device) -> dict:
    """``[noise-probe]``: per noise mode at n = 12, L = 3, B = 32 on the
    card, the launches of one evaluation forward and of one local step
    through ``fed/client`` (readout noise without shots folded over two
    clients; shots, circuit placement and SPSA under it one client),
    each required to equal NOISE_PROBE."""
    from qfedx_tpu_torch.fed import client
    from qfedx_tpu_torch.fed.config import FedConfig
    from qfedx_tpu_torch.fed.round import RoundDraws
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.noise import NoiseModel
    from qfedx_tpu_torch.ops import scan_body

    n, layers, b = 12, 3, 32
    gen = torch.Generator().manual_seed(950)
    x = torch.rand((b, n), generator=gen).to(device)
    y = torch.randint(0, 2, (b,), generator=gen).to(device)
    m = torch.ones(b, device=device)
    perms = torch.arange(b)[None]
    out = {}
    for mode, (want_eval, want_step) in NOISE_PROBE.items():
        nm = NoiseModel(0.02, 0.01, 0.02, 0.02,
                        shots=1024 if mode == "shots" else None,
                        circuit_level=mode.startswith("circuit"))
        model = make_vqc_classifier(n, layers, 2, device=device,
                                    noise_model=nm)
        params = model.init(3)
        cfg = FedConfig(local_epochs=1, batch_size=b, learning_rate=0.05,
                        optimizer="spsa" if mode == "circuit-spsa"
                        else "adam")
        draws = RoundDraws(3, 0)
        scan_body.reset_counts()
        with torch.no_grad():
            model.apply(params, x)
        got_eval = dict(scan_body.launch_counts)
        scan_body.reset_counts()
        if mode == "readout":
            client.make_local_update_clients(model, cfg)(
                params, x[None].expand(2, b, n), y[None].expand(2, b),
                m[None].expand(2, b), perms=perms[None].expand(2, 1, b))
        else:
            step = (None if mode != "circuit-spsa" else trees_first(
                draws.tree("spsa_delta", params, 1, 1)))
            tdraws = {k: v[0] for k, v in draws.train_draws(
                model.train_draws, 1, 1, b, device).items()}
            client.make_local_update(model, cfg)(
                params, x, y, m, perms, step_draws=step,
                train_draws=tdraws)
        got_step = dict(scan_body.launch_counts)
        print(f"[noise-probe] {mode}: evaluation {got_eval} (expected "
              f"{want_eval}), one local step {got_step} (expected "
              f"{want_step})")
        if (got_eval, got_step) != (want_eval, want_step):
            raise AssertionError(f"noise-probe {mode}: launched "
                                 f"{got_eval}, {got_step}")
        out[mode] = {"eval": got_eval, "step": got_step}
    return out


STREAM_DEADLINE_S = 0.5  # [streamed-stale]'s wave deadline
# The one-round card/CPU twins of [streamed] (2 waves of 256) and
# [streamed-kernel] (2 waves of 32): a smaller cohort in the same waves.
STREAM_TWIN_COHORT = {"streamed": 512, "streamed-kernel": 64}


def _streamed(model, cfg, registry, test, device, rounds, launch_log=None,
              **kw):
    """``train_federated_streamed`` on ``device`` with the launch counts
    reset just before; returns (result, rows, launches). ``launch_log``
    collects each round's launches (taken in ``on_round_end``)."""
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.run.trainer import train_federated_streamed

    rows = []

    def hook(r, m):
        rows.append(m)
        if launch_log is not None:
            launch_log.append((dict(scan_body.launch_counts),
                               scan_body.build_count))
        if "hook" in kw:
            kw["hook"](r, m)

    hookless = {k: v for k, v in kw.items() if k != "hook"}
    scan_body.reset_counts()
    res = train_federated_streamed(model, cfg, registry, *test,
                                   num_rounds=rounds, device=device,
                                   on_round_end=hook, **hookless)
    if str(device) != "cpu":
        torch.cuda.synchronize()
    return res, rows, dict(scan_body.launch_counts)


def _theta(params) -> list:
    return [t.detach().float().cpu() for t in trees_leaves(params)]


def _adam_card_vs_cpu(make, card, cpu, test) -> tuple[float, float]:
    """Card vs CPU after Adam rounds of one local step: the logits on the
    evaluation samples (gated) and θ (printed). Adam's first step is
    lr·g/(|g| + ε), so an angle whose gradient is zero analytically (the
    last layer's RZ, which commutes with the Z readout, and the angles
    outside the readout qubits' light cone) steps ±lr on each device's
    own rounding noise; those angles cannot move the logits."""
    x = torch.as_tensor(test[0][:256], dtype=torch.float32)
    dev = trees_leaves(card)[0].device
    with torch.no_grad():
        got = make(dev).apply(card, x.to(dev))
        want = make("cpu").apply(cpu, x)
    return _max_err(got.cpu(), want), _max_err(_theta(card), _theta(cpu))


def trees_leaves(params) -> list:
    from qfedx_tpu_torch.utils import trees

    return trees.tree_leaves(params)


def _finite(what: str, params, rows) -> None:
    bad = [r["round"] for r in rows if not math.isfinite(r["loss"])
           or r.get("rejected_updates", 0)]
    if bad or not all(bool(torch.isfinite(t).all()) for t in
                      trees_leaves(params)):
        raise AssertionError(f"{what}: a non-finite update (rounds {bad})")


def _registry_test_set(registry, n: int, clients: int = 8):
    """Evaluation samples of the registry's own distribution: the top
    ``clients`` ids (bench.py's choice)."""
    top = registry.num_clients
    ex, ey, _ = registry.batch(np.arange(top - clients, top))
    return ex.reshape(-1, n), ey.reshape(-1)


def phase_streamed(device) -> dict:
    """``[streamed]``: bench.py's streamed row (``_bench_fed_streamed``)
    at full size on the card, depth 1, 3 rounds, then 2 rounds at
    QFEDX_STREAM=0, then one round on the card and the CPU."""
    from qfedx_tpu_torch.data.stream import SyntheticRegistry
    from qfedx_tpu_torch.fed.config import FedConfig
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier

    n, layers, cohort, wave = 8, 3, 4096, 256
    registry = SyntheticRegistry(1 << 20, samples=8, n_features=n, seed=1)
    test = _registry_test_set(registry, n, 32)
    cfg = FedConfig(local_epochs=1, batch_size=8, learning_rate=0.1,
                    optimizer="adam", client_fraction=0.5, secure_agg=True,
                    secure_agg_mode="ring")
    kw = dict(cohort_size=cohort, wave_size=wave, seed=0)

    def model(dev):
        return make_vqc_classifier(n, layers, 2, device=dev)

    torch.cuda.reset_peak_memory_stats()
    res, rows, launches = _streamed(model(device), cfg, registry, test,
                                    device, 3, stream_depth=1,
                                    eval_every=4, **kw)
    peak = torch.cuda.max_memory_allocated()
    _finite("streamed", res.params, rows)
    walls = [r["time_s"] for r in rows]
    steady = float(np.median(walls[1:]))
    with env_pins(QFEDX_STREAM="0"):
        sync, sync_rows, sync_launches = _streamed(
            model(device), cfg, registry, test, device, 2, eval_every=3,
            **kw)
    sync_s = sync_rows[-1]["time_s"]
    print(f"[streamed] registry 2^20, cohort {cohort} in {cohort // wave} "
          f"waves of {wave}, n={n} L={layers}, Adam, fraction 0.5, ring "
          f"masks, depth 1: round walls {walls} s (time_s: host clock, "
          f"ending at the stats read that synchronises), "
          f"{cohort / steady:.4f} client-rounds/s (cohort / median round "
          f"after the first), participants {[r['participants'] for r in rows]}"
          f", comm_mb_per_round {res.comm_mb_per_round!r}, peak device "
          f"memory {peak} B; QFEDX_STREAM=0: round walls "
          f"{[r['time_s'] for r in sync_rows]} s, sync/overlap "
          f"{sync_s / steady:.4f}; launches {launches} and {sync_launches}")
    if launches != NO_LAUNCH or sync_launches != NO_LAUNCH:
        raise AssertionError(f"streamed n=8 launched {launches}, "
                             f"{sync_launches}")
    _finite("streamed QFEDX_STREAM=0", sync.params, sync_rows)
    one = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        r1, rows1, _ = _streamed(model(dev), cfg, registry, test, dev, 1,
                                 eval_every=2, **{
                                     **kw, "cohort_size":
                                     STREAM_TWIN_COHORT["streamed"]})
        one[str(dev)] = (r1.params, rows1[0]["loss"],
                         time.perf_counter() - t0)
    (card, card_loss, card_s), (cpu, cpu_loss, cpu_s) = (one[str(device)],
                                                         one["cpu"])
    err, theta_err = _adam_card_vs_cpu(model, card, cpu, test)
    print(f"[streamed] one round of a cohort of "
          f"{STREAM_TWIN_COHORT['streamed']} card vs cpu ({card_s:.2f} s and "
          f"{cpu_s:.2f} s): logits max|card-cpu| {err:.3e}, loss "
          f"{card_loss!r} vs {cpu_loss!r} (atol {TRAINED_LOGIT_ATOL:g}); "
          f"theta {theta_err:.3e} (Adam's ±lr steps on zero-gradient "
          "angles, not gated)")
    _require(max(err, abs(card_loss - cpu_loss)), TRAINED_LOGIT_ATOL,
             "streamed round, card vs cpu")
    return {"launches": launches, "rate": cohort / steady,
            "walls": walls, "sync_ratio": sync_s / steady, "peak": peak,
            "comm_mb": res.comm_mb_per_round, "logit_err": err,
            "theta_err": theta_err}


def phase_streamed_kernel(device) -> dict:
    """``[streamed-kernel]``: the n = 12, L = 3 VQC streamed through
    waves of 32 clients (the most groups a stacked program hands the
    kernel): one B and one C per wave per local step on the card."""
    from qfedx_tpu_torch.data.stream import SyntheticRegistry
    from qfedx_tpu_torch.fed.config import FedConfig
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier

    n, layers, cohort, wave, batch, rounds = 12, 3, 256, 32, 8, 3
    registry = SyntheticRegistry(1 << 16, samples=8, n_features=n, seed=2)
    test = _registry_test_set(registry, n)
    cfg = FedConfig(local_epochs=1, batch_size=batch, learning_rate=0.1,
                    optimizer="adam")
    kw = dict(cohort_size=cohort, wave_size=wave, seed=0, eval_every=1)
    waves, steps = cohort // wave, registry.samples // batch
    log = []
    res, rows, launches = _streamed(
        make_vqc_classifier(n, layers, 2, device=device), cfg, registry,
        test, device, rounds, launch_log=log, **kw)
    _finite("streamed-kernel", res.params, rows)
    prev = {"fwd": 0, "fwd_bnd": 0, "adj": 0}
    for r, (counts, builds) in enumerate(log):
        per = {k: counts[k] - prev[k] for k in prev}
        prev = counts
        evals = 2 if r == 0 else 1  # round 0 also evaluates θ_0
        want = {"fwd": evals, "fwd_bnd": waves * steps,
                "adj": waves * steps}
        print(f"[streamed-kernel] round {r}: wall {rows[r]['time_s']!r} s "
              f"(host clock), launches {per} (expected {want}), builds "
              f"{builds}, loss {rows[r]['loss']!r}")
        if per != want:
            raise AssertionError(f"streamed-kernel round {r} launched {per}")
    if log[-1][1] != log[0][1]:
        raise AssertionError("the kernel library was built after round 1")
    walls = [r["time_s"] for r in rows]
    rate = cohort / float(np.median(walls[1:]))
    # The CPU twin: one round of a smaller cohort in the same waves (the
    # plain sweep at tb = 256 takes seconds a wave on the host).
    one = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        r1, rows1, _ = _streamed(make_vqc_classifier(n, layers, 2,
                                                     device=dev),
                                 cfg, registry, test, dev, 1,
                                 **{**kw, "eval_every": 2,
                                    "cohort_size":
                                    STREAM_TWIN_COHORT["streamed-kernel"]})
        one[str(dev)] = (r1.params, rows1[0]["loss"],
                         time.perf_counter() - t0)
    (card, card_loss, card_s), (cpu, cpu_loss, cpu_s) = (one[str(device)],
                                                         one["cpu"])
    logit_err, theta_err = _adam_card_vs_cpu(
        lambda dev: make_vqc_classifier(n, layers, 2, device=dev), card,
        cpu, test)
    err = max(logit_err, abs(card_loss - cpu_loss))
    print(f"[streamed-kernel] {rate:.4f} client-rounds/s after round 0; "
          f"one round of a cohort of {STREAM_TWIN_COHORT['streamed-kernel']} "
          "card vs cpu "
          f"({card_s:.2f} s and {cpu_s:.2f} s): logits "
          f"max|card-cpu| {logit_err:.3e}, loss "
          f"{abs(card_loss - cpu_loss):.3e} (atol {TRAINED_LOGIT_ATOL:g}); "
          f"theta {theta_err:.3e} (Adam's ±lr steps on zero-gradient "
          "angles, not gated)")
    _require(err, TRAINED_LOGIT_ATOL, "streamed-kernel round, card vs cpu")
    _, leaves, xb, _ = _client_batch(n, layers, 2, wave, batch, device,
                                     seed=940)
    model = make_vqc_classifier(n, layers, 2, device=device)
    packed, spec, xs = captured_program(
        lambda: model.apply_clients(leaves, xb), n)
    if spec.tb != wave * batch or sorted({op.groups for op in spec.ops
                                          if op.stacked}) != [wave]:
        raise AssertionError(f"a wave's program: tb={spec.tb}, groups "
                             f"{[op.groups for op in spec.ops]}")
    errs, trows = hold_program("streamed-kernel", f"a wave of {wave} "
                               f"clients x {batch}", packed, spec, xs,
                               seed=941, timed=("B", "C"))
    return {"launches": launches, "rate": rate, "walls": walls,
            "logit_err": err, "theta_err": theta_err, "errs": errs,
            "rows": trows}


class _GatedRegistry:
    """A ``SyntheticRegistry`` whose fetch of the wave starting at client
    id ``first`` blocks while ``armed`` is set, until ``release`` is, or
    (``fail``) always raises."""

    def __init__(self, base, first: int, fail: bool = False):
        import threading

        self.base, self.first, self.fail = base, int(first), fail
        self.num_clients = base.num_clients
        self.armed, self.release = threading.Event(), threading.Event()

    def batch(self, ids):
        if int(ids[0]) == self.first:
            if self.fail:
                raise RuntimeError("registry shard down")
            if self.armed.is_set() and not self.release.wait(120):
                raise RuntimeError("the gate was never released")
        return self.base.batch(ids)


def phase_streamed_stale(device) -> dict:
    """``[streamed-stale]``: QFEDX_STALE=1 at n = 12 with a straggler
    wave that a gated registry holds past the deadline in round 1, on the
    card and the CPU; then a wave that fails for good under ring masks."""
    from qfedx_tpu_torch.data.stream import SyntheticRegistry
    from qfedx_tpu_torch.fed.client import draw_perms
    from qfedx_tpu_torch.fed.config import FedConfig
    from qfedx_tpu_torch.fed.round import (
        RoundDraws,
        make_fed_round,
        round_generator,
    )
    from qfedx_tpu_torch.fed.sampling import CohortSampler
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier

    n, layers, cohort, wave, batch, seed = 12, 3, 64, 16, 8, 0
    base = SyntheticRegistry(1 << 16, samples=8, n_features=n, seed=3)
    test = _registry_test_set(base, n)
    # SGD: θ itself is comparable card vs CPU (Adam's first step is a
    # sign, see _adam_card_vs_cpu).
    cfg = FedConfig(local_epochs=1, batch_size=batch, learning_rate=0.1)
    kw = dict(cohort_size=cohort, wave_size=wave, seed=seed, eval_every=4)
    last = CohortSampler(base.num_clients, cohort, seed).round_ids(1)[
        cohort - wave]
    out = {"launches": dict(NO_LAUNCH)}
    runs = {}
    with env_pins(QFEDX_STALE="1"):
        for dev in (device, "cpu"):
            reg = _GatedRegistry(base, last)

            def hook(r, m, reg=reg):
                if r == 0:
                    reg.armed.set()  # round 1's last wave misses its deadline
                elif r == 1:
                    reg.armed.clear()
                    reg.release.set()  # ... and arrives once round 1 ends

            res, rows, launches = _streamed(
                make_vqc_classifier(n, layers, 2, device=dev), cfg, reg,
                test, dev, 3, hook=hook, wave_deadline_s=STREAM_DEADLINE_S,
                stale_poll_s=60.0, **kw)
            _finite(f"streamed-stale on {dev}", res.params, rows)
            runs[str(dev)] = (res.params, rows, launches)
    theta, rows, launches = runs[str(device)]
    late = [r["late_waves"] for r in rows]
    applied = [r["stale_partials_applied"] for r in rows]
    err = max(_max_err(_theta(theta), _theta(runs["cpu"][0])), *(
        abs(a["loss"] - b["loss"]) for a, b in zip(rows, runs["cpu"][1])))
    print(f"[streamed-stale] n={n}, cohort {cohort} in waves of {wave}, "
          f"SGD, deadline {STREAM_DEADLINE_S} s: late_waves {late}, "
          f"stale_partials_applied {applied}, participants "
          f"{[r['participants'] for r in rows]}, launches {launches}; theta "
          f"and loss max|card-cpu| {err:.3e} (atol {TRAINED_LOGIT_ATOL:g}); "
          f"round walls {[r['time_s'] for r in rows]} s")
    if late != [0, 1, 0] or applied != [0, 0, 1]:
        raise AssertionError(f"streamed-stale ledger: late {late}, applied "
                             f"{applied}")
    if [r[k] for r in runs["cpu"][1] for k in ("late_waves",
                                               "stale_partials_applied")] != [
            v for pair in zip(late, applied) for v in pair]:
        raise AssertionError("streamed-stale: the CPU run's ledger differs")
    _require(err, TRAINED_LOGIT_ATOL, "streamed-stale, card vs cpu")
    # 4 waves, 3 fresh, then 4 fresh and the straggler; A in the one
    # evaluation, after the last round.
    waves = cohort // wave
    want = {"fwd": 1, "fwd_bnd": 3 * waves, "adj": 3 * waves}
    if launches != want:
        raise AssertionError(f"streamed-stale launched {launches}, expected "
                             f"{want}")
    out["launches"] = {k: out["launches"][k] + launches[k] for k in launches}

    # A wave that fails for good under ring masks, stale off: dropped,
    # its clients' masks added back by the server.
    masked = FedConfig(local_epochs=1, batch_size=batch, learning_rate=0.1,
                       secure_agg=True)
    ids0 = CohortSampler(base.num_clients, cohort, seed).round_ids(0)
    dead_wave = 1
    reg = _GatedRegistry(base, ids0[dead_wave * wave], fail=True)
    model = make_vqc_classifier(n, layers, 2, device=device)
    res, rows, launches = _streamed(model, masked, reg, test, device, 1,
                                    **{**kw, "eval_every": 2})
    survivors = np.ones(cohort, np.float32)
    survivors[dead_wave * wave:(dead_wave + 1) * wave] = 0.0
    data = [torch.as_tensor(a, device=device) for a in base.batch(ids0)]
    plain = FedConfig(local_epochs=1, batch_size=batch, learning_rate=0.1)
    want_theta, want_stats = make_fed_round(model, plain, num_clients=cohort)(
        model.init(seed), *data,
        perms=draw_perms(round_generator(seed, 0), cohort, 1,
                         base.samples),
        survivors=survivors, draws=RoundDraws(seed, 0))
    mask_err = _max_err(_theta(res.params), _theta(want_theta))
    row = rows[0]
    print(f"[streamed-stale] a failing wave under ring masks: "
          f"dropped_waves {row.get('dropped_waves')}, dropped_clients "
          f"{row['dropped_clients']}, participants {row['participants']} "
          f"(survivor round {float(want_stats.num_participants)!r}); theta "
          f"vs the survivor round without masks {mask_err:.3e} (atol "
          f"{MASK_ATOL:g}); launches {launches}")
    if row.get("dropped_waves") != 1 or row["dropped_clients"] != wave or (
            row["participants"] != int(want_stats.num_participants)):
        raise AssertionError(f"streamed-stale dead wave row {row}")
    _require(mask_err, MASK_ATOL, "dead wave under masks vs survivor round")
    out["launches"] = {k: out["launches"][k] + launches[k] for k in launches}
    out.update(theta_err=err, mask_err=mask_err, walls=[r["time_s"]
                                                         for r in rows])
    return out


CHAOS_RATE = 0.20  # [chaos]: bench.py's fault_tolerance row, highest rate
# [chaos-kernel]: the cohort positions of the planned drop, NaN, Inf,
# scale:100 and label_flip clients (NaN and Inf share a wave), in the
# 256-client run and in its one-wave card/CPU twin.
CHAOS_POSITIONS = {256: (3, 37, 38, 70, 101), 32: (3, 17, 18, 25, 30)}
CHAOS_CLIP = 5.0  # clip_mean's bound: above an honest Adam step's norm
# [chaos-kernel]'s SGD twin: between an honest SGD upload's norm (below
# 0.1 there) and its scale:100 client's (above 1).
CHAOS_SGD_CLIP = 0.3
ISOLATION_ATOL = 1e-6  # a wave's Δ sums, NaN client vs the client dropped
STRAGGLER_DEADLINE_S = 0.05  # bench.py's _bench_straggler deadline


def counting_plan(seed: int, rules: list):
    """A ``FaultPlan`` whose ``check`` counts, per site in ``.fired``, the
    ``FaultInjected`` it raises (what the reference's faults.injected.*
    counters would show)."""
    from qfedx_tpu_torch.utils.faults import FaultInjected, FaultPlan

    class CountingPlan(FaultPlan):
        def check(self, site, round_idx, wave=0, attempt=0):
            try:
                super().check(site, round_idx, wave, attempt)
            except FaultInjected:
                self.fired[site] = self.fired.get(site, 0) + 1
                raise

    plan = CountingPlan(seed=seed, rules=rules)
    plan.fired = {}
    return plan


def _chaos_ledger(tag: str, rows, plan, ids_of, cohort: int,
                  clip: bool = False) -> list:
    """Each row's casualty ledger against the plan's own draws: dropped
    = the plan's drops, rejected = its NaN/Inf clients that survive,
    participants = the rest (and under clip_mean, clipped = the
    surviving scale attackers). Returns the expected rows."""
    out = []
    for r, row in enumerate(rows):
        ids = ids_of(r)
        alive = plan.survivors(r, ids) == 1.0
        bad = ~np.isfinite(plan.poison(r, ids))
        want = {"dropped_clients": int((~alive).sum()),
                "rejected_updates": int((alive & bad).sum()),
                "participants": int((alive & ~bad).sum())}
        if clip:
            want["clipped_clients"] = int(
                (alive & ~bad & (plan.byzantine_multipliers(r, ids) != 1.0)
                 ).sum())
        got = {k: row.get(k) for k in want}
        if got != want or want["dropped_clients"] + want[
                "rejected_updates"] + want["participants"] != cohort:
            raise AssertionError(f"{tag} round {r}: ledger {got}, the plan's "
                                 f"{want}")
        out.append(want)
    return out


def _theta_finite(what: str, params, rows) -> None:
    if not all(math.isfinite(r["loss"]) for r in rows) or not all(
            bool(torch.isfinite(t).all()) for t in trees_leaves(params)):
        raise AssertionError(f"{what}: θ or a loss went non-finite")


def phase_chaos(device) -> dict:
    """``[chaos]``: bench.py's fault_tolerance row (``_bench_fault_
    tolerance``) at its 20% point on the card: a 2^18-client registry,
    cohort 128 in waves of 64, n = 8, L = 3, Adam, ring masks, rate/2
    drops and rate/2 NaN clients per round, 3 rounds; then its first
    round on the card and the CPU."""
    from qfedx_tpu_torch.data.stream import SyntheticRegistry
    from qfedx_tpu_torch.fed.config import FedConfig
    from qfedx_tpu_torch.fed.sampling import CohortSampler
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.utils.faults import FaultPlan

    n, layers, cohort, wave, rounds, seed = 8, 3, 128, 64, 3, 6
    registry = SyntheticRegistry(1 << 18, samples=8, n_features=n, seed=2)
    test = _registry_test_set(registry, n, 32)
    cfg = FedConfig(local_epochs=1, batch_size=8, learning_rate=0.1,
                    optimizer="adam", secure_agg=True, secure_agg_mode="ring")
    plan = FaultPlan(seed=11, rules=[
        {"site": "client.compute", "kind": "drop", "rate": CHAOS_RATE / 2},
        {"site": "client.compute", "kind": "nan", "rate": CHAOS_RATE / 2},
    ])
    sampler = CohortSampler(registry.num_clients, cohort, seed)
    kw = dict(cohort_size=cohort, wave_size=wave, seed=seed, fault_plan=plan)

    def model(dev):
        return make_vqc_classifier(n, layers, 2, device=dev)

    res, rows, launches = _streamed(model(device), cfg, registry, test,
                                    device, rounds, eval_every=rounds, **kw)
    _theta_finite("chaos", res.params, rows)
    want = _chaos_ledger("chaos", rows, plan, sampler.round_ids, cohort)
    walls = [r["time_s"] for r in rows]
    rate = cohort / float(np.median(walls[1:]))
    print(f"[chaos] registry 2^18, cohort {cohort} in {cohort // wave} waves "
          f"of {wave}, n={n} L={layers}, Adam, ring masks, plan: "
          f"{CHAOS_RATE / 2:g} drop + {CHAOS_RATE / 2:g} nan per client: "
          f"{rounds} rounds, walls {walls} s (host clock), {rate:.4f} "
          f"client-rounds/s (cohort / median round after the first); "
          f"ledger {[{k: r[k] for k in w} for r, w in zip(rows, want)]} "
          f"= the plan's; final accuracy {rows[-1].get('accuracy')!r}; "
          f"launches {launches}")
    if launches != NO_LAUNCH:
        raise AssertionError(f"chaos n=8 launched {launches}")
    one = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        r1, rows1, _ = _streamed(model(dev), cfg, registry, test, dev, 1,
                                 eval_every=2, **kw)
        one[str(dev)] = (r1.params, rows1[0], time.perf_counter() - t0)
    (card, card_row, card_s), (cpu, cpu_row, cpu_s) = (one[str(device)],
                                                       one["cpu"])
    err, theta_err = _adam_card_vs_cpu(model, card, cpu, test)
    err = max(err, abs(card_row["loss"] - cpu_row["loss"]))
    same = all(card_row[k] == cpu_row[k] for k in want[0])
    print(f"[chaos] round 0 card vs cpu ({card_s:.2f} s and {cpu_s:.2f} s): "
          f"logits and loss max|card-cpu| {err:.3e} (atol "
          f"{TRAINED_LOGIT_ATOL:g}), theta {theta_err:.3e} (Adam's ±lr steps"
          f" on zero-gradient angles, not gated); ledgers equal: {same}")
    _require(err, TRAINED_LOGIT_ATOL, "chaos round, card vs cpu")
    if not same:
        raise AssertionError(f"chaos ledger card {card_row} vs cpu {cpu_row}")
    return {"launches": launches, "rate": rate, "walls": walls,
            "logit_err": err, "ledger": want}


def chaos_kernel_plan(sampler, rounds: int, cohort: int,
                      attacker: bool = True):
    """[chaos-kernel]'s plan: at CHAOS_POSITIONS[cohort] of each round's
    cohort one drop, one NaN, one Inf, one scale:100 (unless not
    ``attacker``) and one label_flip client; round 0's wave 1 fetch and
    round 1's wave 0 copy fail once."""
    ids = [sampler.round_ids(r) for r in range(rounds)]
    kinds = (("client.compute", "drop"), ("client.compute", "nan"),
             ("client.compute", "inf"), ("client.byzantine", "scale:100"),
             ("client.byzantine", "label_flip"))
    rules = [{"site": site, "kind": kind,
              "clients": sorted({int(i[p]) for i in ids})}
             for (site, kind), p in zip(kinds, CHAOS_POSITIONS[cohort])
             if attacker or kind != "scale:100"]
    rules += [{"site": "registry.fetch", "rounds": [0], "waves": [1],
               "times": 1},
              {"site": "ingest.h2d", "rounds": [1], "waves": [0],
               "times": 1}]
    return counting_plan(seed=13, rules=rules)


def phase_chaos_kernel(device) -> dict:
    """``[chaos-kernel]``: the n = 12, L = 3 VQC streamed in waves of 32
    (cohort 256, batch 8, Adam, clip_mean) under chaos_kernel_plan for 3
    rounds: one B and one C per wave per local step, the NaN and Inf
    clients' rows beside 31 healthy ones in their wave; then one round of
    a 32-client cohort on the card and the CPU: under SGD (clip bound
    CHAOS_SGD_CLIP) with the whole plan, θ, logits and loss gated; under
    Adam without the plan's scale:100 client, the logits and loss gated;
    and under Adam with the whole plan, printed only. Under Adam that
    client's clip_mean factor is 5 over its upload's norm, and the upload
    carries ×100 the ±lr steps Adam takes on each device's rounding noise
    at the zero-gradient angles, so the factor, and through it every leaf
    of θ, differs card vs CPU (``tests/test_torch_chaos.py`` shows it
    between the packages)."""
    from qfedx_tpu_torch.data.stream import SyntheticRegistry
    from qfedx_tpu_torch.fed.config import FedConfig
    from qfedx_tpu_torch.fed.sampling import CohortSampler
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier

    n, layers, cohort, wave, batch, rounds, seed = 12, 3, 256, 32, 8, 3, 0
    registry = SyntheticRegistry(1 << 16, samples=8, n_features=n, seed=2)
    test = _registry_test_set(registry, n)
    cfg = FedConfig(local_epochs=1, batch_size=batch, learning_rate=0.1,
                    optimizer="adam", aggregator="clip_mean",
                    clip_bound=CHAOS_CLIP)
    sampler = CohortSampler(registry.num_clients, cohort, seed)
    plan = chaos_kernel_plan(sampler, rounds, cohort)
    waves, steps = cohort // wave, registry.samples // batch
    log = []
    res, rows, launches = _streamed(
        make_vqc_classifier(n, layers, 2, device=device), cfg, registry,
        test, device, rounds, launch_log=log, cohort_size=cohort,
        wave_size=wave, seed=seed, eval_every=1, fault_plan=plan)
    _theta_finite("chaos-kernel", res.params, rows)
    want = _chaos_ledger("chaos-kernel", rows, plan, sampler.round_ids,
                         cohort, clip=True)
    prev = {"fwd": 0, "fwd_bnd": 0, "adj": 0}
    for r, (counts, _) in enumerate(log):
        per = {k: counts[k] - prev[k] for k in prev}
        prev = counts
        expect = {"fwd": 2 if r == 0 else 1, "fwd_bnd": waves * steps,
                  "adj": waves * steps}
        print(f"[chaos-kernel] round {r}: wall {rows[r]['time_s']!r} s (host "
              f"clock), launches {per} (expected {expect}), ledger "
              f"{want[r]} = the plan's, loss {rows[r]['loss']!r}")
        if per != expect:
            raise AssertionError(f"chaos-kernel round {r} launched {per}")
    if plan.fired != {"registry.fetch": 1, "ingest.h2d": 1}:
        raise AssertionError(f"chaos-kernel injected errors {plan.fired}")
    if log[-1][1] != log[0][1]:
        raise AssertionError("the kernel library was built after round 1")
    walls = [r["time_s"] for r in rows]
    rate = cohort / float(np.median(walls[1:]))
    twin = CohortSampler(registry.num_clients, wave, seed)

    sgd = FedConfig(local_epochs=1, batch_size=batch, learning_rate=0.1,
                    aggregator="clip_mean", clip_bound=CHAOS_SGD_CLIP)

    def twin_round(twin_cfg, attacker: bool = True
                   ) -> tuple[float, float, list]:
        """One round of the twin cohort on the card and the CPU: the
        logits/loss error, θ's, and the card and CPU walls."""
        one = {}
        for dev in (device, "cpu"):
            t0 = time.perf_counter()
            twin_plan = chaos_kernel_plan(twin, 1, wave, attacker=attacker)
            r1, rows1, _ = _streamed(
                make_vqc_classifier(n, layers, 2, device=dev), twin_cfg,
                registry, test, dev, 1, cohort_size=wave, wave_size=wave,
                seed=seed, eval_every=2, fault_plan=twin_plan)
            _chaos_ledger(f"chaos-kernel twin on {dev}", rows1, twin_plan,
                          twin.round_ids, wave, clip=True)
            one[str(dev)] = (r1.params, rows1[0]["loss"],
                             time.perf_counter() - t0)
        (card, card_loss, card_s), (cpu, cpu_loss, cpu_s) = (
            one[str(device)], one["cpu"])
        logit_err, theta_err = _adam_card_vs_cpu(
            lambda dev: make_vqc_classifier(n, layers, 2, device=dev), card,
            cpu, test)
        return (max(logit_err, abs(card_loss - cpu_loss)), theta_err,
                [card_s, cpu_s])

    sgd_err, sgd_theta_err, sgd_walls = twin_round(sgd)
    err, theta_err, walls_s = twin_round(cfg, attacker=False)
    attacked_err, _, _ = twin_round(cfg)
    print(f"[chaos-kernel] {rate:.4f} client-rounds/s after round 0; "
          f"injected errors {plan.fired} (each recovered by the retry); one "
          f"round of a cohort of {wave} card vs cpu: SGD (clip bound "
          f"{CHAOS_SGD_CLIP:g}) under the whole plan ({sgd_walls[0]:.2f} s "
          f"and {sgd_walls[1]:.2f} s) theta max|card-cpu| "
          f"{sgd_theta_err:.3e}, logits and loss {sgd_err:.3e} (atol "
          f"{TRAINED_LOGIT_ATOL:g}); Adam under the plan without its "
          f"scale:100 client ({walls_s[0]:.2f} s and {walls_s[1]:.2f} s) "
          f"logits and loss {err:.3e} (atol {TRAINED_LOGIT_ATOL:g}), theta "
          f"{theta_err:.3e} (Adam's ±lr steps on zero-gradient angles, not "
          f"gated); Adam under the whole plan {attacked_err:.3e} (printed, "
          "not gated: the attacker's clip factor carries ×100 those steps)")
    _require(max(sgd_err, sgd_theta_err), TRAINED_LOGIT_ATOL,
             "chaos-kernel SGD round, card vs cpu")
    _require(err, TRAINED_LOGIT_ATOL, "chaos-kernel round, card vs cpu")
    return {"launches": launches, "rate": rate, "walls": walls,
            "logit_err": err, "sgd_theta_err": sgd_theta_err,
            "ledger": want}


def _rows_of(t: torch.Tensor, tb: int) -> torch.Tensor:
    """A packed (…, tb, R, 128) tensor as (tb, everything else)."""
    return t.float().movedim(-3, 0).reshape(tb, -1)


def hold_poisoned_rows(tag: str, device, dtype) -> dict:
    """Launches A, B and C on a wave's own program (32 clients × 8, G =
    32) whose client 13 has NaN features, against the plain sweep: the
    poisoned client's rows stay non-finite in both, every other row is
    finite and agrees (f32 within KERNEL_ATOL; bf16 by relative norm
    within BF16_RTOL) — no tile or reduction spans two samples."""
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.ops import scan_body

    n, layers, wave, batch, bad = 12, 3, 32, 8, 13
    _, leaves, xb, _ = _client_batch(n, layers, 2, wave, batch, device,
                                     seed=950)
    xb[bad] = float("nan")
    model = make_vqc_classifier(n, layers, 2, device=device)
    packed, spec, xs = captured_program(
        lambda: model.apply_clients(leaves, xb), n)
    tb = spec.tb
    bad_rows = ~torch.isfinite(_rows_of(packed, tb)).all(1)
    if int(bad_rows.sum()) != batch or not bool(
            bad_rows[bad * batch:(bad + 1) * batch].all()):
        raise AssertionError(f"{tag}: poisoned rows {bad_rows.nonzero()}")
    cot = random_state(n, tb, device, seed=951, dtype=packed.dtype)
    cot = torch.stack([cot.re, cot.im]).reshape(packed.shape).clone()
    cot[:, bad * batch:(bad + 1) * batch] = float("nan")
    aspec = scan_body._adjoint_spec(spec)
    axs = scan_body._adjoint_xs(spec, xs)
    with torch.no_grad():
        outs = {
            "A": ([scan_body.scan_body(packed, spec, xs)],
                  [scan_body.scan_body_plain(packed, spec, xs)]),
            "B": (scan_body.scan_body(packed, spec, xs, with_boundaries=True),
                  scan_body.scan_body_plain(packed, spec, xs, True)),
            "C": (scan_body.scan_body(cot, aspec, axs, with_boundaries=True,
                                      adjoint=True),
                  scan_body.scan_body_plain(cot, aspec, axs, True)),
        }
        torch.cuda.synchronize()
    errs = {}
    for launch, (got, want) in outs.items():
        g = [_rows_of(t, tb) for t in got]
        w = [_rows_of(t, tb) for t in want]
        for gi, wi in zip(g, w):
            healthy_ok = bool(torch.isfinite(gi[~bad_rows]).all()) and bool(
                torch.isfinite(wi[~bad_rows]).all())
            poisoned = (not bool(torch.isfinite(gi[bad_rows]).any())
                        and not bool(torch.isfinite(wi[bad_rows]).any()))
            if not (healthy_ok and poisoned):
                raise AssertionError(
                    f"{tag} Launch {launch}: a healthy row went non-finite "
                    f"({not healthy_ok}) or a poisoned row finite "
                    f"({not poisoned})")
        hg, hw = [t[~bad_rows] for t in g], [t[~bad_rows] for t in w]
        errs[launch] = (_rel_err(hg, hw) if _is_bf16(dtype)
                        else _max_err(hg, hw))
    atol = BF16_RTOL if _is_bf16(dtype) else KERNEL_ATOL
    what = "relative norm" if _is_bf16(dtype) else "max|kernel-plain|"
    print(f"[{tag}] a wave's program ({config_text(spec)}) with client "
          f"{bad}'s {batch} rows NaN: those rows non-finite in kernel and "
          f"plain, the other {tb - batch} finite; {what} on them: A "
          f"{errs['A']:.3e}, B {errs['B']:.3e}, C {errs['C']:.3e} (bound "
          f"{atol:g})")
    for launch, e in errs.items():
        _require(e, atol, f"{tag} Launch {launch} on the healthy rows")
    return errs


def phase_chaos_isolation(device, dtype=torch.float32) -> dict:
    """The isolation check: one wave's partial (n = 12, L = 3, 32 clients
    × 8 samples, SGD, no masks) with client 13's features NaN, against the
    same wave with client 13 dropped instead; then the kernel's rows."""
    from qfedx_tpu_torch.data.stream import SyntheticRegistry
    from qfedx_tpu_torch.fed.client import draw_perms
    from qfedx_tpu_torch.fed.config import FedConfig
    from qfedx_tpu_torch.fed.round import (
        RoundDraws,
        make_fed_round_partial,
        round_generator,
    )
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.ops import scan_body

    tag = "bf16-chaos-isolation" if _is_bf16(dtype) else "chaos-isolation"
    n, layers, wave, samples, bad = 12, 3, 32, 8, 13
    registry = SyntheticRegistry(1 << 16, samples=samples, n_features=n,
                                 seed=4)
    cx, cy, cm = registry.batch(np.arange(1000, 1000 + wave))
    poisoned = cx.copy()
    poisoned[bad] = np.nan
    cfg = FedConfig(local_epochs=1, batch_size=samples, learning_rate=0.1)
    model = make_vqc_classifier(n, layers, 2, device=device)
    params = model.init(0)
    pf = make_fed_round_partial(model, cfg, wave, wave)
    perms = draw_perms(round_generator(0, 0), wave, 1, samples)
    survivors = np.ones(wave, np.float32)
    survivors[bad] = 0.0

    def run(x, **kw):
        scan_body.reset_counts()
        with (bf16_pin() if _is_bf16(dtype) else contextlib.nullcontext()):
            part = pf(params, *(torch.as_tensor(a, device=device)
                                for a in (x, cy, cm)), 0, perms=perms,
                      draws=RoundDraws(0, 0), **kw)
        torch.cuda.synchronize()
        return part, dict(scan_body.launch_counts), dict(
            scan_body.dtype_counts)

    nan_part, nan_launches, nan_dtypes = run(poisoned)
    drop_part, drop_launches, _ = run(cx, survivors=survivors)
    delta = _max_err(trees_leaves(nan_part.update_sum),
                     trees_leaves(drop_part.update_sum))
    sums = {f: (float(getattr(nan_part, f)), float(getattr(drop_part, f)))
            for f in ("weight_sum", "loss_sum", "num_participants",
                      "rejected_updates", "dropped_clients",
                      "clipped_clients")}
    finite = all(bool(torch.isfinite(t).all())
                 for t in trees_leaves(nan_part.update_sum))
    print(f"[{tag}] a wave of {wave} clients x {samples} at n={n} L={layers}"
          f", client {bad} NaN vs the same client dropped: Δ sums "
          f"max|nan-dropped| {delta:.3e} (atol {ISOLATION_ATOL:g}), finite "
          f"{finite}; (nan, dropped) {sums}; launches {nan_launches} and "
          f"{drop_launches} ({nan_dtypes})")
    if not finite:
        raise AssertionError(f"{tag}: the NaN client reached the Δ sums")
    _require(delta, ISOLATION_ATOL, f"{tag} Δ sums")
    for f, (a, b) in sums.items():
        expect = {"rejected_updates": (1.0, 0.0),
                  "dropped_clients": (0.0, 1.0)}.get(f)
        ok = (a, b) == expect if expect else abs(a - b) <= ISOLATION_ATOL
        if not ok:
            raise AssertionError(f"{tag}: {f} (nan, dropped) = {(a, b)}")
    if nan_launches != STEP_BC or drop_launches != STEP_BC:
        raise AssertionError(f"{tag} launched {nan_launches}, "
                             f"{drop_launches}")
    with (bf16_pin() if _is_bf16(dtype) else contextlib.nullcontext()):
        rows = hold_poisoned_rows(tag, device, dtype)
    launches = {k: nan_launches[k] + drop_launches[k] for k in nan_launches}
    return {"launches": launches, "delta": delta, "rows": rows}


def phase_chaos_straggler(device) -> dict:
    """``[chaos-straggler]``: QFEDX_STALE at n = 12, cohort 64 in waves of
    32, SGD, a ``wave.delay`` of 0.5 s declared on round 0's wave 1 with
    the consumer's deadline at 0.05 s: late in round 0, folded in at age
    1 in round 1, on the card and the CPU."""
    from qfedx_tpu_torch.data.stream import SyntheticRegistry
    from qfedx_tpu_torch.fed.config import FedConfig
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.utils.faults import FaultPlan

    n, layers, cohort, wave, samples, seed = 12, 3, 64, 32, 2, 0
    registry = SyntheticRegistry(1 << 16, samples=samples, n_features=n,
                                 seed=5)
    test = _registry_test_set(registry, n)
    cfg = FedConfig(local_epochs=1, batch_size=samples, learning_rate=0.1)
    plan = FaultPlan(seed=23, rules=[
        {"site": "wave.delay", "kind": "delay:0.5", "rounds": [0],
         "waves": [1]}])
    runs = {}
    with env_pins(QFEDX_STALE="1"):
        for dev in (device, "cpu"):
            t0 = time.perf_counter()
            res, rows, launches = _streamed(
                make_vqc_classifier(n, layers, 2, device=dev), cfg, registry,
                test, dev, 2, cohort_size=cohort, wave_size=wave, seed=seed,
                eval_every=3, fault_plan=plan,
                wave_deadline_s=STRAGGLER_DEADLINE_S, stale_poll_s=60.0)
            _theta_finite(f"chaos-straggler on {dev}", res.params, rows)
            runs[str(dev)] = (res.params, rows, launches,
                              time.perf_counter() - t0)
    theta, rows, launches, card_s = runs[str(device)]
    cpu_theta, cpu_rows, _, cpu_s = runs["cpu"]
    ledger = [(r["late_waves"], r["stale_partials_applied"],
               r["participants"]) for r in rows]
    err = max(_max_err(_theta(theta), _theta(cpu_theta)), *(
        abs(a["loss"] - b["loss"]) for a, b in zip(rows, cpu_rows)))
    print(f"[chaos-straggler] n={n}, cohort {cohort} in waves of {wave}, "
          f"SGD, delay:0.5 on round 0 wave 1, deadline "
          f"{STRAGGLER_DEADLINE_S} s: (late_waves, stale_partials_applied, "
          f"participants) {ledger}, round walls {[r['time_s'] for r in rows]}"
          f" s (card run {card_s:.2f} s, cpu {cpu_s:.2f} s); theta and loss "
          f"max|card-cpu| {err:.3e} (atol {TRAINED_LOGIT_ATOL:g}); launches "
          f"{launches}")
    if ledger != [(1, 0, wave), (0, 1, cohort + wave)] or ledger != [
            (r["late_waves"], r["stale_partials_applied"], r["participants"])
            for r in cpu_rows]:
        raise AssertionError(f"chaos-straggler ledger {ledger}")
    _require(err, TRAINED_LOGIT_ATOL, "chaos-straggler, card vs cpu")
    want = {"fwd": 1, "fwd_bnd": 4, "adj": 4}  # 1 + 2 fresh + 1 stale
    if launches != want:
        raise AssertionError(f"chaos-straggler launched {launches}")
    return {"launches": launches, "theta_err": err}


def phase_chaos_serve(device, served: dict) -> dict:
    """``[chaos-serve]``: [serve]'s 256 requests on the same weights and
    buckets through an engine whose plan corrupts requests at rate 0.1
    (0.05 ``nan`` + 0.05 ``malformed``) and fails batch 2's compute once."""
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.serve import (
        MicroBatcher,
        RequestError,
        ServeConfig,
        ServeEngine,
    )

    clean = served["engine"]
    plan = counting_plan(seed=29, rules=[
        {"site": "serve.request", "kind": "nan", "rate": 0.05},
        {"site": "serve.request", "kind": "malformed", "rate": 0.05},
        {"site": "serve.compute", "rounds": [2], "times": 1}])
    engine = ServeEngine(
        clean.model, clean.params, (N_QUBITS,),
        config=ServeConfig(buckets=BUCKETS, deadline_ms=2.0, max_queue=512),
        fault_plan=plan)
    warm = engine.warmup()
    builds = scan_body.build_count
    x = np.random.default_rng(11).uniform(0, 1, (N_REQUESTS, N_QUBITS))
    x = x.astype(np.float32)
    planned = [s for s in range(N_REQUESTS)
               if plan.request_mutation(s) is not None]
    scan_body.reset_counts()
    batcher = MicroBatcher(engine).start()
    futures, rejected = {}, []
    for lo, hi in ((0, 1), (1, 6), (6, N_REQUESTS)):
        wave = {}
        for i in range(lo, hi):
            try:
                wave[i] = batcher.submit(x[i])
            except RequestError:
                rejected.append(i)
        for f in wave.values():
            f.result(timeout=60)
        futures.update(wave)
    batcher.close(drain=True)
    launches = scan_body.launch_count
    logits = np.stack([futures[i].result()["logits"] for i in sorted(futures)])
    err = float(np.abs(logits - served["logits"][sorted(futures)]).max())
    lat_ms = np.array([(f.done_t - f.submit_t) * 1e3
                       for f in futures.values()])
    p50, p95 = (float(np.percentile(lat_ms, q)) for q in (50, 95))
    print(f"[chaos-serve] {N_REQUESTS} requests, planned corruptions "
          f"{len(planned)} at seqs {planned}, rejected {rejected}, "
          f"stats {batcher.stats}, compute faults injected {plan.fired} "
          f"(retried), kernel launches {launches}, builds after warmup "
          f"{scan_body.build_count - builds} (warmup built "
          f"{warm['kernel_builds']}); served logits max|chaos-clean| "
          f"{err:.3e} (atol {LOGIT_ATOL:g}); latency p50={p50:.4f} ms "
          f"p95={p95:.4f} ms")
    if rejected != planned or batcher.stats["rejected"] != len(planned):
        raise AssertionError(f"chaos-serve rejected {rejected}, planned "
                             f"{planned}")
    if plan.fired != {"serve.compute": 1}:
        raise AssertionError(f"chaos-serve compute faults {plan.fired}")
    if scan_body.build_count != builds or warm["kernel_builds"]:
        raise AssertionError("chaos-serve built the kernel after warmup")
    if launches < batcher.stats["batches"]:
        raise AssertionError(f"chaos-serve: {launches} launches for "
                             f"{batcher.stats['batches']} batches")
    _require(err, LOGIT_ATOL, "chaos-serve logits vs the clean engine")
    return {"launches": launches, "p50": p50, "p95": p95,
            "rejected": len(rejected), "logit_err": err}


def phase_chaos_checkpoint(device) -> dict:
    """``[chaos-checkpoint]`` and ``[sigterm]``: the n = 12 streamed run
    (cohort 64 in waves of 32, SGD) for 3 rounds with a checkpoint every
    round, round 2's async write failing once; then the same run with a
    SIGTERM raised when round 1 ends, and its resume."""
    import signal

    from qfedx_tpu_torch.data.stream import SyntheticRegistry
    from qfedx_tpu_torch.fed.config import FedConfig
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.run.checkpoint import Checkpointer

    n, layers, cohort, wave, rounds = 12, 3, 64, 32, 3
    registry = SyntheticRegistry(1 << 16, samples=8, n_features=n, seed=6)
    test = _registry_test_set(registry, n)
    cfg = FedConfig(local_epochs=1, batch_size=8, learning_rate=0.1)
    kw = dict(cohort_size=cohort, wave_size=wave, seed=0,
              eval_every=rounds)
    plan = counting_plan(seed=0, rules=[
        {"site": "checkpoint.write", "rounds": [2], "times": 1}])
    root = Path(tempfile.mkdtemp(prefix="qfedx-chaos-ck-"))
    launches = dict(NO_LAUNCH)

    def add(counts):
        for k in launches:
            launches[k] += counts[k]

    def model():
        return make_vqc_classifier(n, layers, 2, device=device)

    try:
        ck = Checkpointer(root / "straight", every=1, fault_plan=plan)
        straight, _, counts = _streamed(model(), cfg, registry, test, device,
                                        rounds, checkpointer=ck, **kw)
        add(counts)
        saved = sorted(ck._rounds())
        for r in saved:
            ck.verify(r)
        print(f"[chaos-checkpoint] 3 rounds, a checkpoint each (async "
              f"writes, the last synchronous), round 2's write failed "
              f"{plan.fired.get('checkpoint.write', 0)} time(s) and was "
              f"retried: checkpoints {saved}, each sha256 verified")
        if saved != [1, 2, 3] or plan.fired != {"checkpoint.write": 1}:
            raise AssertionError(f"chaos-checkpoint saved {saved}, faults "
                                 f"{plan.fired}")
        before = signal.getsignal(signal.SIGTERM)

        def term(r, m):
            if r == 1:
                signal.raise_signal(signal.SIGTERM)

        t0 = time.perf_counter()
        try:
            _streamed(model(), cfg, registry, test, device, rounds,
                      checkpointer=Checkpointer(root / "term", every=100),
                      hook=term, **kw)
        except KeyboardInterrupt as exc:
            stopped = f"KeyboardInterrupt({exc})"
            add(dict(scan_body.launch_counts))
        else:
            raise AssertionError("sigterm: the run went on after SIGTERM")
        stop_s = time.perf_counter() - t0
        restored = signal.getsignal(signal.SIGTERM) is before
        left = Checkpointer(root / "term", every=100)._rounds()
        resumed, _, counts = _streamed(
            model(), cfg, registry, test, device, rounds,
            checkpointer=Checkpointer(root / "term", every=100), **kw)
        add(counts)
        err = _max_err(_theta(resumed.params), _theta(straight.params))
        print(f"[sigterm] SIGTERM from on_round_end after round 1: "
              f"{stopped} after {stop_s:.2f} s, checkpoints left {left}, "
              f"previous handler restored {restored}; the resumed run's "
              f"theta vs the uninterrupted run's {err:.3e} (atol "
              f"{ROUND_ATOL:g})")
        if left != [1] or not restored:
            raise AssertionError(f"sigterm left {left}, restored {restored}")
        _require(err, ROUND_ATOL, "sigterm resume vs the straight run")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches, "resume_err": err}


# --- observability (obs/) -----------------------------------------------------

OBS_THETA_ATOL = 1e-6  # traced vs untraced: the same card, the same inputs
OBS_LOGIT_ATOL = 1e-5  # [obs-serve] vs [cli-serve]: θ within OBS_THETA_ATOL


@contextlib.contextmanager
def capture_window(log: list):
    """Wrap ``obs.profile.capture`` so that the wrapper's launches made
    inside each profiled window are appended to ``log``."""
    from qfedx_tpu_torch.obs import profile
    from qfedx_tpu_torch.ops import scan_body

    orig = profile.capture

    class Counted(orig):
        def __enter__(self):
            out = super().__enter__()
            self._start = dict(scan_body.launch_counts)
            return out

        def __exit__(self, *exc):
            log.append({k: scan_body.launch_counts[k] - self._start[k]
                        for k in self._start})
            return super().__exit__(*exc)

    profile.capture = Counted
    try:
        yield
    finally:
        profile.capture = orig


def phase_obs_train(root, cli_run: dict) -> dict:
    """``[obs-train]``: [cli-train]'s argv with ``--trace --profile`` into
    its own run directory (see the module docstring)."""
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.obs import merge, profile
    from qfedx_tpu_torch.run.checkpoint import Checkpointer

    name = "obs"
    argv = CLI_ARGV + ["--trace", "--profile", "--run-root", str(root),
                       "--name", name]
    window: list = []
    t0 = time.perf_counter()
    with env_pins(QFEDX_TRACE="0"), capture_window(window):
        summary, launches, rounds, _ = cli_train(argv, None)
    wall = time.perf_counter() - t0
    run = root / name
    rows = _rows(run)
    trace = json.loads((run / "trace.json").read_text())["traceEvents"]
    lane = [e for e in trace
            if e.get("pid") == merge.DEVICE_LANE_PID and e["ph"] == "X"]
    host = {e["name"] for e in trace if e["ph"] == "X"
            and e.get("pid") != merge.DEVICE_LANE_PID}
    psum = json.loads((run / "profile_summary.json").read_text())
    census = profile.kernel_launches(profile.load_capture(
        profile.find_capture(run / "profile")))
    shapes = cli_run["shapes"]
    steps = shapes["steps"]
    inside = window[0] if len(window) == 1 else None
    want_inside = {"fwd": _batches(shapes["n_val"]) * (1 + CLI_ROUNDS),
                   "fwd_bnd": CLI_ROUNDS * steps, "adj": CLI_ROUNDS * steps}
    template = make_vqc_classifier(N_QUBITS, N_LAYERS, 2,
                                   device="cpu").init(0)
    final = Checkpointer(run / "checkpoints").restore(CLI_ROUNDS, template)
    theta_err = _max_err([v for d in final.values() for v in d.values()],
                         cli_run["theta"])
    print(f"[obs-train] {' '.join(argv)}: {wall:.2f} s (host clock, "
          f"under the profiler); time_s per round "
          f"{[r['time_s'] for r in rows]} vs [cli-train]'s untraced "
          f"{cli_run['times']}; trace.json {len(host)} host span names, "
          f"{len(lane)} device-lane events; launches {launches} vs "
          f"[cli-train]'s {cli_run['launches']}; theta "
          f"max|traced-untraced| {theta_err:.3e} (atol {OBS_THETA_ATOL:g})")
    print(f"[obs-train] the profiler's scan-body kernel events by launch "
          f"kind {census}; the wrapper's launches inside the capture "
          f"{inside} (expected {want_inside}: {steps} B + {steps} C per "
          f"round, A = the round-0 and per-round evaluations; the final "
          f"evaluation runs after the capture)")
    print(f"[obs-train] device timeline of {CLI_ROUNDS} n={N_QUBITS} "
          f"rounds (under the profiler, whose per-kernel overhead inflates "
          f"the busy share): busy fraction {psum['device_busy_fraction']!r}"
          f" of a {psum['device_window_s']!r} s window, "
          f"{psum['ops_executed']} device ops ({psum['ops_distinct']} "
          f"distinct) on {psum['device_lanes']} lane(s), gaps p50 "
          f"{psum['gap_p50_us']!r} us p95 {psum['gap_p95_us']!r} us mean "
          f"{psum['gap_mean_us']!r} us")
    for row in psum["top_ops"][:8]:
        print(f"[obs-train] top device op: {row['count']} x "
              f"{row['op'][:90]} total {row['total_ms']!r} ms")
    breakdown = json.loads((run / "summary.json").read_text())[
        "phase_breakdown"]
    for span, row in sorted(breakdown.items(),
                            key=lambda kv: -kv[1]["total_s"]):
        if "device_busy_s" in row or span.startswith(("round.", "trainer.")):
            print(f"[obs-train] phase {span}: {row['count']} x, host "
                  f"{row['total_s']!r} s, device busy "
                  f"{row.get('device_busy_s')!r} s (utilization "
                  f"{row.get('utilization')!r})")
    if not lane:
        raise AssertionError("obs-train: trace.json has no device lane")
    if not {"round.dispatch", "round.fetch", "round.eval", "final.eval",
            "fed.trace.local_update", "engine.trace"} <= host:
        raise AssertionError(f"obs-train: span names {sorted(host)}")
    if launches != cli_run["launches"] or inside != want_inside:
        raise AssertionError(f"obs-train launched {launches} ({inside} "
                             "inside the capture)")
    if census != {**inside, "unattributed": 0,
                  "total": sum(inside.values())}:
        raise AssertionError(f"the profiler counted {census}, the wrapper "
                             f"{inside}")
    _require(theta_err, OBS_THETA_ATOL, "obs-train theta, traced vs not")
    return {"run": run, "launches": launches, "census": census,
            "summary": psum, "theta_err": theta_err}


def _scrape(url: str) -> tuple[int, str]:
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def phase_obs_serve(root, run_dir, cli_served: dict) -> dict:
    """``[obs-serve]``: [cli-serve]'s requests through ``serve --trace``
    with /metrics, the watchdog and the flight recorder on, under a
    profiler capture (see the module docstring)."""
    import socket
    import threading

    from qfedx_tpu_torch import obs
    from qfedx_tpu_torch.obs import flight, profile, server, watch
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.run import cli

    x = np.random.default_rng(17).uniform(0, 1, (N_SERVE_REQUESTS, N_QUBITS))
    x = x.astype(np.float32)
    lines = [json.dumps({"id": f"q{i}", "features": v.tolist()})
             for i, v in enumerate(x)]
    lines.insert(10, "{malformed")
    first = N_SERVE_REQUESTS // 2  # valid requests before the scrape
    fifo = root / "obs-requests.fifo"
    os.mkfifo(fifo)
    out = root / "obs-responses.jsonl"
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    mid: dict = {}
    recorded: list = []

    class Recording(obs.Histogram):
        __slots__ = ()

        def record(self, value):
            recorded.append(float(value))
            super().record(value)

    def feed():
        try:
            # The CLI opens its input after the warmup.
            with open(fifo, "w") as f:
                mid["fwd0"] = scan_body.launch_counts["fwd"]
                mid["builds0"] = scan_body.build_count
                f.write("\n".join(lines[:first + 1]) + "\n")
                f.flush()
                deadline = time.monotonic() + 120
                while obs.registry().counters.get(
                        "serve.requests_served", 0) < first:
                    if time.monotonic() > deadline:
                        raise TimeoutError("first half never served")
                    time.sleep(0.002)
                mid["launched"] = scan_body.launch_counts["fwd"] - mid["fwd0"]
                code, body = _scrape(base + "/metrics")
                mid["metrics"] = (code, [ln for ln in body.splitlines()
                                         if ln.startswith("qfedx_serve_")])
                watch.evaluate_once()
                mid["healthz"] = _scrape(base + "/healthz")
                f.write("\n".join(lines[first + 1:]) + "\n")
        except BaseException as exc:  # noqa: BLE001 — raised below
            mid["error"] = exc

    feeder = threading.Thread(target=feed, name="obs-serve-feed",
                              daemon=True)
    feeder.start()
    orig = obs.Histogram
    prof_dir = root / "serve-profile"
    try:
        with env_pins(QFEDX_METRICS_PORT=str(port), QFEDX_WATCH="on",
                      QFEDX_FLIGHT="on", QFEDX_SERVE_SLO_MS="0.001",
                      QFEDX_TRACE="0", QFEDX_TRACE_XLA="1"):
            obs.Histogram = Recording
            scan_body.reset_counts()
            with profile.capture(prof_dir):
                summary = cli.main(["serve", "--run-dir", str(run_dir),
                                    "--input", str(fifo), "--output",
                                    str(out), "--trace"])
            launched = scan_body.launch_counts["fwd"] - mid.get("fwd0", 0)
            builds = scan_body.build_count
    finally:
        obs.Histogram = orig
        if feeder.is_alive():
            # The CLI failed before reading: a reader end unblocks the
            # feeder's open, and its writes then fail.
            fd = os.open(fifo, os.O_RDONLY | os.O_NONBLOCK)
            feeder.join(30)
            os.close(fd)
        server.stop_server()
        watch.reset()
        dumped = flight.last_dump()
        flight.reset()
    if "error" in mid:
        raise mid["error"]
    code, metrics = mid["metrics"]
    scraped = {ln.split()[0]: float(ln.split()[1]) for ln in metrics
               if not ln.startswith("#") and "{" not in ln}
    hz_code, hz_body = mid["healthz"]
    health = json.loads(hz_body)
    active = [a["rule"] for a in health.get("alerts", {}).get("active", [])]
    resp = [json.loads(line) for line in out.read_text().splitlines()]
    got = np.array([r["logits"] for r in resp if "logits" in r])
    trace = json.loads((run_dir / "serve_trace.json").read_text())
    compute = sum(1 for e in trace["traceEvents"]
                  if e["ph"] == "X" and e["name"] == "serve.compute")
    exact = {q: obs.percentile(sorted(recorded), q) for q in (0.5, 0.95)}
    psum = profile.summarize(profile.parse_capture(prof_dir))
    census = profile.kernel_launches(profile.load_capture(
        profile.find_capture(prof_dir)))
    if got.shape != cli_served["logits"].shape:
        raise AssertionError(f"obs-serve logits {got.shape}")
    err = float(np.abs(got - cli_served["logits"]).max())
    print(f"[obs-serve] {summary['served']} served in {summary['batches']} "
          f"batches; mid-stream /metrics ({code}) after {first} requests: "
          f"qfedx_serve_batches {scraped.get('qfedx_serve_batches')!r}, "
          f"Launch A since warmup {mid['launched']}; /healthz {hz_code} "
          f"status {health['status']!r}, active rules {active}; flight.json "
          f"{dumped}; latency p50 {summary['p50_ms']} ms p95 "
          f"{summary['p95_ms']} ms (histogram) vs exact "
          f"{exact[0.5]:.4f} / {exact[0.95]:.4f} ms; logits "
          f"max|obs-serve - cli-serve| {err:.3e} (atol {OBS_LOGIT_ATOL:g}); "
          f"serve.compute spans {compute}; Launch A after warmup "
          f"{launched}; builds {mid['builds0']} -> {builds}")
    print(f"[obs-serve] the profiler's scan-body kernel events {census} "
          f"over the warmup ({mid['fwd0']} A) and {summary['batches']} "
          f"served batches; device timeline of the served stream (under "
          f"the profiler): busy fraction {psum['device_busy_fraction']!r} "
          f"of a {psum['device_window_s']!r} s window, "
          f"{psum['ops_executed']} device ops, gaps p50 "
          f"{psum['gap_p50_us']!r} us p95 {psum['gap_p95_us']!r} us; "
          + ", ".join(f"{k} {v['device_busy_s']!r} s device of "
                      f"{v['wall_s']!r} s" for k, v in sorted(
                          psum["spans"].items())))
    for row in psum["top_ops"][:5]:
        print(f"[obs-serve] top device op: {row['count']} x "
              f"{row['op'][:90]} total {row['total_ms']!r} ms")
    if code != 200 or scraped.get("qfedx_serve_batches") != mid["launched"]:
        raise AssertionError(f"obs-serve: /metrics {metrics} vs "
                             f"{mid['launched']} launches")
    if hz_code != 503 or "serve.p95_slo" not in active:
        raise AssertionError(f"obs-serve: /healthz {hz_code} {health}")
    if dumped is None or not (run_dir / "flight.json").is_file():
        raise AssertionError("obs-serve: no flight.json dumped")
    if compute != summary["batches"] or launched != summary["batches"]:
        raise AssertionError(f"obs-serve: {compute} compute spans and "
                             f"{launched} launches for {summary['batches']}"
                             " batches")
    if builds != mid["builds0"]:
        raise AssertionError("obs-serve: a build after warmup")
    if census != {"fwd": mid["fwd0"] + summary["batches"], "fwd_bnd": 0,
                  "adj": 0, "unattributed": 0,
                  "total": mid["fwd0"] + summary["batches"]}:
        raise AssertionError(f"obs-serve: the profiler counted {census} "
                             f"for {summary['batches']} batches after a "
                             f"warmup of {mid['fwd0']} A")
    _require(err, OBS_LOGIT_ATOL, "obs-serve logits vs cli-serve")
    return {"launches": {"fwd": launched, "fwd_bnd": 0, "adj": 0},
            "logit_err": err, "p50": summary["p50_ms"],
            "p95": summary["p95_ms"], "exact": exact, "census": census,
            "summary": psum}


def phase_obs_streamed(device) -> dict:
    """``[obs-streamed]``: one round of [chaos-kernel]'s shape, untraced
    then under QFEDX_TRACE=1 (see the module docstring)."""
    from qfedx_tpu_torch import obs
    from qfedx_tpu_torch.data.stream import SyntheticRegistry
    from qfedx_tpu_torch.fed.config import FedConfig
    from qfedx_tpu_torch.fed.sampling import CohortSampler
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier

    n, layers, cohort, wave, batch, seed = 12, 3, 256, 32, 8, 0
    registry = SyntheticRegistry(1 << 16, samples=8, n_features=n, seed=2)
    test = _registry_test_set(registry, n)
    cfg = FedConfig(local_epochs=1, batch_size=batch, learning_rate=0.1,
                    optimizer="adam", aggregator="clip_mean",
                    clip_bound=CHAOS_CLIP)
    sampler = CohortSampler(registry.num_clients, cohort, seed)
    runs = {}
    for traced in ("0", "1"):
        plan = chaos_kernel_plan(sampler, 1, cohort)
        with env_pins(QFEDX_TRACE=traced):
            obs.reset()
            t0 = time.perf_counter()
            res, rows, launches = _streamed(
                make_vqc_classifier(n, layers, 2, device=device), cfg,
                registry, test, device, 1, cohort_size=cohort,
                wave_size=wave, seed=seed, eval_every=1, fault_plan=plan)
            wall = time.perf_counter() - t0
        reg = obs.registry()
        runs[traced] = dict(theta=_theta(res.params), rows=rows,
                            launches=launches, fired=dict(plan.fired),
                            wall=wall, spans=[s.name for s in reg.spans],
                            counters=dict(reg.counters),
                            gauges=dict(reg.gauges), plan=plan)
    obs.reset()
    plain, traced = runs["0"], runs["1"]
    want = _chaos_ledger("obs-streamed", traced["rows"], traced["plan"],
                         sampler.round_ids, cohort, clip=True)[0]
    counters = traced["counters"]
    injected = {k[len("faults.injected."):]: v for k, v in counters.items()
                if k.startswith("faults.injected.")}
    ledger = {"dropped_clients": counters.get("fed.dropped_clients", 0),
              "rejected_updates": counters.get("fed.rejected_updates", 0),
              "clipped_clients": counters.get("fed.clipped_clients", 0)}
    ingest = {k: v for k, v in counters.items() if k.startswith("ingest.")}
    spans = traced["spans"]
    h2d = spans.count("ingest.h2d")
    theta_err = _max_err(traced["theta"], plain["theta"])
    print(f"[obs-streamed] one round, cohort {cohort} in {cohort // wave} "
          f"waves of {wave}, n={n}: untraced {plain['wall']:.2f} s, traced "
          f"{traced['wall']:.2f} s (host clock); launches "
          f"{traced['launches']} vs {plain['launches']}; theta "
          f"max|traced-untraced| {theta_err:.3e} (atol {OBS_THETA_ATOL:g}); "
          f"faults.injected {injected} vs the plan's {traced['fired']}; fed "
          f"counters {ledger} vs the ledger {want}; ingest counters "
          f"{ingest}, ingest.h2d spans {h2d}, queue depth gauge "
          f"{traced['gauges'].get('ingest.queue_depth')!r}; round spans "
          f"{sorted({s for s in spans if s.startswith('round.')})}")
    if traced["launches"] != plain["launches"]:
        raise AssertionError("obs-streamed: tracing changed the launches")
    _require(theta_err, OBS_THETA_ATOL, "obs-streamed theta, traced vs not")
    if injected != traced["fired"] or not injected:
        raise AssertionError(f"obs-streamed injected {injected}")
    if ledger != {k: want[k] for k in ledger}:
        raise AssertionError(f"obs-streamed fed counters {ledger}")
    if any(ingest.values()) or h2d != cohort // wave:
        raise AssertionError(f"obs-streamed ingest {ingest}, {h2d} h2d spans")
    if not {"round.dispatch", "round.fetch", "round.eval"} <= set(spans):
        raise AssertionError(f"obs-streamed spans {sorted(set(spans))}")
    return {"launches": traced["launches"], "theta_err": theta_err}


# --- tuning and the tools (tune/, serve --tuned, sweep, demo, inspect) ------

TUNE_BUCKET_SETS = "1,8;1,8,32"
TUNE_DEADLINES = "2.5,5"
# Offered-load requests per (cell, rate) point of [tune]: at the fastest
# point (0.8 of the (1, 8, 32) capacity, ~2600 rps) about 0.8 s of
# arrivals, so that each p95 rests on ~100 tail samples.
TUNE_REQUESTS = 2048
TUNE_LIVE_PERIOD = "0.25"  # QFEDX_TUNE of [tune-controller]'s live stream
TUNE_CFG = dict(buckets=BUCKETS, deadline_ms=5.0, max_queue=256, slo_ms=50.0)
DEMO_ATOL = 1e-6  # run_demo's numbers, card vs CPU (the tests' bound)
# [sweep]'s n = 4 cells: accuracy card vs CPU. Under Adam the two runs part
# by ±lr steps on zero-gradient angles (see [streamed]), which can move
# a test prediction near the boundary: two points of accuracy.
SWEEP_ACC_ATOL = 0.02
TOOL_PHASES = ("tune", "serve-tuned", "tune-controller", "tune-cli",
               "sweep", "demo", "inspect", "bench-history")
# A selected phase runs the phases it reads from first.
TOOL_NEEDS = {"serve-tuned": ("tune",), "tune-cli": ("tune",)}
_SERVE_PIN_NAMES = ("QFEDX_SERVE_BUCKETS", "QFEDX_SERVE_DEADLINE_MS",
                    "QFEDX_SERVE_QUEUE", "QFEDX_SERVE_SLO_MS")


class EngineLog:
    """Patches ``ServeEngine.warmup`` and ``ServeEngine._forward`` so
    that every engine warmed inside the block records its config, the
    builds its warmup caused, the batch shape of each forward (warmup
    and traffic, retries included) and, read at the next engine's warmup
    or at the block's end, the Launch A it made."""

    def __enter__(self):
        from qfedx_tpu_torch.ops import scan_body
        from qfedx_tpu_torch.serve import engine

        self.cls, self.sb = engine.ServeEngine, scan_body
        self.orig = (self.cls.warmup, self.cls._forward)
        self.engines: list = []
        log = self

        def warmup(eng):
            log._close()
            rec = {"buckets": tuple(eng.config.buckets),
                   "deadline_ms": eng.config.deadline_ms,
                   "fwd0": scan_body.launch_counts["fwd"],
                   "builds0": scan_body.build_count, "shapes": []}
            log.engines.append(rec)
            eng._smoke_log = rec
            out = log.orig[0](eng)
            rec["warm_builds"] = scan_body.build_count - rec["builds0"]
            return out

        def forward(eng, xb):
            rec = getattr(eng, "_smoke_log", None)
            if rec is not None:
                rec["shapes"].append(int(xb.shape[0]))
            return log.orig[1](eng, xb)

        self.cls.warmup, self.cls._forward = warmup, forward
        return self

    def _close(self):
        if self.engines and "launches" not in self.engines[-1]:
            rec = self.engines[-1]
            rec["launches"] = self.sb.launch_counts["fwd"] - rec["fwd0"]
            rec["builds"] = self.sb.build_count - rec["builds0"]

    def __exit__(self, *exc):
        self._close()
        self.cls.warmup, self.cls._forward = self.orig

    def check(self, tag: str) -> dict:
        """Every engine: no build at or after warmup, one Launch A per
        forward (the warmed buckets plus the batches served), every
        forward at a warmed bucket. Returns the totals."""
        for rec in self.engines:
            served = len(rec["shapes"]) - len(rec["buckets"])
            if rec["warm_builds"] or rec["builds"]:
                raise AssertionError(f"{tag}: {rec['builds']} builds")
            if rec["launches"] != len(rec["shapes"]):
                raise AssertionError(
                    f"{tag}: {rec['launches']} Launch A for "
                    f"{len(rec['buckets'])} warmed buckets + {served} "
                    "batches")
            cold = sorted(set(rec["shapes"]) - set(rec["buckets"]))
            if cold:
                raise AssertionError(f"{tag}: forwards at {cold}, outside "
                                     f"the warmed {rec['buckets']}")
        return {"fwd": sum(r["launches"] for r in self.engines),
                "fwd_bnd": 0, "adj": 0}


def _cpu_logits(run_dir, x) -> np.ndarray:
    """The CPU port's logits of ``x`` on the run's newest checkpoint."""
    from qfedx_tpu_torch.serve.engine import engine_from_run_dir

    engine, _ = engine_from_run_dir(run_dir, device="cpu")
    with torch.no_grad():
        return engine.model.apply(engine.params, x).numpy()


def phase_tune(run_dir) -> dict:
    """``[tune]``: ``tune --run-dir`` over two bucket sets × two
    deadlines on the traced n = 12 run: every cell warms without a build
    and launches one A per forward at a warmed bucket; each cell's
    score printed."""
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.run import cli
    from qfedx_tpu_torch.utils import pins

    argv = ["tune", "--run-dir", str(run_dir), "--buckets",
            TUNE_BUCKET_SETS, "--deadlines", TUNE_DEADLINES,
            "--requests", str(TUNE_REQUESTS)]
    t0 = time.perf_counter()
    with env_pins(*_SERVE_PIN_NAMES), EngineLog() as log:
        scan_body.reset_counts()
        record = cli.main(argv)
        launches = dict(scan_body.launch_counts)
    wall = time.perf_counter() - t0
    for cell, rec in zip(record["cells"], log.engines):
        rates = "; ".join(
            f"{k}: offered {v['offered_rps']} rps, completed "
            f"{v.get('completed_rps')} rps, p50 {v.get('p50_ms')} ms, p95 "
            f"{v.get('p95_ms')} ms, shed {v['shed']}"
            for k, v in cell["rates"].items())
        print(f"[tune] cell buckets {cell['buckets']} deadline "
              f"{cell['deadline_ms']:g} ms: throughput_at_slo "
              f"{cell['throughput_at_slo']} rps, p50 {cell['p50_ms']} ms, "
              f"p95 {cell['p95_ms']} ms, capacity {cell['capacity_rps']} "
              f"rps ({rates}); Launch A {rec['launches']} = "
              f"{len(rec['buckets'])} warmed + "
              f"{len(rec['shapes']) - len(rec['buckets'])} batches, builds "
              f"{rec['warm_builds']} at warmup")
    totals = log.check("tune")
    if len(record["cells"]) != 4 or launches != totals:
        raise AssertionError(f"tune: {len(record['cells'])} cells, "
                             f"launches {launches} vs {totals}")
    if record["key"]["backend"] != pins.resolve_device(None).type:
        raise AssertionError(f"tune key {record['key']}")
    print(f"[tune] {' '.join(argv[:1] + argv[3:])}: {wall:.2f} s (host "
          f"clock); winner pins {record['pins']}, score {record['score']} "
          f"(SLO {record['key']['slo_ms']:g} ms); launches {launches}")
    return {"record": record, "launches": launches, "cells": log.engines}


def phase_serve_tuned(root, run_dir, record: dict) -> dict:
    """``[serve-tuned]``: ``serve --tuned`` replays the sidecar's pins;
    the served buckets are the winner's and the logits are within
    LOGIT_ATOL of the CPU port."""
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.run import cli

    x = np.random.default_rng(23).uniform(0, 1, (N_SERVE_REQUESTS, N_QUBITS))
    x = x.astype(np.float32)
    req = root / "tuned-requests.jsonl"
    req.write_text("".join(json.dumps({"id": i, "features": v.tolist()})
                           + "\n" for i, v in enumerate(x)))
    out = root / "tuned-responses.jsonl"
    with env_pins(*_SERVE_PIN_NAMES), EngineLog() as log:
        scan_body.reset_counts()
        summary = cli.main(["serve", "--run-dir", str(run_dir), "--tuned",
                            "--input", str(req), "--output", str(out)])
        launches = dict(scan_body.launch_counts)
    totals = log.check("serve-tuned")
    got = np.array([json.loads(line)["logits"]
                    for line in out.read_text().splitlines()])
    err = float(np.abs(got - _cpu_logits(run_dir, x)).max())
    want = tuple(int(b) for b in
                 record["pins"]["QFEDX_SERVE_BUCKETS"].split(","))
    (eng,) = log.engines
    print(f"[serve-tuned] {summary['served']} served in "
          f"{summary['batches']} batches at the sidecar's buckets "
          f"{eng['buckets']} and deadline {eng['deadline_ms']:g} ms; p50 "
          f"{summary['p50_ms']} ms p95 {summary['p95_ms']} ms (a smoke "
          f"reading of {N_SERVE_REQUESTS} requests, not a latency "
          "measurement); logits "
          f"max|card-cpu| {err:.3e} (atol {LOGIT_ATOL:g}); launches "
          f"{launches}")
    if eng["buckets"] != want or eng["deadline_ms"] != float(
            record["pins"]["QFEDX_SERVE_DEADLINE_MS"]):
        raise AssertionError(f"serve --tuned ran {eng}")
    if launches != totals or summary["served"] != N_SERVE_REQUESTS:
        raise AssertionError(f"serve-tuned: {summary}, {launches}")
    _require(err, LOGIT_ATOL, "serve --tuned logits vs cpu")
    return {"launches": launches, "logit_err": err}


def _tune_surfaces(run, tag: str, totals: dict) -> dict:
    """Decisions reconciled across the controller's totals, the
    ``tune.decisions`` counter, the run's event rows and the flight
    ring; returns the rows."""
    from qfedx_tpu_torch import obs
    from qfedx_tpu_torch.obs import flight

    rows = [r for r in _rows(run.dir) if r.get("event") == "tune"]
    counter = obs.registry().counters.get("tune.decisions", 0.0)
    ring = [e for e in flight.events() if e["kind"] == "tune"]
    print(f"[{tag}] decisions {totals['decisions']} (reverts "
          f"{totals['reverts']}) = tune.decisions {counter:g} = "
          f"{len(rows)} event rows = {len(ring)} flight entries: "
          + ", ".join(f"{r['decision']} {r['field']} {r['from']} -> "
                      f"{r['to']} ({r['value']:.3f} vs {r['threshold']:g})"
                      for r in rows))
    if not totals["decisions"] == counter == len(rows) == len(ring):
        raise AssertionError(f"{tag}: the surfaces disagree")
    return rows


def phase_tune_controller(obs_root, run_dir) -> dict:
    """``[tune-controller]``: the reference's drifting-load script on the
    n = 12 engine (QFEDX_TUNE=60, ticks by hand), its rows into the
    traced run's metrics.jsonl; then a live stream under
    QFEDX_TUNE=TUNE_LIVE_PERIOD (see the module docstring)."""
    import threading

    from qfedx_tpu_torch import obs, tune
    from qfedx_tpu_torch.obs import flight, watch
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.run.metrics import ExperimentRun
    from qfedx_tpu_torch.serve import MicroBatcher, ServeConfig, ServeEngine
    from qfedx_tpu_torch.serve.engine import engine_from_run_dir

    restored, _ = engine_from_run_dir(run_dir, device="cpu")
    model = _card_model(run_dir)
    rng = np.random.default_rng(29)

    def engine():
        return ServeEngine(model, restored.params, (N_QUBITS,),
                           config=ServeConfig(**TUNE_CFG))

    # The scripted run.
    scripted = {}
    with env_pins(QFEDX_TUNE="60", QFEDX_FLIGHT="on", QFEDX_TRACE="0",
                  QFEDX_SERVE_SLO_MS="100000"), EngineLog() as log:
        obs.reset()
        flight.reset()
        scan_body.reset_counts()
        with ExperimentRun(obs_root, run_dir.name, resume=True) as run:
            eng = engine()
            eng.warmup()
            ctl = eng.tuner
            ticks = [ctl.decide_once()]
            with MicroBatcher(eng) as b:
                for r in rng.uniform(0, 1, (8, N_QUBITS)).astype(np.float32):
                    b.submit(r).result(timeout=60)
            ticks.append(ctl.decide_once())
            for _ in range(tune.MIN_WINDOW_COUNT + 4):
                obs.histogram("serve.latency_ms", 100.0)
            ticks.append(ctl.decide_once())
            with env_pins(QFEDX_WATCH="1"):
                obs.gauge("fed.loss", float("nan"))
                watch.evaluate_once()
                ticks.append(ctl.decide_once())
                ticks.append(ctl.decide_once())
                obs.gauge("fed.loss", 0.4)
                watch.evaluate_once()
                ticks.append(ctl.decide_once())
            ctl.stop()
            scripted["totals"] = dict(ctl.totals)
            flight.dump(run_dir / "flight.json", reason="tune-controller")
        rows = _tune_surfaces(run, "tune-controller", scripted["totals"])
        scripted["launches"] = dict(scan_body.launch_counts)
        watch.reset()
    per_tick = [[d["decision"] for d in t] for t in ticks]
    print(f"[tune-controller] scripted (QFEDX_TUNE=60, ticks by hand): "
          f"{per_tick}; launches {scripted['launches']}")
    if per_tick != [[], ["buckets.shrink"], ["deadline.tighten"],
                    ["revert.alert"], [], []]:
        raise AssertionError(f"tune-controller decided {per_tick}")
    scripted["rows"] = rows
    if log.check("tune-controller") != scripted["launches"]:
        raise AssertionError(f"tune-controller launches "
                             f"{scripted['launches']}")

    # The live stream: singles, then bursts of 32, the ticker deciding.
    x = rng.uniform(0, 1, (40 + 12 * 32, N_QUBITS)).astype(np.float32)
    # A ring that holds the whole stream's events (every counter bump is
    # one), so that no tune entry is evicted before it is counted.
    with env_pins(QFEDX_TUNE=TUNE_LIVE_PERIOD, QFEDX_FLIGHT="65536",
                  QFEDX_TRACE="0"), EngineLog() as log:
        obs.reset()
        flight.reset()
        scan_body.reset_counts()
        with ExperimentRun(obs_root, "tune-live") as run:
            eng = engine()
            eng.warmup()
            threads = [t.name for t in threading.enumerate()]
            t0 = time.perf_counter()
            futs = []
            with MicroBatcher(eng) as b:
                for i in range(40):  # ~1.2 s of singles
                    futs.append(b.submit(x[i]))
                    futs[-1].result(timeout=60)
                    time.sleep(0.02)
                for k in range(12):  # bursts of 32
                    burst = [b.submit(x[40 + 32 * k + j]) for j in range(32)]
                    futs.extend(burst)
                    for f in burst:
                        f.result(timeout=60)
                    time.sleep(0.1)
            live_s = time.perf_counter() - t0
            eng.tuner.stop()
            live = {"totals": dict(eng.tuner.totals),
                    "active": (eng.tuner.deadline_ms, eng.tuner.max_bucket)}
        live["rows"] = _tune_surfaces(run, "tune-controller", live["totals"])
        live["launches"] = dict(scan_body.launch_counts)
    got = np.stack([f.result()["logits"] for f in futs])
    err = float(np.abs(got - _cpu_logits(run_dir, x)).max())
    lat = sorted((f.done_t - f.submit_t) * 1e3 for f in futs)
    print(f"[tune-controller] live stream (QFEDX_TUNE={TUNE_LIVE_PERIOD}): "
          f"{len(futs)} requests in {live_s:.2f} s (host clock), "
          f"{len(log.engines[0]['shapes']) - len(BUCKETS)} batches of "
          f"{sorted(set(log.engines[0]['shapes']))}, latency p50 "
          f"{obs.percentile(lat, 0.5):.4f} ms p95 "
          f"{obs.percentile(lat, 0.95):.4f} ms (exact; SLO "
          f"{TUNE_CFG['slo_ms']:g} ms); active deadline "
          f"and cap at the end {live['active']}; ticker thread "
          f"{'qfedx-tune-controller' in threads}; logits max|card-cpu| "
          f"{err:.3e} (atol {LOGIT_ATOL:g}); launches {live['launches']}")
    if log.check("tune-controller live") != live["launches"]:
        raise AssertionError(f"tune-controller launches {live['launches']}")
    if not live["totals"]["decisions"]:
        raise AssertionError("tune-controller: the live ticker decided "
                             "nothing")
    if "qfedx-tune-controller" not in threads:
        raise AssertionError("tune-controller: no ticker thread")
    _require(err, LOGIT_ATOL, "tune-controller live logits vs cpu")
    flight.reset()
    return {"scripted": scripted, "live": live, "logit_err": err}


def _card_model(run_dir):
    """The run's model built on the card (for an engine made here)."""
    from qfedx_tpu_torch.run.config import (
        build_model,
        experiment_config_from_dict,
    )
    from qfedx_tpu_torch.serve.engine import infer_num_classes

    cfg = experiment_config_from_dict(
        json.loads((run_dir / "config.json").read_text()))
    return build_model(cfg, infer_num_classes(cfg))


def phase_tune_cli(root, record: dict) -> dict:
    """``[tune-cli]``: one round of [cli-train]'s argv untuned, then
    with ``--tuned`` (serving pins only): θ equal to 0, ``tuned_from``
    recorded."""
    from qfedx_tpu_torch.ops import scan_body

    side = record["path"]
    builds0 = scan_body.build_count
    runs = {}
    for name, extra in (("tcli-untuned", []),
                        ("tcli-tuned", ["--tuned", side])):
        argv = CLI_ARGV + ["--rounds", "1", "--run-root", str(root),
                           "--name", name, *extra]
        with env_pins(*_SERVE_PIN_NAMES):
            t0 = time.perf_counter()
            _, launches, _, _ = cli_train(argv, None)
            runs[name] = {"launches": launches,
                          "wall": time.perf_counter() - t0,
                          "theta": _run_theta(root / name, 1)}
    cfg = json.loads((root / "tcli-tuned" / "config.json").read_text())
    diff = _max_err(runs["tcli-tuned"]["theta"], runs["tcli-untuned"]["theta"])
    print(f"[tune-cli] train --tuned {side}: config.json tuned_from "
          f"{cfg['tuned_from']!r}; theta max|tuned-untuned| {diff:.3e} "
          f"(required 0); launches {runs['tcli-tuned']['launches']} vs "
          f"{runs['tcli-untuned']['launches']}; walls "
          + ", ".join(f"{k} {v['wall']:.2f} s" for k, v in runs.items()))
    if cfg["tuned_from"] != side or diff != 0.0:
        raise AssertionError(f"tune-cli: tuned_from {cfg['tuned_from']}, "
                             f"theta {diff}")
    if runs["tcli-tuned"]["launches"] != runs["tcli-untuned"]["launches"] \
            or not runs["tcli-tuned"]["launches"]["fwd_bnd"]:
        raise AssertionError(f"tune-cli launches {runs}")
    if scan_body.build_count != builds0:
        raise AssertionError("tune-cli: a kernel build")
    return {"launches": runs["tcli-tuned"]["launches"], "theta_err": diff}


def _matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def phase_sweep(root) -> dict:
    """``[sweep]``: the quick preset, one seed, each cell on the card and
    on the CPU (accuracy within SWEEP_ACC_ATOL, ε equal), the aggregates
    and the table; the whole ``run_sweep`` where matplotlib imports."""
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.run import sweep

    cells = sweep.preset_cells("quick")
    runs = {}
    scan_body.reset_counts()
    for cell in cells:
        card = sweep._run_cell(cell, 42, device="cuda")
        launches = dict(scan_body.launch_counts)
        cpu = sweep._run_cell(cell, 42, device="cpu")
        runs[cell["name"]] = [card]
        eps = (card["epsilon"], cpu["epsilon"])
        print(f"[sweep] {cell['name']} (n={cell['qubits']}, "
              f"{cell['clients']} clients, {cell['rounds']} rounds): "
              f"accuracy {card['accuracy']:.4f} card vs {cpu['accuracy']:.4f}"
              f" cpu (atol {SWEEP_ACC_ATOL:g}), epsilon {eps[0]!r} vs "
              f"{eps[1]!r}, round_s {card['round_s']:.4f} vs "
              f"{cpu['round_s']:.4f} (host clock), MB/round "
              f"{card['comm_mb_per_round']}")
        _require(abs(card["accuracy"] - cpu["accuracy"]), SWEEP_ACC_ATOL,
                 f"sweep {cell['name']} accuracy vs cpu")
        if eps[0] != eps[1]:
            raise AssertionError(f"sweep {cell['name']}: epsilon {eps}")
    aggs = {k: sweep._aggregate(v) for k, v in runs.items()}
    for line in sweep._markdown_table(cells, aggs, "cuda").splitlines():
        print(f"[sweep] {line}")
    if _matplotlib():
        result = sweep.run_sweep("quick", seeds=1, root=str(root),
                                 device="cuda")
        print(f"[sweep] ran run_sweep (matplotlib present): {result['dir']}")
    else:
        print("[sweep] ran _run_cell, _aggregate and _markdown_table; "
              "run_sweep's plots need matplotlib, absent here")
    if any(launches.values()):
        raise AssertionError(f"the n=4 sweep cells launched {launches}")
    return {"launches": launches, "aggs": aggs}


def phase_demo(root) -> dict:
    """``[demo]``: the encoder walkthrough's numbers on the card against
    the CPU (within DEMO_ATOL); the PNG where matplotlib imports."""
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.run import demo

    scan_body.reset_counts()
    card = demo.demo_numbers(device="cuda")
    launches = dict(scan_body.launch_counts)
    cpu = demo.demo_numbers(device="cpu")
    err = max(float(np.abs(card[k] - cpu[k]).max()) for k in ("probs", "z"))
    png = _matplotlib()
    out = demo.run_demo(str(root / "demo"), device="cuda", png=png)
    print(f"[demo] label {card['label']}, |a|^2 sum "
          f"{float(card['probs'].sum()):.6f}, <Z> {np.round(card['z'], 5)};"
          f" max|card-cpu| {err:.3e} (atol {DEMO_ATOL:g}); "
          + (f"PNG {out['png']}" if png else
             "no PNG (matplotlib absent: run_demo(png=False))"))
    _require(err, DEMO_ATOL, "demo numbers vs cpu")
    return {"launches": launches, "err": err}


def phase_inspect(run_dir, controller: dict | None) -> dict:
    """``[inspect]``: ``inspect`` on the traced run: its rounds, the
    scripted controller's tune rows and alert, the flight recorder, the
    sidecar and the profile's floor row."""
    from qfedx_tpu_torch.run import cli

    out = cli.main(["inspect", str(run_dir)])
    print(f"[inspect] rounds {out['rounds_completed']}, event rows "
          f"{out['event_rows']}, alerts {out['alerts_fired']}, tune "
          f"decisions {out['tune_decisions']} (reverts "
          f"{out['tune_reverts']}), flight {out.get('flight')}, sidecar "
          f"{(out.get('tune') or {}).get('pins')}, floor "
          f"{out.get('floor_attribution')}, route {out['route']}")
    if out["rounds_completed"] != CLI_ROUNDS or out["invalid_rows"]:
        raise AssertionError(f"inspect: {out}")
    if "floor_attribution" not in out:
        raise AssertionError(f"inspect read {sorted(out)}")
    if controller is not None:
        if out.get("flight", {}).get("reason") != "tune-controller":
            raise AssertionError(f"inspect flight {out.get('flight')}")
        want = {}
        for r in controller["scripted"]["rows"]:
            want[r["decision"]] = want.get(r["decision"], 0) + 1
        if out["tune_decisions"] != want or "trainer.loss" not in \
                out["alerts_fired"]:
            raise AssertionError(f"inspect tune rows {out}")
    return out


def phase_bench_history() -> dict:
    """``[bench-history]``: ``bench history`` over the checkout's
    BENCH_r*.json (the reference's trajectory), then over a regressed
    and an empty directory: exit codes 0/1/2 as the reference's."""
    from qfedx_tpu_torch.run import cli

    here = Path(__file__).resolve().parent
    codes = {}

    def run(d, *extra):
        try:
            cli.main(["bench", "history", "--dir", str(d), *extra])
        except SystemExit as exc:
            return exc.code
        raise AssertionError("bench history did not exit")

    codes["checkout"] = run(here, "--no-gate")
    rows = cli._bench_history_rows(here)
    tmp = Path(tempfile.mkdtemp(prefix="qfedx-bench-"))
    try:
        for n, v in ((4, 100.0), (5, 90.0)):
            (tmp / f"BENCH_r{n:02d}.json").write_text(json.dumps(
                {"rc": 0, "parsed": {"metric": "m", "value": v}}))
        codes["regressed"] = run(tmp)
        empty = tmp / "empty"
        empty.mkdir()
        codes["empty"] = run(empty)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[bench-history] {len(rows)} BENCH_r*.json rows in the checkout "
          f"(latest r{rows[-1]['round'] if rows else None}); exit codes "
          f"{codes}")
    if codes != {"checkout": 0, "regressed": 1, "empty": 2}:
        raise AssertionError(f"bench history exit codes {codes}")
    return codes


def phase_tools(obs_root, run_dir, only=TOOL_PHASES) -> dict:
    """The tool phases in order, each selected by ``only``; the launch
    counts of each are read just after it, from 0 just before."""
    out = {}
    record = None
    if "tune" in only:
        out["tune"] = phase_tune(run_dir)
        record = out["tune"]["record"]
    if "serve-tuned" in only:
        out["serve-tuned"] = phase_serve_tuned(obs_root, run_dir, record)
    if "tune-controller" in only:
        out["tune-controller"] = phase_tune_controller(obs_root, run_dir)
    if "tune-cli" in only:
        out["tune-cli"] = phase_tune_cli(obs_root, record)
    if "sweep" in only:
        out["sweep"] = phase_sweep(obs_root)
    if "demo" in only:
        out["demo"] = phase_demo(obs_root)
    if "inspect" in only:
        out["inspect"] = phase_inspect(run_dir, out.get("tune-controller"))
    if "bench-history" in only:
        out["bench-history"] = phase_bench_history()
    return out


def tool_paths(tools: dict) -> dict:
    """The tool phases' launches for the ``kernels`` line's by_path."""
    ctl = tools["tune-controller"]
    return {
        "tune (2 bucket sets x 2 deadlines)": tools["tune"]["launches"],
        "serve-tuned": tools["serve-tuned"]["launches"],
        "tune-controller (scripted)": ctl["scripted"]["launches"],
        "tune-controller (live stream)": ctl["live"]["launches"],
        "tune-cli (train --tuned, 1 round)": tools["tune-cli"]["launches"],
        "sweep (quick, n=4)": tools["sweep"]["launches"],
        "demo (n=4)": tools["demo"]["launches"],
    }


# --- the device mesh, the sharded statevector, the multi-device round -------

MESH_PHASES = ("mesh-round", "sv-sharded", "sv-noise", "sv-cli",
               "distributed", "sv-processes")
# [mesh-round]: the CLI run's widths (n = 12, L = 3, 4 clients) in a
# library round of 16 samples a client, batch 16: one local step a round.
MESH_N, MESH_LAYERS, MESH_CLIENTS, MESH_SAMPLES, MESH_BATCH = 12, 3, 4, 16, 16
MESH_ROUNDS = 2
MESH_SLOT_ATOL = 1e-5  # 2 client slots vs 1 slot, both on the card
MESH_CPU_ATOL = 1e-4  # the card's 2-slot round vs the CPU's
SV_WIDE_N = 22  # the reference's test_sharded_beyond_dense_22q shape
SV_WIDE_ATOL = 2e-3  # its bound (tests/test_sharded.py:232-242)
SV_ROUND_ATOL = 1e-4  # the 22-qubit SGD round, sharded vs dense
SV_NOISE_ATOL = 2e-5
# c5-svqc's widths (n = 8, sv 4, 32 clients, classes 0,1, lr 0.2) for 2
# rounds of one local epoch (the cell's two epochs double a round of
# launch-bound sharded steps, PERF.md §6), under SGD so that θ is
# gated (one Adam step is a sign step on the zero-gradient angles).
SV_CLI_ARGV = ["train", "--model", "vqc", "--qubits", "8", "--sv-size", "4",
               "--clients", "32", "--classes", "0,1", "--local-epochs", "1",
               "--lr", "0.2", "--rounds", "2", "--optimizer", "sgd",
               "--checkpoint-every", "1"]
SV_CLI_ATOL = 1e-4


def _mesh_data():
    rng = np.random.default_rng(1216)
    c, s, n = MESH_CLIENTS, MESH_SAMPLES, MESH_N
    return (rng.uniform(0, 1, (c, s, n)).astype(np.float32),
            rng.integers(0, 2, (c, s)).astype(np.int64),
            np.ones((c, s), np.float32))


def _mesh_rounds(device, optimizer: str, mesh) -> dict:
    """MESH_ROUNDS rounds of the [mesh-round] shape on ``device`` over
    ``mesh`` (None: one slot), the counters set to 0 just before each
    round: θ, the losses, each round's launches and the build count after
    it."""
    from qfedx_tpu_torch.fed.config import FedConfig
    from qfedx_tpu_torch.fed.round import (
        RoundDraws,
        make_fed_round,
        shard_client_data,
    )
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.ops import scan_body

    cfg = FedConfig(local_epochs=1, batch_size=MESH_BATCH,
                    learning_rate=0.1, optimizer=optimizer)
    model = make_vqc_classifier(MESH_N, MESH_LAYERS, 2, device=device)
    params = model.init(16)
    cx, cy, cm = _mesh_data()
    rf = make_fed_round(model, cfg, MESH_CLIENTS, mesh=mesh)
    data = (shard_client_data(mesh, cx, cy, cm) if mesh is not None else
            [torch.as_tensor(a, device=device) for a in (cx, cy, cm)])
    out = {"losses": [], "launches": [], "walls": []}
    for r in range(MESH_ROUNDS):
        perms = torch.stack([torch.randperm(
            MESH_SAMPLES, generator=torch.Generator().manual_seed(
                100 * r + c))[None] for c in range(MESH_CLIENTS)])
        scan_body.reset_counts()
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, stats = rf(params, *data, perms=perms,
                           draws=RoundDraws(16, r))
        loss = float(stats.mean_loss)
        out["walls"].append(time.perf_counter() - t0)
        out["launches"].append((dict(scan_body.launch_counts),
                                scan_body.build_count))
        out["losses"].append(loss)
    held = np.random.default_rng(17).uniform(
        0, 1, (32, MESH_N)).astype(np.float32)
    with torch.no_grad():
        out["logits"] = model.apply(params, held).cpu()
    out["theta"] = [t.detach().cpu() for t in trees_leaves(params)]
    return out


def phase_mesh_round(device) -> dict:
    """``[mesh-round]``: the [mesh-round] shape over a 2 × 1 client mesh
    with both slots on the card, under SGD: θ and loss against the
    one-slot round on the card (MESH_SLOT_ATOL) and the CPU's 2-slot
    round (MESH_CPU_ATOL), one Launch B and one C per local step per
    slot, no A, no build after round 0; an Adam twin gated on the
    held-out logits (one Adam step is a sign step on the zero-gradient
    angles, so its θ is printed)."""
    from qfedx_tpu_torch.fed.round import client_mesh

    steps = MESH_SAMPLES // MESH_BATCH
    want = {"fwd": 0, "fwd_bnd": 2 * steps, "adj": 2 * steps}
    out = {"launches": dict(NO_LAUNCH)}
    for opt in ("sgd", "adam"):
        two = _mesh_rounds(device, opt, client_mesh(devices=[device] * 2))
        one = _mesh_rounds(device, opt, None)
        # The CPU twin runs the SGD rounds (the plain sweep at n = 12
        # takes seconds a round on the host).
        cpu = (_mesh_rounds(torch.device("cpu"), opt,
                            client_mesh(devices=["cpu"] * 2))
               if opt == "sgd" else one)
        slot_err = _max_err(two["theta"], one["theta"])
        cpu_err = _max_err(two["theta"], cpu["theta"])
        loss_err = max(max(abs(a - b) for a, b in zip(two["losses"],
                                                      one["losses"])),
                       max(abs(a - b) for a, b in zip(two["losses"],
                                                      cpu["losses"])))
        logit_err = max(_max_err([two["logits"]], [one["logits"]]),
                        _max_err([two["logits"]], [cpu["logits"]]))
        print(f"[mesh-round] {opt}: 2 slots on {device} vs 1 slot theta "
              f"max|err| {slot_err:.3e}, vs the CPU's 2 slots {cpu_err:.3e};"
              f" losses {two['losses']} (1 slot {one['losses']}, cpu "
              f"{cpu['losses']}), max|loss err| {loss_err:.3e}; held-out "
              f"logits {logit_err:.3e}; launches per round "
              f"{[c for c, _ in two['launches']]} (1 slot "
              f"{[c for c, _ in one['launches']]}); round walls "
              f"{[w * 1e3 for w in two['walls']]} ms (1 slot "
              f"{[w * 1e3 for w in one['walls']]} ms; host clock)")
        if opt == "sgd":
            _require(slot_err, MESH_SLOT_ATOL, "mesh-round theta, 2 vs 1 slot")
            _require(cpu_err, MESH_CPU_ATOL, "mesh-round theta, card vs cpu")
            _require(loss_err, MESH_SLOT_ATOL, "mesh-round losses")
            out.update(theta=two["theta"], theta_err=max(slot_err, cpu_err))
        else:
            _require(logit_err, TRAINED_LOGIT_ATOL,
                     "mesh-round adam logits")
            out["adam_logit_err"] = logit_err
        for r, (counts, builds) in enumerate(two["launches"]):
            if counts != want:
                raise AssertionError(f"[mesh-round] {opt} round {r} "
                                     f"launched {counts}, expected {want}")
            if r and builds != two["launches"][0][1]:
                raise AssertionError("[mesh-round] a build after round 0")
            out["launches"] = {k: out["launches"][k] + counts[k]
                               for k in counts}
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def _fwd_ms(fn, device, iters: int = 5) -> float:
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) * 1e3 / iters


def phase_sv_sharded(device) -> dict:
    """``[sv-sharded]``: the n = 22, one-layer HEA forward on 8 sv slots
    (all on ``device``) against the dense engine there (SV_WIDE_ATOL),
    both timed; then one SGD round of 2 clients × 2 samples of the
    sharded model on a (1, 8) mesh against the same round of the dense
    model (SV_ROUND_ATOL): θ moved, no launch."""
    from qfedx_tpu_torch.circuits.ansatz import (
        hardware_efficient,
        init_ansatz_params,
    )
    from qfedx_tpu_torch.circuits.encoders import angle_encode
    from qfedx_tpu_torch.fed.config import FedConfig
    from qfedx_tpu_torch.fed.round import (
        RoundDraws,
        make_fed_round,
        shard_client_data,
    )
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.models.vqc_sharded import (
        make_sharded_vqc_classifier,
    )
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.ops import statevector as sv
    from qfedx_tpu_torch.parallel import fed_mesh, make_sharded_forward

    n = SV_WIDE_N
    mesh = fed_mesh(sv_size=8, devices=[device] * 8)
    fwd, ctx = make_sharded_forward(n, mesh)
    p = init_ansatz_params(5, n, 1, 0.2, device)
    x = torch.linspace(0.05, 0.95, n, device=device)
    scan_body.reset_counts()
    with torch.no_grad():
        z = fwd(p, x)
        zd = sv.expect_z_all(hardware_efficient(angle_encode(x), n, p), n)
        sharded_ms = _fwd_ms(lambda: fwd(p, x), device)
        dense_ms = _fwd_ms(lambda: sv.expect_z_all(hardware_efficient(
            angle_encode(x), n, p), n), device)
    z_err = _max_err([z.cpu()], [zd.cpu()])
    print(f"[sv-sharded] n={n} L=1 on 8 slots of {device} ({ctx.n_local} "
          f"local qubits): <Z> max|sharded-dense| {z_err:.3e} (atol "
          f"{SV_WIDE_ATOL:g}); forward {sharded_ms:.4f} ms sharded, "
          f"{dense_ms:.4f} ms dense (one sample, host clock, synchronised)")
    _require(z_err, SV_WIDE_ATOL, "sv-sharded <Z>, sharded vs dense")
    if not torch.isfinite(z).all():
        raise AssertionError("[sv-sharded] non-finite <Z>")
    forward_launches = dict(scan_body.launch_counts)

    clients, samples = 2, 2
    rng = np.random.default_rng(3)
    cx = rng.uniform(0, 1, (clients, samples, n)).astype(np.float32)
    cy = (cx[..., 0] > 0.5).astype(np.int64)
    cm = np.ones((clients, samples), np.float32)
    cfg = FedConfig(local_epochs=1, batch_size=2, learning_rate=0.1,
                    optimizer="sgd")
    sharded = make_sharded_vqc_classifier(n, 8, 1, 2, device=device)
    dense = make_vqc_classifier(n, 1, 2, device=device)
    params = dense.init(0)
    mesh2d = fed_mesh(sv_size=8, num_client_devices=1,
                      devices=[device] * 8)
    perms = torch.stack([torch.randperm(samples, generator=torch.Generator()
                                        .manual_seed(c))[None]
                         for c in range(clients)])
    scan_body.reset_counts()
    _sync(device)
    t0 = time.perf_counter()
    got, gstats = make_fed_round(sharded, cfg, clients, mesh=mesh2d)(
        params, *shard_client_data(mesh2d, cx, cy, cm), perms=perms,
        draws=RoundDraws(22, 0))
    _sync(device)
    wall = time.perf_counter() - t0
    launches = dict(scan_body.launch_counts)
    want, wstats = make_fed_round(dense, cfg, clients)(
        params, *(torch.as_tensor(a, device=device) for a in (cx, cy, cm)),
        perms=perms, draws=RoundDraws(22, 0))
    err = _max_err([t.cpu() for t in trees_leaves(got)],
                   [t.cpu() for t in trees_leaves(want)])
    moved = _max_err([t.cpu() for t in trees_leaves(got)],
                     [t.cpu() for t in trees_leaves(params)])
    print(f"[sv-sharded] one SGD round, {clients} clients x {samples} "
          f"samples on the (1, 8) mesh: theta max|sharded-dense| {err:.3e} "
          f"(atol {SV_ROUND_ATOL:g}), moved {moved:.3e}, loss "
          f"{float(gstats.mean_loss)!r} (dense {float(wstats.mean_loss)!r});"
          f" launches {launches}, forward's {forward_launches}; round wall "
          f"{wall * 1e3:.4f} ms (host clock)")
    _require(err, SV_ROUND_ATOL, "sv-sharded round theta, sharded vs dense")
    if not moved > 0 or not math.isfinite(float(gstats.mean_loss)):
        raise AssertionError("[sv-sharded] the round did not train")
    if launches != NO_LAUNCH or forward_launches != NO_LAUNCH:
        raise AssertionError(f"[sv-sharded] launched {launches}")
    return {"launches": launches, "z_err": z_err, "theta_err": err,
            "sharded_ms": sharded_ms, "dense_ms": dense_ms}


def phase_sv_noise(device) -> dict:
    """``[sv-noise]``: the trajectory forward at n = 10, L = 2 over 4 sv
    slots against the dense noisy model on the same ``branch_gumbel``
    draws: no branch choice differs, logits within SV_NOISE_ATOL."""
    from qfedx_tpu_torch.fed.round import RoundDraws
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier
    from qfedx_tpu_torch.models.vqc_sharded import (
        make_sharded_vqc_classifier,
    )
    from qfedx_tpu_torch.noise.channels import NoiseModel
    from qfedx_tpu_torch.noise.trajectory import record_branches
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.parallel.sharded import sv_group

    n, layers, batch = 10, 2, 64
    nm = NoiseModel(depolarizing_p=0.05, amp_damping_gamma=0.05,
                    circuit_level=True)
    dense = make_vqc_classifier(n, layers, 2, device=device, noise_model=nm)
    sharded = make_sharded_vqc_classifier(n, 4, layers, 2, device=device,
                                          noise_model=nm)
    params = dense.init(3)
    x = torch.as_tensor(np.random.default_rng(10).uniform(
        0, 1, (batch, n)).astype(np.float32), device=device)
    draws = {k: v[0, 0] for k, v in RoundDraws(1610, 0).train_draws(
        dense.train_draws, 1, 1, batch, device).items()}
    scan_body.reset_counts()
    with torch.no_grad(), record_branches() as shard_log, sv_group(
            [device] * 4):
        got = sharded.apply_train(params, x, draws)
    launches = dict(scan_body.launch_counts)
    with torch.no_grad(), record_branches() as dense_log:
        want = dense.apply_train(params, x, draws)
    differ = sum(int((a != b).sum()) for a, b in zip(shard_log, dense_log))
    choices = sum(int(a.numel()) for a in dense_log)
    err = _max_err([got.cpu()], [want.cpu()])
    print(f"[sv-noise] n={n} L={layers} trajectories of {batch} samples on "
          f"4 slots of {device}: {differ} of {choices} branch choices differ"
          f" from the dense model's, logits max|sharded-dense| {err:.3e} "
          f"(atol {SV_NOISE_ATOL:g}); launches {launches}")
    if differ or len(shard_log) != len(dense_log):
        raise AssertionError(f"[sv-noise] {differ} branch choices differ")
    _require(err, SV_NOISE_ATOL, "sv-noise logits, sharded vs dense")
    return {"launches": launches, "logit_err": err, "choices": choices}


def phase_sv_cli(root, device) -> dict:
    """``[sv-cli]``: ``run.cli.run_train`` with c5-svqc's widths
    (SV_CLI_ARGV: n = 8, sv 4, 32 clients) over eight slots on
    ``device`` (a (2, 4) mesh), 2 rounds under SGD, and its CPU twin's
    same 2 rounds over eight CPU slots: every round's row (loss,
    accuracy) and θ within SV_CLI_ATOL, no launch. A round's cost is
    the run's ``mean_round_time_s``: the trainer's window from the first
    dispatch to the last fetch over its rounds (a row's ``time_s`` is a
    drain-to-drain share, and the pipelined first row holds round 2's
    eager compute too)."""
    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.run import cli

    data = cli_data(SV_CLI_ARGV)
    twin = SV_CLI_ARGV
    twin_rounds = int(SV_CLI_ARGV[SV_CLI_ARGV.index("--rounds") + 1])
    runs = {}
    for name, dev, slots, argv in (
            ("sv-cli", device, [device] * 8, SV_CLI_ARGV),
            ("sv-cli-cpu", torch.device("cpu"), ["cpu"] * 8, twin)):
        argv = argv + ["--run-root", str(root), "--name", name]
        cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
        scan_body.reset_counts()
        t0 = time.perf_counter()
        summary = cli.run_train(cfg, device=dev, data=data, devices=slots)
        runs[name] = (summary, dict(scan_body.launch_counts),
                      time.perf_counter() - t0)
    card, cpu = root / "sv-cli", root / "sv-cli-cpu"
    rows, cpu_rows = _rows(card), _rows(cpu)
    loss_err = max(abs(a["loss"] - b["loss"]) for a, b in zip(rows,
                                                             cpu_rows))
    acc_diff = max(abs(a["accuracy"] - b["accuracy"])
                   for a, b in zip(rows, cpu_rows))
    theta_err = max(_max_err(_run_theta(card, r), _run_theta(cpu, r))
                    for r in range(1, twin_rounds + 1))
    summary, launches, wall = runs["sv-cli"]
    cpu_summary, _, cpu_wall = runs["sv-cli-cpu"]
    if len(rows) != len(cpu_rows) or len(rows) != twin_rounds:
        raise AssertionError(f"[sv-cli] {len(rows)} card rows, "
                             f"{len(cpu_rows)} CPU rows")
    print(f"[sv-cli] c5-svqc widths over 8 slots of {device}: rounds "
          f"{[r['round'] for r in rows]}, losses {[r['loss'] for r in rows]}"
          f" (cpu {[r['loss'] for r in cpu_rows]}), max|loss err| "
          f"{loss_err:.3e}, accuracy diff {acc_diff:.3e}, rounds 1-"
          f"{twin_rounds} theta max|card-cpu| {theta_err:.3e} (atol "
          f"{SV_CLI_ATOL:g}); "
          f"final_accuracy {summary['final_accuracy']!r} (cpu "
          f"{cpu_summary['final_accuracy']!r}); launches {launches}; a "
          f"round (window over {twin_rounds} rounds, host clock) "
          f"{summary['mean_round_time_s']:.4f} s on the card, "
          f"{cpu_summary['mean_round_time_s']:.4f} s on the CPU (rows' "
          f"time_s {[r['time_s'] for r in rows]} / cpu "
          f"{[r['time_s'] for r in cpu_rows]}); whole run {wall:.2f} s, "
          f"CPU twin {cpu_wall:.2f} s, each {twin_rounds} rounds")
    _require(loss_err, SV_CLI_ATOL, "sv-cli losses, card vs cpu")
    _require(theta_err, SV_CLI_ATOL, "sv-cli theta, card vs cpu")
    n_val = len(data["val"][1]) or len(data["test"][1])
    if acc_diff > 1.0 / n_val + 1e-9:
        raise AssertionError(f"[sv-cli] accuracy differs by {acc_diff}")
    if launches != NO_LAUNCH:
        raise AssertionError(f"[sv-cli] launched {launches}")
    return {"launches": launches, "theta_err": theta_err,
            "round_s": summary["mean_round_time_s"],
            "cpu_round_s": cpu_summary["mean_round_time_s"]}


def phase_distributed(device, mesh_round: dict) -> dict:
    """``[distributed]``: ``parallel.mesh.distributed_init`` with world
    size 1 on NCCL (a second call a no-op), then [mesh-round]'s SGD
    rounds with the process group up, so every round's partial sums go
    through ``torch.distributed.all_reduce``: θ equal to [mesh-round]'s
    exactly. One card: no two-GPU path is measured here."""
    import torch.distributed as dist

    from qfedx_tpu_torch.fed.round import client_mesh
    from qfedx_tpu_torch.parallel.mesh import distributed_init

    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    distributed_init(f"localhost:{port}", 1, 0, devices=[device])
    distributed_init(f"localhost:{port}", 1, 0)  # a repeat: a no-op
    calls = []
    orig = dist.all_reduce

    def counted(t, *a, **k):
        calls.append(tuple(t.shape))
        return orig(t, *a, **k)

    dist.all_reduce = counted
    try:
        run = _mesh_rounds(device, "sgd", client_mesh(devices=[device] * 2))
    finally:
        dist.all_reduce = orig
        got_backend = dist.get_backend()
        dist.destroy_process_group()
    diff = _max_err(run["theta"], mesh_round["theta"])
    print(f"[distributed] {got_backend} process group of 1 rank at "
          f"localhost:{port}: {len(calls)} all_reduce calls over "
          f"{MESH_ROUNDS} rounds (shapes {calls}); theta max|err| vs "
          f"[mesh-round] {diff!r} (must be 0); launches per round "
          f"{[c for c, _ in run['launches']]}. No two-GPU path was "
          "measured: the machine has one card and NCCL takes one rank per "
          "GPU; the cross-process round is held on the CPU with gloo.")
    if diff != 0.0:
        raise AssertionError(f"[distributed] theta differs by {diff}")
    if len(calls) != MESH_ROUNDS:
        raise AssertionError(f"[distributed] {len(calls)} all_reduce calls")
    return {"launches": {k: sum(c[k] for c, _ in run["launches"])
                         for k in NO_LAUNCH}, "backend": got_backend}


# [sv-processes]: one process per GPU, up to SV_PROC_MAX, NCCL; the
# cross-process results against the one-process lockstep mesh.
SV_PROC_MAX = 4
SV_PROC_ATOL = 1e-5
SV_PROC_TIMEOUT_S = 600


def _sync_all(devices) -> None:
    for d in {torch.device(d) for d in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _sv_wide_case(slot_devices, world: int, n: int) -> dict:
    """The n-qubit, one-layer forward and one SGD round of 2 clients × 2
    samples on a (1, ``world``) mesh of ``slot_devices`` (this process's
    slots; under a process group every rank's): ⟨Z⟩, θ, the loss, the
    walls, the bytes this process sends for one gate on global qubit 0,
    and that gate's time against one on a local qubit."""
    from qfedx_tpu_torch.circuits.ansatz import init_ansatz_params
    from qfedx_tpu_torch.fed.config import FedConfig
    from qfedx_tpu_torch.fed.round import (
        RoundDraws,
        make_fed_round,
        shard_client_data,
    )
    from qfedx_tpu_torch.models.vqc_sharded import (
        make_sharded_vqc_classifier,
    )
    from qfedx_tpu_torch.parallel import fed_mesh, make_sharded_forward
    from qfedx_tpu_torch.parallel.circuit import sharded_hea_state
    from qfedx_tpu_torch.ops.cpx import CArray
    from qfedx_tpu_torch.parallel.sharded import apply_gate_sharded

    mesh = fed_mesh(sv_size=world, devices=slot_devices)
    fwd, ctx = make_sharded_forward(n, mesh)
    own = [ctx.device(j) for j in ctx.local_slots]
    home = ctx.home
    p = init_ansatz_params(5, n, 1, 0.2, home)
    x = torch.linspace(0.05, 0.95, n, device=home)

    def timed(fn, iters):
        fn()
        _sync_all(own)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn()
        _sync_all(own)
        return out, (time.perf_counter() - t0) * 1e3 / iters

    gate = CArray(torch.tensor([[0.6, 0.8], [0.8, -0.6]], device=home), None)
    with torch.no_grad():
        z, fwd_ms = timed(lambda: fwd(p, x), 5)
        state = sharded_hea_state(ctx, x, p)
        # What this process sends to others for a gate on global qubit 0:
        # a whole shard (re and im) per partner in another process.
        gate_bytes = sum(
            t.numel() * t.element_size() for j in ctx.local_slots
            if not ctx.owns(j ^ ctx.device_mask(0))
            for t in (state[j].re, state[j].im) if t is not None)
        # One gate alone: on global qubit 0 (the exchange) and on the
        # last, local qubit.
        _, global_ms = timed(lambda: apply_gate_sharded(ctx, state, gate, 0),
                             10)
        _, local_ms = timed(lambda: apply_gate_sharded(ctx, state, gate,
                                                       n - 1), 10)
    clients, samples = 2, 2
    rng = np.random.default_rng(3)
    cx = rng.uniform(0, 1, (clients, samples, n)).astype(np.float32)
    cy = (cx[..., 0] > 0.5).astype(np.int64)
    cm = np.ones((clients, samples), np.float32)
    cfg = FedConfig(local_epochs=1, batch_size=2, learning_rate=0.1,
                    optimizer="sgd")
    model = make_sharded_vqc_classifier(n, world, 1, 2, device=home)
    params = model.init(0)
    mesh2d = fed_mesh(sv_size=world, num_client_devices=1,
                      devices=slot_devices)
    rf = make_fed_round(model, cfg, clients, mesh=mesh2d)
    data = shard_client_data(mesh2d, cx, cy, cm)
    perms = torch.stack([torch.randperm(samples, generator=torch.Generator()
                                        .manual_seed(c))[None]
                         for c in range(clients)])
    walls = []
    for _ in range(2):  # the first round pays the subgroups' first use
        _sync_all(own)
        t0 = time.perf_counter()
        got, stats = rf(params, *data, perms=perms, draws=RoundDraws(22, 0))
        loss = float(stats.mean_loss)
        _sync_all(own)
        walls.append(time.perf_counter() - t0)
    group = (1 if ctx.group is None else
             torch.distributed.get_world_size(ctx.group))
    return {"z": z.cpu(), "fwd_ms": fwd_ms, "theta": [
        t.detach().cpu() for t in trees_leaves(got)], "loss": loss,
        "round_ms": [w * 1e3 for w in walls], "gate_bytes": gate_bytes,
        "global_ms": global_ms, "local_ms": local_ms,
        "slots_here": len(own), "group_size": group}


def _sv_grid_case(slot_devices) -> dict:
    """[mesh-round]'s data and widths (n = 12, L = 3, 4 clients × 16
    samples, batch 16) on a (2, 2) mesh of ``slot_devices`` (every
    rank's: 4 slots): one SGD round's θ and loss, the walls of it and of
    its repeat, and the held-out logits through ``host_apply``."""
    from qfedx_tpu_torch.fed.config import FedConfig
    from qfedx_tpu_torch.fed.round import (
        RoundDraws,
        make_fed_round,
        shard_client_data,
    )
    from qfedx_tpu_torch.models.vqc_sharded import (
        host_apply,
        make_sharded_vqc_classifier,
    )
    from qfedx_tpu_torch.parallel import fed_mesh
    from qfedx_tpu_torch.parallel.mesh import home_slot, is_member

    mesh = fed_mesh(sv_size=2, devices=slot_devices)
    group = next(g for g in mesh.sv_groups() if is_member(g))
    home = home_slot(group).device
    own = [s.device for g in mesh.sv_groups() for s in g
           if is_member([s])]
    model = make_sharded_vqc_classifier(MESH_N, 2, MESH_LAYERS, 2,
                                        device=home)
    params = model.init(16)
    cx, cy, cm = _mesh_data()
    cfg = FedConfig(local_epochs=1, batch_size=MESH_BATCH,
                    learning_rate=0.1, optimizer="sgd")
    perms = torch.stack([torch.randperm(
        MESH_SAMPLES, generator=torch.Generator().manual_seed(c))[None]
        for c in range(MESH_CLIENTS)])
    rf = make_fed_round(model, cfg, MESH_CLIENTS, mesh=mesh)
    data = shard_client_data(mesh, cx, cy, cm)
    walls = []
    for _ in range(2):  # the first round pays the subgroups' first use
        _sync_all(own)
        t0 = time.perf_counter()
        got, stats = rf(params, *data, perms=perms, draws=RoundDraws(16, 0))
        loss = float(stats.mean_loss)
        _sync_all(own)
        walls.append(time.perf_counter() - t0)
    held = np.random.default_rng(17).uniform(
        0, 1, (32, MESH_N)).astype(np.float32)
    with torch.no_grad():
        logits = host_apply(model, mesh)(got, held).cpu()
    return {"theta": [t.detach().cpu() for t in trees_leaves(got)],
            "loss": loss, "round_ms": [w * 1e3 for w in walls],
            "logits": logits, "mesh": str(mesh.shape)}


def sv_process_main(argv) -> int:
    """``chip_smoke.py --sv-process <host:port> <world> <rank> <out dir>
    <cuda|cpu> <n>``: one rank of [sv-processes]. It joins the process
    group (NCCL bound to GPU ``rank`` for cuda, gloo for cpu), runs
    ``_sv_wide_case`` on a (1, world) mesh of one slot a rank and, with
    4 ranks, ``_sv_grid_case`` on a (2, 2) mesh, counts the kernel's
    launches, and writes ``<out dir>/rank<rank>.pt``."""
    import torch.distributed as dist

    from qfedx_tpu_torch.ops import scan_body
    from qfedx_tpu_torch.parallel.mesh import distributed_init

    addr, world, rank, out_dir, kind, n = argv
    world, rank = int(world), int(rank)
    slots = None if kind == "cuda" else ["cpu"]
    if slots:
        torch.set_num_threads(1)  # a CPU rehearsal: one core a rank
    distributed_init(addr, world, rank,
                     devices=slots if slots else None)
    scan_body.reset_counts()
    res = {"backend": dist.get_backend(),
           "wide": _sv_wide_case(slots, world, int(n))}
    if world == 4:
        res["grid"] = _sv_grid_case(slots)
    res["launches"] = dict(scan_body.launch_counts)
    torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()
    return 0


def phase_sv_processes(device, world: int | None = None,
                       n: int | None = None) -> dict:
    """``[sv-processes]``: with W = min(GPUs, SV_PROC_MAX) ≥ 2, W
    processes, one per GPU on NCCL (``sv_process_main``), run the n = 22
    forward and one SGD round on a (1, W) mesh whose one sv group spans
    them, and with W = 4 the (2, 2) mesh at [mesh-round]'s widths; each
    held against the same run in this process on a lockstep mesh over
    the same W GPUs (SV_PROC_ATOL), the forward also against the dense
    ⟨Z⟩ (SV_WIDE_ATOL). With one GPU it runs nothing and says so. On the
    CPU (a rehearsal) ``world`` gloo processes of one CPU slot each."""
    from qfedx_tpu_torch.ops import statevector as sv
    from qfedx_tpu_torch.circuits.ansatz import (
        hardware_efficient,
        init_ansatz_params,
    )
    from qfedx_tpu_torch.circuits.encoders import angle_encode
    from qfedx_tpu_torch.ops import scan_body

    n = SV_WIDE_N if n is None else n
    cuda = device.type == "cuda"
    if cuda:
        world = min(torch.cuda.device_count(), SV_PROC_MAX)
    if world < 2:
        print(f"[sv-processes] ran nothing: {torch.cuda.device_count()} GPU"
              " visible, and an sv group across processes needs a second "
              "one (NCCL takes one rank per GPU); the cross-process path is"
              " held on the CPU with gloo (tests/test_torch_sv_processes."
              "py)")
        return {"launches": dict(NO_LAUNCH), "ran": False}
    slots = ([torch.device("cuda", i) for i in range(world)] if cuda
             else ["cpu"] * world)
    scan_body.reset_counts()
    lock = {"wide": _sv_wide_case(slots, world, n)}
    if world == 4:
        lock["grid"] = _sv_grid_case(slots)
    lock_launches = dict(scan_body.launch_counts)
    d0 = torch.device(slots[0])
    p = init_ansatz_params(5, n, 1, 0.2, d0)
    x = torch.linspace(0.05, 0.95, n, device=d0)
    with torch.no_grad():
        zd = sv.expect_z_all(hardware_efficient(angle_encode(x), n, p),
                             n).cpu()
    out_dir = Path(tempfile.mkdtemp(prefix="qfedx-svp-"))
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--sv-process",
         f"localhost:{port}", str(world), str(r), str(out_dir),
         "cuda" if cuda else "cpu", str(n)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    t0 = time.perf_counter()
    try:
        logs = [p.communicate(timeout=SV_PROC_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    spawn_s = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"[sv-processes] rank {r} exited "
                                 f"{p.returncode}:\n{log[-4000:]}")
    ranks = [torch.load(out_dir / f"rank{r}.pt") for r in range(world)]
    shutil.rmtree(out_dir, ignore_errors=True)
    lw, w0 = lock["wide"], ranks[0]["wide"]
    z_err = max(_max_err([r["wide"]["z"]], [lw["z"]]) for r in ranks)
    dense_err = max(_max_err([r["wide"]["z"]], [zd]) for r in ranks)
    theta_err = max(_max_err(r["wide"]["theta"], lw["theta"])
                    for r in ranks)
    loss_err = max(abs(r["wide"]["loss"] - lw["loss"]) for r in ranks)
    gate_bytes = [r["wide"]["gate_bytes"] for r in ranks]
    launches = {k: sum(r["launches"][k] for r in ranks) for k in NO_LAUNCH}
    print(f"[sv-processes] {world} processes, one "
          f"{'GPU' if cuda else 'CPU slot'} each, {ranks[0]['backend']}; "
          f"the sv group's process subgroup holds {w0['group_size']} ranks."
          f" n={n} L=1 on a (1, {world}) mesh: <Z> max|processes-lockstep| "
          f"{z_err:.3e} (atol {SV_PROC_ATOL:g}), vs dense {dense_err:.3e} "
          f"(atol {SV_WIDE_ATOL:g}); forward {w0['fwd_ms']:.4f} ms across "
          f"processes, {lw['fwd_ms']:.4f} ms lockstep in one process (one "
          f"sample, rank 0's host clock, synchronised); one SGD round of 2 "
          f"clients x 2 samples: theta max|processes-lockstep| "
          f"{theta_err:.3e}, loss {w0['loss']!r} (lockstep "
          f"{lw['loss']!r}); round walls {w0['round_ms']} ms across "
          f"processes, {lw['round_ms']} ms lockstep (first, second); a gate "
          f"on a global qubit sends {gate_bytes} bytes a rank (a whole "
          f"shard; a SWAP for a 2-qubit gate half of one); one gate alone "
          f"{w0['global_ms']:.4f} ms on global qubit 0, {w0['local_ms']:.4f}"
          f" ms on local qubit {n - 1} across processes ({lw['global_ms']:.4f}"
          f" / {lw['local_ms']:.4f} ms lockstep); launches "
          f"{launches} (lockstep {lock_launches}); the {world} processes "
          f"took {spawn_s:.2f} s from start to exit")
    _require(z_err, SV_PROC_ATOL, "sv-processes <Z>, processes vs lockstep")
    _require(dense_err, SV_WIDE_ATOL, "sv-processes <Z>, vs dense")
    _require(theta_err, SV_PROC_ATOL,
             "sv-processes round theta, processes vs lockstep")
    _require(loss_err, SV_PROC_ATOL, "sv-processes round loss")
    if w0["group_size"] != world:
        raise AssertionError(f"[sv-processes] subgroup of "
                             f"{w0['group_size']} ranks")
    out = {"launches": launches, "ran": True, "world": world,
           "z_err": z_err, "dense_err": dense_err, "theta_err": theta_err,
           "fwd_ms": w0["fwd_ms"], "lock_fwd_ms": lw["fwd_ms"],
           "round_ms": w0["round_ms"], "lock_round_ms": lw["round_ms"],
           "gate_bytes": gate_bytes}
    if world == 4:
        lg = lock["grid"]
        g_theta = max(_max_err(r["grid"]["theta"], lg["theta"])
                      for r in ranks)
        g_logits = max(_max_err([r["grid"]["logits"]], [lg["logits"]])
                       for r in ranks)
        g0 = ranks[0]["grid"]
        print(f"[sv-processes] (2, 2) mesh {g0['mesh']} at n={MESH_N} "
              f"L={MESH_LAYERS}, {MESH_CLIENTS} clients x {MESH_SAMPLES} "
              f"samples, one SGD round: theta max|processes-lockstep| "
              f"{g_theta:.3e}, held-out logits {g_logits:.3e} (atol "
              f"{SV_PROC_ATOL:g}); loss {g0['loss']!r} (lockstep "
              f"{lg['loss']!r}); round walls {g0['round_ms']} ms across "
              f"processes, {lg['round_ms']} ms lockstep (first, repeat; "
              "host clock)")
        _require(g_theta, SV_PROC_ATOL, "sv-processes (2, 2) theta")
        _require(g_logits, SV_PROC_ATOL, "sv-processes (2, 2) logits")
        out.update(grid_theta_err=g_theta, grid_round_ms=g0["round_ms"],
                   grid_lock_round_ms=lg["round_ms"])
    if launches != NO_LAUNCH or lock_launches != NO_LAUNCH:
        raise AssertionError(f"[sv-processes] launched {launches}")
    return out


# [lint]: the port's rule set (docs/TORCH_ANALYSIS.md) and the
# subprocess's time limit (the engine answers in seconds).
LINT_RULES = frozenset({
    "QFX000", "QFX002", "QFX003", "QFX004", "QFX006", "QFX007", "QFX008",
    "QFX100", "QFX101", "QFX102", "QFX103", "QFX104", "QFX105", "QFX106",
    "QFX107"})
LINT_TIMEOUT_S = 120


def phase_lint() -> dict:
    """``[lint]``: ``python3 -m qfedx_tpu_torch lint --json`` in a
    subprocess from the checkout's root: exit 0, ``ok`` true and exactly
    LINT_RULES run. No kernel is launched."""
    here = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "qfedx_tpu_torch", "lint", "--json"],
        cwd=here, capture_output=True, text=True, timeout=LINT_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"lint exited {proc.returncode}:\n"
                             f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
    report = json.loads(proc.stdout)
    if report["ok"] is not True or set(report["rules_run"]) != LINT_RULES:
        raise AssertionError(f"lint report: ok {report['ok']}, rules "
                             f"{sorted(report['rules_run'])}")
    print(f"[lint] {report['delta']}; {len(report['rules_run'])} rules in "
          f"{seconds:.2f} s (subprocess, no kernel launched)")
    return {"seconds": seconds, "delta": report["delta"]}


def phase_mesh(root, device) -> dict:
    """The mesh phases in order, each with the counters of its own run."""
    t0 = time.perf_counter()
    out = {"mesh-round": phase_mesh_round(device)}
    out["sv-sharded"] = phase_sv_sharded(device)
    out["sv-noise"] = phase_sv_noise(device)
    out["sv-cli"] = phase_sv_cli(root, device)
    out["distributed"] = phase_distributed(device, out["mesh-round"])
    out["sv-processes"] = phase_sv_processes(device)
    print(f"[mesh] the six mesh phases took "
          f"{time.perf_counter() - t0:.2f} s")
    return out


def parse_only(argv) -> tuple | None:
    """``--only a,b``: the tool or mesh phases to run (with what they
    read from), or None for the whole script."""
    if not argv:
        return None
    choices = TOOL_PHASES + MESH_PHASES + ("lint",)
    if argv[0] != "--only" or len(argv) != 2:
        raise SystemExit("usage: python3 chip_smoke.py [--only "
                         + ",".join(choices) + "]")
    picked = [p for p in argv[1].split(",") if p]
    bad = [p for p in picked if p not in choices]
    if bad or not picked:
        raise SystemExit(f"chip_smoke --only: unknown phases {bad}; choose "
                         f"from {','.join(choices)}")
    for p in list(picked):
        picked.extend(TOOL_NEEDS.get(p, ()))
    if "distributed" in picked:
        picked.append("mesh-round")  # it holds θ against [mesh-round]'s
    return tuple(p for p in choices if p in picked)


def main_only(only: tuple) -> int:
    """A rehearsal of the selected phases: the build; for tool phases a
    traced and profiled [cli-train] run on the card to read from (no CPU
    twin); the phases. Prints no ``kernels`` line and no final line."""
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import qfedx_tpu_torch  # noqa: F401 — fails alone, outside the checkout

    if "lint" in only:
        phase_lint()
    if only != ("lint",):
        phase_build()
    device = torch.device("cuda")
    mesh = [p for p in only if p in MESH_PHASES]
    root = Path(tempfile.mkdtemp(prefix="qfedx-mesh-"))
    try:
        done = {}
        for p in mesh:
            if p == "mesh-round":
                done[p] = phase_mesh_round(device)
            elif p == "sv-sharded":
                phase_sv_sharded(device)
            elif p == "sv-noise":
                phase_sv_noise(device)
            elif p == "sv-cli":
                phase_sv_cli(root, device)
            elif p == "sv-processes":
                phase_sv_processes(device)
            else:
                phase_distributed(device, done["mesh-round"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    tools = tuple(p for p in only if p in TOOL_PHASES)
    obs_root = Path(tempfile.mkdtemp(prefix="qfedx-obs-"))
    try:
        if tools:
            with env_pins(QFEDX_TRACE="0"):
                cli_train(CLI_ARGV + ["--trace", "--profile", "--run-root",
                                      str(obs_root), "--name", "obs"], None)
            phase_tools(obs_root, obs_root / "obs", tools)
    finally:
        shutil.rmtree(obs_root, ignore_errors=True)
    print(f"[only] ran {','.join(only)} in "
          f"{time.perf_counter() - T_START:.1f} s; no kernels line and no "
          "final line in a selected run")
    return 0


def trees_first(tree):
    """Every leaf's first entry (one client of a (C, …) stream)."""
    from qfedx_tpu_torch.utils import trees

    return trees.tree_map(lambda v: v[0], tree)


T_START = time.perf_counter()


def main(argv=()) -> int:
    if argv and argv[0] == "--sv-process":
        return sv_process_main(list(argv[1:]))
    only = parse_only(list(argv))
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if only is not None:
        return main_only(only)
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
    reupload = phase_reupload_parity(device)
    bf16_reupload = phase_reupload_parity(device, bf16)
    reupload_served = phase_reupload_serve(device)
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
        reupload_run = phase_encoding_cli_train(
            root, REUPLOAD_ARGV, "reupload", "reupload-cli-train", "reupload")
        reupload_cli_served = phase_cli_serve(
            root, reupload_run["run"], shape=reupload_run["shape"],
            tag="reupload-cli-serve", encoding="reupload")
        amplitude_run = phase_encoding_cli_train(
            root, AMPLITUDE_ARGV, "amplitude", "amplitude-cli-train",
            "amplitude")
        amplitude_served = phase_cli_serve(
            root, amplitude_run["run"], shape=amplitude_run["shape"],
            tag="amplitude-cli-serve", encoding="amplitude")
        config4 = phase_config4(root)
        dp_client = phase_dp_client(root)
        spsa = phase_spsa(root, device)
        dp_example = phase_dp_example(root, device)
        config2 = phase_config2(root)
        cnn = phase_cnn(device)
        config3 = phase_config3(root)
        config5 = phase_config5(root)
        mps_run = phase_mps(root, device)
        noise_readout = phase_noise_cli(root, NOISE_ARGV, "noise-readout",
                                        "noise-readout")
        noise_readout_served = phase_noise_serve(
            root, noise_readout["run"], NOISE_ARGV, "noise-readout-serve")
        noise_circuit = phase_noise_cli(root, NOISE_CIRCUIT_ARGV,
                                        "noise-circuit", "noise-circuit")
        noise_circuit_served = phase_noise_serve(
            root, noise_circuit["run"], NOISE_CIRCUIT_ARGV,
            "noise-circuit-serve")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    dense_route = phase_dense_route(device)
    remat = phase_remat(device)
    dense_times = phase_dense_times(device)
    robust = phase_robust(device)
    noise_traj = phase_noise_trajectory(device)
    noise_probe = phase_noise_probe(device)
    streamed = phase_streamed(device)
    streamed_kernel = phase_streamed_kernel(device)
    streamed_stale = phase_streamed_stale(device)
    chaos = phase_chaos(device)
    chaos_kernel = phase_chaos_kernel(device)
    isolation = phase_chaos_isolation(device)
    bf16_isolation = phase_chaos_isolation(device, bf16)
    chaos_straggler = phase_chaos_straggler(device)
    chaos_serve = phase_chaos_serve(device, served)
    chaos_ckpt = phase_chaos_checkpoint(device)
    obs_root = Path(tempfile.mkdtemp(prefix="qfedx-obs-"))
    try:
        obs_train = phase_obs_train(obs_root, cli_run)
        obs_serve = phase_obs_serve(obs_root, obs_train["run"], cli_served)
        tools = phase_tools(obs_root, obs_train["run"])
    finally:
        shutil.rmtree(obs_root, ignore_errors=True)
    obs_streamed = phase_obs_streamed(device)
    mesh_root = Path(tempfile.mkdtemp(prefix="qfedx-mesh-"))
    try:
        mesh = phase_mesh(mesh_root, device)
    finally:
        shutil.rmtree(mesh_root, ignore_errors=True)
    lint = phase_lint()
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
        "reupload-serve": reupload_served["launches"],
        "reupload-cli-train": reupload_run["launches"],
        "reupload-cli-serve": reupload_cli_served["launches"],
        "amplitude-cli-train (n=11)": amplitude_run["launches"],
        "amplitude-cli-serve": amplitude_served["launches"],
        **{f"config4 ({k})": v for k, v in config4["launches"].items()},
        "dp-client": dp_client["launches"],
        "robust (6 library rounds)": robust["launches"],
        "spsa": spsa["launches"],
        "dp-example": dp_example["launches"],
        "config2 (n=8)": config2["launches"],
        "config3 (cnn)": config3["launches"],
        "config3 serve": config3["serve_launches"],
        "config5 (qkernel, n=20)": config5["launches"],
        "mps (n=24)": mps_run["launches"],
        "noise-readout (n=12, shots)": noise_readout["launches"],
        "noise-readout-serve": noise_readout_served["launches"],
        "noise-circuit (n=12, shots)": noise_circuit["launches"],
        "noise-circuit-serve": noise_circuit_served["launches"],
        **{f"noise-probe {k} ({w})": v[w] for k, v in noise_probe.items()
           for w in ("eval", "step")},
        "streamed (n=8, 3 rounds)": streamed["launches"],
        "streamed-kernel (n=12, 3 rounds of 8 waves)":
            streamed_kernel["launches"],
        "streamed-stale (n=12, 3 rounds, then a dead wave)":
            streamed_stale["launches"],
        "chaos (n=8, 3 rounds)": chaos["launches"],
        "chaos-kernel (n=12, 3 rounds of 8 waves)": chaos_kernel["launches"],
        "chaos-isolation (a NaN wave and its dropped twin)":
            isolation["launches"],
        "chaos-straggler (n=12, 2 rounds)": chaos_straggler["launches"],
        "chaos-serve": {"fwd": chaos_serve["launches"], "fwd_bnd": 0,
                        "adj": 0},
        "chaos-checkpoint and sigterm (n=12)": chaos_ckpt["launches"],
        "obs-train (traced, profiled)": obs_train["launches"],
        "obs-serve (traced, /metrics, watchdog)": obs_serve["launches"],
        "obs-streamed (traced, one round)": obs_streamed["launches"],
        **tool_paths(tools),
        "mesh-round (2 x 1 client mesh, 2 rounds SGD + 2 Adam)":
            mesh["mesh-round"]["launches"],
        "sv-sharded (n=22 forward and round on 8 sv slots)":
            mesh["sv-sharded"]["launches"],
        "sv-noise (n=10 trajectories on 4 sv slots)":
            mesh["sv-noise"]["launches"],
        "sv-cli (c5-svqc widths, (2, 4) mesh, 2 rounds)":
            mesh["sv-cli"]["launches"],
        "distributed (NCCL, 1 rank, 2 rounds)":
            mesh["distributed"]["launches"],
        "sv-processes (an sv group across processes, NCCL)":
            mesh["sv-processes"]["launches"],
    }
    keys = ("ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err")

    # The reupload slice's shapes: Launch A on per-sample stacks (G = tb)
    # at the served buckets, B and C on the fold's mixed groups.
    # The federation slice's shapes: Launch A on SPSA's 2C client groups,
    # B and C on per-example DP's one-sample groups (G = tb).
    spsa_tb = max(t for _, t in spsa["rows"])
    reupload_shapes = {
        "A": {**{f"reupload bucket {b} (G=tb)": r
                 for b, r in reupload_served["rows"].items()},
              f"spsa forward tb={spsa_tb} (G=8)": spsa["rows"]["A", spsa_tb]},
        "B": {"reupload fold C=2 B=16 (mixed G)":
              reupload["rows"]["B", 32],
              "dp-example C=2 B=16 (G=tb)": dp_example["rows"]["B", 32],
              "streamed wave C=32 B=8 (G=32)":
              streamed_kernel["rows"]["B", 256]},
        "C": {"reupload fold C=2 B=16 (mixed G)":
              reupload["rows"]["C", 32],
              "dp-example C=2 B=16 (G=tb)": dp_example["rows"]["C", 32],
              "streamed wave C=32 B=8 (G=32)":
              streamed_kernel["rows"]["C", 256]},
    }

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
                               earlier["max_abs_err"], worst[launch],
                               reupload[launch], spsa["errs"][launch],
                               dp_example["errs"][launch],
                               streamed_kernel["errs"][launch],
                               isolation["rows"][launch]),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                   "bound_by")},
            "library_ms": None,
            "launches_by_path": {p: c[key] for p, c in by_path.items()},
            "shapes": {**{f"tb={t}": {k: r[k] for k in keys}
                          for (l, t), r in shapes["rows"].items()
                          if l == launch},
                       earlier_shape: {k: earlier[k] for k in keys
                                       if k in earlier},
                       **{s_: {k: r[k] for k in keys}
                          for s_, r in reupload_shapes[launch].items()}},
        }

    bf16_paths = {
        "bf16-serve": {"fwd": bf16_served["launches"], "fwd_bnd": 0,
                       "adj": 0},
        "bf16-cli-train": bf16_cli["launches"],
        "bf16-cli-serve": bf16_cli_served["launches"],
        "bf16-chaos-isolation": bf16_isolation["launches"],
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
                               bf16_reupload[launch],
                               bf16_isolation["rows"][launch],
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
    print(f"[summary] reupload: kernel max|kernel-plain| A "
          f"{reupload['A']:.3e} B {reupload['B']:.3e} C {reupload['C']:.3e},"
          f" gradients {reupload['grad']:.3e}; bf16 relative norm "
          f"{bf16_reupload['rel']:.3e}, gradients {bf16_reupload['grad']:.3e};"
          f" served logits max|card-cpu| {reupload_served['logit_err']:.3e};"
          f" CLI run theta max|card-cpu| {reupload_run['theta_err']:.3e}; "
          f"amplitude (n=11) CLI run theta {amplitude_run['theta_err']:.3e};"
          f" config 4 theta card vs cpu {config4['theta_err']:.3e}, round "
          "rate (client-rounds/s) "
          + ", ".join(f"{k}: {v['rate']:.4f}"
                      for k, v in config4["rates"].items()))
    print(f"[summary] federation options: dp-client theta max|card-cpu| "
          f"{dp_client['theta_err']:.3e}, final_epsilon "
          f"{dp_client['summary']['final_epsilon']!r}; robust rounds theta "
          f"{robust['theta_err']:.3e}; spsa theta {spsa['theta_err']:.3e}, "
          f"launches {spsa['launches']}; dp-example theta "
          f"{dp_example['theta_err']:.3e}, launches "
          f"{dp_example['launches']}; config 2 theta "
          f"{config2['theta_err']:.3e}, final_epsilon "
          f"{config2['epsilon']!r}, {config2['rate']:.4f} client-rounds/s")
    print(f"[summary] model families (no kernel on their paths): cnn logits "
          f"max|card-cpu| {cnn['logit_err']:.3e}; "
          f"config 3 theta {config3['theta_err']:.3e}, "
          f"{config3['rate']:.4f} client-rounds/s, served logits "
          f"{config3['serve_err']:.3e}; config 5 theta "
          f"{config5['theta_err']:.3e}, {config5['rate']:.4f} "
          f"client-rounds/s; mps <Z> vs dense {mps_run['z_err']:.3e}, "
          f"gradient {mps_run['grad_err']:.3e}, n=24 theta "
          f"{mps_run['theta_err']:.3e}, {mps_run['rate']:.4f} "
          f"client-rounds/s, {mps_run['svd_calls']} SVD calls per forward "
          f"at {mps_run['svd_ms']:.5f} ms")
    print(f"[summary] noise: readout placement theta max|card-cpu| "
          f"{noise_readout['theta_err']:.3e}, launches "
          f"{noise_readout['launches']}, {noise_readout['rate']:.4f} "
          f"client-rounds/s, served logits "
          f"{noise_readout_served['logit_err']:.3e}; circuit placement theta "
          f"{noise_circuit['theta_err']:.3e}, launches "
          f"{noise_circuit['launches']}, {noise_circuit['branch_differ']} of "
          f"{noise_circuit['branch_choices']} branch choices differ card vs "
          f"cpu, {noise_circuit['rate']:.4f} client-rounds/s, served logits "
          f"{noise_circuit_served['logit_err']:.3e}; trajectories "
          + ", ".join(f"{k}: {v['sigmas']:.3f} sigma, {v['ms']:.3f} ms"
                      for k, v in noise_traj.items()))
    print(f"[summary] streamed: n=8 cohort 4096 "
          f"{streamed['rate']:.4f} client-rounds/s, sync/overlap "
          f"{streamed['sync_ratio']:.4f}, peak {streamed['peak']} B, logits "
          f"max|card-cpu| {streamed['logit_err']:.3e}; n=12 waves of 32 "
          f"{streamed_kernel['rate']:.4f} client-rounds/s, launches "
          f"{streamed_kernel['launches']}, logits "
          f"{streamed_kernel['logit_err']:.3e}; stale theta "
          f"{streamed_stale['theta_err']:.3e}, dead wave under masks "
          f"{streamed_stale['mask_err']:.3e}")
    print(f"[summary] chaos: n=8 at {CHAOS_RATE:g} casualties "
          f"{chaos['rate']:.4f} client-rounds/s, logits max|card-cpu| "
          f"{chaos['logit_err']:.3e}; n=12 waves of 32 "
          f"{chaos_kernel['rate']:.4f} client-rounds/s, logits "
          f"{chaos_kernel['logit_err']:.3e}, SGD twin theta "
          f"{chaos_kernel['sgd_theta_err']:.3e}; a NaN client vs the same "
          f"client dropped, Δ sums {isolation['delta']:.3e} (f32), "
          f"{bf16_isolation['delta']:.3e} (bf16); straggler theta "
          f"{chaos_straggler['theta_err']:.3e}; serving under faults p50 "
          f"{chaos_serve['p50']:.4f} ms p95 {chaos_serve['p95']:.4f} ms, "
          f"{chaos_serve['rejected']} rejected; resume after SIGTERM theta "
          f"{chaos_ckpt['resume_err']:.3e}")
    print(f"[summary] observability: traced CLI run theta vs untraced "
          f"{obs_train['theta_err']:.3e}, profiler census "
          f"{obs_train['census']}, busy fraction under the profiler "
          f"{obs_train['summary']['device_busy_fraction']!r}, gaps p50 "
          f"{obs_train['summary']['gap_p50_us']!r} us; traced serve p50 "
          f"{obs_serve['p50']} ms p95 {obs_serve['p95']} ms (histogram) vs "
          f"{obs_serve['exact'][0.5]:.4f} / {obs_serve['exact'][0.95]:.4f} "
          f"ms exact, the profiler's serving census {obs_serve['census']}; "
          f"traced streamed round theta "
          f"{obs_streamed['theta_err']:.3e}")
    ctl = tools["tune-controller"]
    best = tools["tune"]["record"]
    print(f"[summary] tuning and the tools: tune winner {best['pins']} "
          f"(throughput_at_slo {best['score']['throughput_at_slo']} rps, p95 "
          f"{best['score']['p95_ms']} ms, SLO {best['key']['slo_ms']:g} ms); "
          f"serve --tuned logits max|card-cpu| "
          f"{tools['serve-tuned']['logit_err']:.3e}; controller scripted "
          f"{ctl['scripted']['totals']}, live {ctl['live']['totals']} "
          f"(logits {ctl['logit_err']:.3e}); train --tuned theta vs untuned "
          f"{tools['tune-cli']['theta_err']:.3e}; demo max|card-cpu| "
          f"{tools['demo']['err']:.3e}; bench history exit codes "
          f"{tools['bench-history']}")
    svp = mesh["sv-processes"]
    print(f"[summary] mesh: 2-slot round theta max|err| "
          f"{mesh['mesh-round']['theta_err']:.3e} (Adam logits "
          f"{mesh['mesh-round']['adam_logit_err']:.3e}); n=22 on 8 sv "
          f"slots <Z> vs dense {mesh['sv-sharded']['z_err']:.3e}, forward "
          f"{mesh['sv-sharded']['sharded_ms']:.4f} ms sharded vs "
          f"{mesh['sv-sharded']['dense_ms']:.4f} ms dense, round theta "
          f"{mesh['sv-sharded']['theta_err']:.3e}; sv trajectories logits "
          f"{mesh['sv-noise']['logit_err']:.3e}; sv-cli theta card vs cpu "
          f"{mesh['sv-cli']['theta_err']:.3e}; {mesh['distributed']['backend']}"
          " group of one rank: theta equal; sv group across processes: "
          + (f"{svp['world']} GPUs, <Z> {svp['z_err']:.3e} and round theta "
             f"{svp['theta_err']:.3e} vs lockstep" if svp["ran"] else
             "not run (one GPU)"))
    print(f"[summary] lint: {lint['delta']} in {lint['seconds']:.2f} s; "
          f"whole script {time.perf_counter() - T_START:.1f} s")
    print(card_line())
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

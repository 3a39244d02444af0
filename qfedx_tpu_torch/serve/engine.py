"""The serving engine: persistent forward over bucketed batches.

Counterpart of ``qfedx_tpu/serve/engine.py`` (``ServeConfig``,
``ServeEngine.warmup/infer/postprocess``). Its constraints, in order:

1. **No request pays a build.** Batch shapes are a small ordered set of
   BUCKETS; ``warmup()`` runs every bucket once — which builds and loads
   the scan-body kernel library and primes the matmul libraries — before
   traffic. The kernel loader's ``build_count`` must not rise after it
   (the port's form of the reference's zero-compile contract).
2. **Padding is invisible.** A batch of m requests padded to bucket b
   runs m real rows + (b−m) zero rows; every op is row-independent (one
   kernel CTA per sample), so the real rows equal the unpadded forward,
   and pad rows are sliced off before any post-processing.
3. **Transient device errors retry** under the shared seeded-jitter
   policy (``utils/retry``), the device→host fetch inside the attempt,
   and so does the ``serve.compute`` fault site (``utils/faults``: the
   engine's ``fault_plan`` or the plan ``QFEDX_FAULTS`` pins, read per
   attempt; the batch sequence is its round coordinate).

``engine_from_run_dir`` restores a tracked run directory (its
``config.json`` and newest last-good checkpoint, written by either
package) of any model family — the VQC, the TinyCNN (image requests),
the MPS classifier, the kernel head — into an engine; ``python -m
qfedx_tpu_torch serve --run-dir`` (``run/cli.py``) serves it.

Telemetry (``obs``, the reference's names): ``warmup`` brings up the
/metrics endpoint (``QFEDX_METRICS_PORT``) and the watchdog
(``QFEDX_WATCH``) and records a flight lifecycle edge; the spans
``serve.warmup``, ``serve.pad``, ``serve.compute`` and ``serve.fetch``
(nested in ``serve.compute``: the device→host copy, the one place a
batch waits for the card) and the counters ``serve.warmup_buckets``,
``serve.compute_retries``, ``serve.batches`` and
``serve.requests_served``. With ``QFEDX_TUNE`` on, ``warmup`` attaches
the tune controller (``tune/controller.py``) as ``ServeEngine.tuner``
and starts its ticker once every bucket is warm; the batcher reads the
active deadline and bucket cap from it. With the pin off ``tuner`` stays
None: no controller object, no thread, no ``tune.*`` instrument.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch

from qfedx_tpu_torch import obs
from qfedx_tpu_torch.serve.forward import _ROUTING_PINS, persistent_forward
from qfedx_tpu_torch.utils import faults, pins, trees
from qfedx_tpu_torch.utils.retry import retry_with_deadline


@dataclass(frozen=True)
class ServeConfig:
    """Serving knobs. ``resolve()`` fills unset fields from the
    QFEDX_SERVE_* pins (explicit arguments > pins > defaults)."""

    # Ascending batch shapes warmed at startup; a request batch pads up
    # to the smallest bucket that fits. The largest is the batch cap.
    buckets: tuple[int, ...] = (1, 8, 32)
    # A queued request waits at most this long for its bucket to fill.
    deadline_ms: float = 5.0
    # Bounded admission queue: submissions past this depth are shed.
    max_queue: int = 256
    # Stated SLO for the p95 request latency.
    slo_ms: float = 50.0

    def __post_init__(self):
        if not self.buckets:
            raise ValueError("buckets must be non-empty")
        if any(b < 1 for b in self.buckets):
            raise ValueError(f"bucket sizes must be >= 1, got {self.buckets}")
        if tuple(sorted(set(self.buckets))) != tuple(self.buckets):
            raise ValueError(
                f"buckets must be strictly ascending, got {self.buckets}"
            )
        if not self.deadline_ms > 0:
            raise ValueError(f"deadline_ms={self.deadline_ms} must be > 0")
        if self.max_queue < 1:
            raise ValueError(f"max_queue={self.max_queue} must be >= 1")
        if not self.slo_ms > 0:
            raise ValueError(f"slo_ms={self.slo_ms} must be > 0")

    @classmethod
    def resolve(
        cls,
        buckets: tuple[int, ...] | None = None,
        deadline_ms: float | None = None,
        max_queue: int | None = None,
        slo_ms: float | None = None,
    ) -> "ServeConfig":
        return cls(
            buckets=(
                tuple(buckets) if buckets is not None
                else pins.int_list_pin("QFEDX_SERVE_BUCKETS", cls.buckets)
            ),
            deadline_ms=(
                deadline_ms if deadline_ms is not None
                else pins.float_pin("QFEDX_SERVE_DEADLINE_MS", cls.deadline_ms)
            ),
            max_queue=(
                max_queue if max_queue is not None
                else pins.int_pin("QFEDX_SERVE_QUEUE", cls.max_queue)
            ),
            slo_ms=(
                slo_ms if slo_ms is not None
                else pins.float_pin("QFEDX_SERVE_SLO_MS", cls.slo_ms)
            ),
        )


class ServeEngine:
    """Persistent forward + bucketed padding + retried dispatch.

    ``model``: a ``models.api.Model``; ``params``: its parameter dict
    (moved to ``device``); ``feature_shape``: per-request feature shape,
    e.g. ``(n_qubits,)``. ``device=None`` means the card and raises
    without one. ``fault_plan``: the plan consulted at
    ``serve.compute`` and, by the batcher, ``serve.request`` (None: the
    one ``QFEDX_FAULTS`` pins). ``apply_fn`` overrides ``model.apply``
    — required for an sv-sharded model
    (``models.vqc_sharded.host_apply(model, mesh)``).
    """

    def __init__(
        self,
        model,
        params,
        feature_shape: tuple[int, ...],
        config: ServeConfig | None = None,
        device=None,
        fault_plan=None,
        apply_fn=None,
    ):
        if apply_fn is None and getattr(model, "sv_size", 1) > 1:
            raise ValueError(
                f"model {model.name} is sv-sharded; its bare apply has "
                "collectives that cannot run outside a shard_map — pass "
                "apply_fn=host_apply(model, mesh)"
            )
        self.device = pins.resolve_device(device)
        self.fault_plan = fault_plan
        self.model = model
        self.params = trees.tree_map(lambda v: v.to(self.device), params)
        self.feature_shape = tuple(int(s) for s in feature_shape)
        self.config = config or ServeConfig.resolve()
        self._fwd = persistent_forward(
            apply_fn if apply_fn is not None else model.apply)
        self._warm = False
        self._fetch = threading.local()  # serve.fetch meta while in infer
        # The adaptive controller seam (tune/controller.py): attached by
        # warmup() iff QFEDX_TUNE is on, read by the batcher per flush.
        # None (the default): the batcher reads the static config.
        self.tuner = None

    # -- buckets -------------------------------------------------------------

    @property
    def max_bucket(self) -> int:
        return self.config.buckets[-1]

    def bucket_for(self, m: int) -> int:
        """Smallest bucket that fits ``m`` rows."""
        for b in self.config.buckets:
            if m <= b:
                return b
        raise ValueError(
            f"batch of {m} exceeds the largest bucket "
            f"{self.max_bucket}; the batcher must split it"
        )

    def _forward(self, xb: np.ndarray) -> np.ndarray:
        """Logits of the padded batch ``xb`` on the host. Inside ``infer``
        the device→host copy runs in a ``serve.fetch`` span."""
        with torch.inference_mode():
            out = self._fwd(self.params, torch.as_tensor(xb, device=self.device))
            meta = getattr(self._fetch, "meta", None)
            if meta is None:
                return out.cpu().numpy()
            with obs.span("serve.fetch", **meta):
                return out.cpu().numpy()

    # -- warmup --------------------------------------------------------------

    def warmup(self) -> dict[str, Any]:
        """Run every bucket once ahead of traffic (builds and loads the
        kernel library). Returns per-bucket wall seconds, the kernel
        builds this warmup caused, and the route it resolved."""
        from qfedx_tpu_torch.obs import flight, watch
        from qfedx_tpu_torch.obs import server as obs_server
        from qfedx_tpu_torch.ops import scan_body
        from qfedx_tpu_torch.ops.cpx import state_dtype

        # The serving stack's telemetry seam (each default off).
        obs_server.maybe_start()
        watch.maybe_start()
        flight.record(
            "lifecycle", "engine.warmup", buckets=str(self.config.buckets)
        )
        builds0 = scan_body.build_count
        per_bucket = {}
        for b in self.config.buckets:
            x = np.zeros((b,) + self.feature_shape, dtype=np.float32)
            with obs.span("serve.warmup", bucket=b) as sp:
                t0 = time.perf_counter()
                out = self._forward(x)
                wall = time.perf_counter() - t0
            per_bucket[b] = {"wall_s": wall, "compile_s": sp.compile_s}
            if not np.all(np.isfinite(out)):
                raise RuntimeError(
                    f"warmup forward at bucket {b} produced non-finite "
                    "logits — refusing to serve a broken checkpoint"
                )
        self._warm = True
        obs.counter("serve.warmup_buckets", len(per_bucket))
        # The tune controller attaches once every bucket it may pick is
        # warm, so a decision can never name a cold bucket. Default off:
        # maybe_controller returns None and nothing changes.
        from qfedx_tpu_torch import tune

        if self.tuner is None:
            self.tuner = tune.maybe_controller(self)
        if self.tuner is not None:
            self.tuner.maybe_start()
        return {
            "buckets": per_bucket,
            "num_classes": int(out.shape[-1]),
            "kernel_builds": scan_body.build_count - builds0,
            "route": {p: pins.str_pin(p, "") for p in _ROUTING_PINS},
            # The pins' route beside the engine the model runs: the
            # pins read fuse/scan/kernel on at every width, but below the
            # slab widths the "vmap" engine runs none of them.
            "route_resolved": {
                "dtype": str(state_dtype()).replace("torch.", ""),
                "device": str(self.device),
                "engine": (self.model.engine() if self.model.engine
                           else None),
                **scan_body.resolved_route(),
            },
        }

    # -- inference -----------------------------------------------------------

    def infer(self, x: np.ndarray, seq: int = 0) -> np.ndarray:
        """Logits for ``x`` [m, *feature_shape], m ≤ max bucket: pad to
        the bucket, dispatch (retrying transient errors, fetch included),
        slice the pad rows off."""
        x = np.asarray(x, dtype=np.float32)
        m = x.shape[0]
        bucket = self.bucket_for(m)
        with obs.span("serve.pad", batch=m, bucket=bucket):
            if m < bucket:
                xb = np.zeros((bucket,) + x.shape[1:], dtype=x.dtype)
                xb[:m] = x
            else:
                xb = x

        def attempt(k: int):
            if k > 0:
                obs.counter("serve.compute_retries")
            plan = faults.resolve_plan(self.fault_plan)
            if plan is not None:
                plan.check("serve.compute", seq, attempt=k)
            return self._forward(xb)

        self._fetch.meta = {"batch": m}
        try:
            with obs.span("serve.compute", batch=m, bucket=bucket, seq=seq):
                logits = retry_with_deadline(
                    attempt,
                    attempts=3,
                    base_delay_s=0.002,
                    max_delay_s=0.05,
                    deadline_s=5.0,
                    describe=f"serve compute (batch {seq})",
                    jitter_site=f"serve/{seq}",
                )
        finally:
            self._fetch.meta = None
        obs.counter("serve.batches")
        obs.counter("serve.requests_served", m)
        return logits[:m]

    def postprocess(self, logits: np.ndarray) -> dict[str, np.ndarray]:
        """Softmax probabilities + predicted class for REAL rows only."""
        z = logits - logits.max(axis=-1, keepdims=True)
        ez = np.exp(z)
        probs = ez / ez.sum(axis=-1, keepdims=True)
        return {"probs": probs, "pred": logits.argmax(axis=-1)}


# -- checkpoint restore ------------------------------------------------------


def infer_num_classes(cfg) -> int:
    """num_classes implied by an ExperimentConfig without touching data:
    an explicit class subset wins, else the dataset's full class count."""
    from qfedx_tpu_torch.data.datasets import SPECS

    if cfg.data.classes is not None:
        return len(cfg.data.classes)
    return SPECS[cfg.data.dataset].num_classes


def feature_shape_for(cfg) -> tuple[int, ...]:
    """Per-request feature shape implied by an ExperimentConfig, as
    ``run/config.build_data`` shapes the features: 2^n amplitudes for
    the amplitude-encoded VQC, the image for the CNN, else one feature
    per qubit (angle and reupload)."""
    from qfedx_tpu_torch.data.datasets import SPECS

    m = cfg.model
    if m.model == "cnn":
        spec = SPECS[cfg.data.dataset]
        if spec.channels == 1:
            return (spec.height, spec.width)
        return (spec.height, spec.width, spec.channels)
    if m.model == "vqc" and m.encoding == "amplitude":
        return (1 << m.n_qubits,)
    return (m.n_qubits,)


def engine_from_run_dir(
    run_dir: str | os.PathLike,
    round_idx: int | None = None,
    config: ServeConfig | None = None,
    device=None,
) -> tuple[ServeEngine, dict[str, Any]]:
    """Restore a trained run into a ServeEngine on ``device`` (None = the
    card): the model from the run's ``config.json``, the parameters from
    checkpoint ``round_idx`` (or the newest last-good one). Returns the
    engine and an info dict (restored round, model and run metadata)."""
    from qfedx_tpu_torch.run.checkpoint import Checkpointer
    from qfedx_tpu_torch.run.config import (
        build_model,
        experiment_config_from_dict,
    )

    run_dir = Path(run_dir)
    cfg_path = run_dir / "config.json"
    if not cfg_path.exists():
        raise FileNotFoundError(
            f"{cfg_path} not found — serve needs a tracked run directory "
            "(one written by ExperimentRun / the train subcommand)"
        )
    exp = experiment_config_from_dict(json.loads(cfg_path.read_text()))
    num_classes = infer_num_classes(exp)
    model = build_model(exp, num_classes, device=device)
    if model.sv_size > 1:
        raise NotImplementedError(
            "serving sv-sharded models needs a mesh-wrapped forward; "
            "restore on a pod and pass apply_fn=host_apply(model, mesh)"
        )
    template = model.init(exp.seed)
    ckpt = Checkpointer(run_dir / "checkpoints", every=1)
    if round_idx is not None:
        params = ckpt.restore(round_idx, template)
        restored = round_idx
    else:
        got = ckpt.restore_latest(template)
        if got is None:
            raise FileNotFoundError(
                f"no checkpoints under {run_dir / 'checkpoints'} — train "
                "with --checkpoint-every, or pass --round to pick one"
            )
        params, restored = got
    engine = ServeEngine(
        model, params, feature_shape_for(exp), config=config, device=device
    )
    info = {
        "round": restored,
        "model": model.name,
        "num_classes": num_classes,
        "run_dir": str(run_dir),
    }
    return engine, info

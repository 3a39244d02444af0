"""Round-K checkpointing with resume.

Counterpart of ``qfedx_tpu/run/checkpoint.py``, in the SAME file format,
so a checkpoint written by either package restores in the other (with
``models/vqc.params_from_jax``, the way weights cross between them):

- ``ckpt_NNNNNN.npz``: the parameter leaves as ``arr_0 … arr_N`` in the
  order ``jax.tree_util.tree_flatten`` gives the reference's parameter
  dict — sorted keys, the order of ``utils/trees.tree_leaves``;
- ``ckpt_NNNNNN.sha256``: the npz's sha256, verified on restore;
- ``ckpt_NNNNNN.json``: ``{"round": r, "n_leaves": N}``.

Every write is tmp file + ``os.replace``, so a writer killed mid-write
never corrupts the latest checkpoint. ``restore_latest`` walks newest →
oldest and skips (with a warning) a checkpoint whose bytes fail their
sha256 or do not parse, falling back to the last good one; an explicit
``restore(round)`` raises ``CheckpointIntegrityError``. ``save_async``
queues a save on one background writer (one write in flight, one
queued; a third call blocks), which retries under the shared policy
(``utils/retry``) before a typed ``CheckpointWriteError``; ``wait()``
drains it and re-raises the first writer error.

The port runs in one process, so no decision is broadcast. The fault
harness's ``checkpoint.write`` site (``utils/faults``, the plan
``QFEDX_FAULTS`` pins) is consulted inside each retried attempt of the
background writer, so a transient injected failure recovers in place
and a persistent one is the ``CheckpointWriteError``.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import queue as queue_mod
import re
import threading
import time
import warnings
from pathlib import Path
from typing import Any

import numpy as np
import torch

from qfedx_tpu_torch.utils import faults, trees
from qfedx_tpu_torch.utils.retry import RetryExhausted, retry_with_deadline


class CheckpointIntegrityError(RuntimeError):
    """A checkpoint on disk does not match its sha256 sidecar, or cannot
    be parsed at all. ``restore_latest`` falls back past it; an explicit
    ``restore(round)`` raises it."""


class CheckpointWriteError(RuntimeError):
    """An async checkpoint write failed for good (the retry policy ran
    out). Carries the round and the ``original`` error (also chained as
    ``__cause__``)."""

    def __init__(self, round_idx: int, original: BaseException,
                 attempts: int):
        super().__init__(
            f"checkpoint write for round {round_idx} failed after "
            f"{attempts} attempt(s): {original!r}"
        )
        self.round_idx = round_idx
        self.original = original


def _host_leaf(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _sha256_of(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class Checkpointer:
    """Save params every ``every`` rounds to ``directory``; keep the last
    ``keep``. Restore validates the leaf count and shapes against a
    template parameter dict, so a checkpoint of another model config
    fails loudly. ``fault_plan``: the plan the async writer consults at
    ``checkpoint.write`` (None: the one ``QFEDX_FAULTS`` pins, read per
    attempt)."""

    _PAT = re.compile(r"ckpt_(\d{6})\.npz$")

    def __init__(self, directory: str | os.PathLike, every: int = 5,
                 keep: int = 3, fault_plan=None):
        if every < 1:
            raise ValueError("every must be ≥ 1")
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.every = every
        self.keep = keep
        self.fault_plan = fault_plan
        self._queue: queue_mod.Queue | None = None
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # -- save ----------------------------------------------------------------

    def save(self, round_idx: int, params: Any) -> Path:
        path = self.dir / f"ckpt_{round_idx:06d}.npz"
        host_leaves = [_host_leaf(x) for x in trees.tree_leaves(params)]
        # Serialised in memory, so the sha256 is of the very bytes
        # written (np.savez seeks back to patch zip headers).
        buf = io.BytesIO()
        np.savez(buf, *host_leaves)
        data = buf.getvalue()
        sha_hex = hashlib.sha256(data).hexdigest()
        tmp = path.with_suffix(".npz.tmp")
        with open(tmp, "wb") as f:
            f.write(data)
        # A re-save drops the old sidecar before the new npz lands: a
        # crash between the renames then leaves new bytes without a
        # sidecar (accepted), never new bytes with a stale hash.
        sha_path = path.with_suffix(".sha256")
        sha_path.unlink(missing_ok=True)
        os.replace(tmp, path)
        tmp_sha = sha_path.with_suffix(".sha256.tmp")
        tmp_sha.write_text(sha_hex + "\n")
        os.replace(tmp_sha, sha_path)
        meta = {"round": round_idx, "n_leaves": len(host_leaves)}
        meta_path = path.with_suffix(".json")
        tmp_meta = meta_path.with_suffix(".json.tmp")
        tmp_meta.write_text(json.dumps(meta))
        os.replace(tmp_meta, meta_path)
        self._gc()
        return path

    def maybe_save(self, round_idx: int, params: Any) -> Path | None:
        if round_idx % self.every == 0:
            return self.save(round_idx, params)
        return None

    # -- async save ----------------------------------------------------------

    def _writer_loop(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return  # shutdown sentinel (wait() retires the thread)
                round_idx, params = item

                def attempt(k: int, _r=round_idx, _p=params):
                    plan = faults.resolve_plan(self.fault_plan)
                    if plan is not None:
                        plan.check("checkpoint.write", _r, attempt=k)
                    return self.save(_r, _p)

                try:
                    retry_with_deadline(
                        attempt, attempts=3, base_delay_s=0.05,
                        max_delay_s=0.5, deadline_s=60.0,
                        describe=f"checkpoint write (round {round_idx})",
                        jitter_site=f"checkpoint/{round_idx}",
                    )
                except RetryExhausted as exc:
                    raise CheckpointWriteError(
                        round_idx, exc.last, exc.attempts
                    ) from exc.last
            except BaseException as e:  # noqa: BLE001 — surfaced by wait()
                if self._error is None:  # keep the FIRST (root-cause) error
                    self._error = e
            finally:
                self._queue.task_done()

    def save_async(self, round_idx: int, params: Any) -> None:
        """Queue ``save(round_idx, params)`` on the background writer
        (one write in flight + one queued; a third call blocks). A prior
        writer error is raised here. The caller must not modify
        ``params`` in place afterwards (the trainer's rounds make new
        tensors)."""
        self._raise_pending()
        if self._queue is None:
            self._queue = queue_mod.Queue(maxsize=1)
            self._thread = threading.Thread(
                target=self._writer_loop, name="qfedx-ckpt-writer",
                daemon=True,
            )
            self._thread.start()
        self._queue.put((round_idx, params))

    def busy(self) -> bool:
        """True while the background writer still has work in flight: a
        synchronous save after a timed-out ``wait`` must not race it over
        the same files."""
        q = self._queue
        return q is not None and q.unfinished_tasks > 0

    def maybe_save_async(self, round_idx: int, params: Any) -> bool:
        """``save_async`` on the every-K cadence; True if a save was queued."""
        if round_idx % self.every == 0:
            self.save_async(round_idx, params)
            return True
        return False

    def wait(
        self, raise_errors: bool = True, timeout: float | None = None
    ) -> BaseException | None:
        """Block until every queued write is on disk and retire the
        writer thread; re-raise the first writer error — or, with
        ``raise_errors=False`` (the crash-unwind path, where a new raise
        would mask the original), warn and RETURN it. ``timeout`` bounds
        the drain: on expiry a warning is given and the daemon writer is
        left running."""
        if self._queue is not None:
            if timeout is None:
                self._queue.join()
            else:
                deadline = time.monotonic() + timeout
                while (self._queue.unfinished_tasks
                       and time.monotonic() < deadline):
                    time.sleep(0.05)
                if self._queue.unfinished_tasks:
                    warnings.warn(
                        f"async checkpoint writer still busy after "
                        f"{timeout:.1f}s; leaving the daemon writer "
                        "behind — the latest on-disk checkpoint may be "
                        "stale",
                        RuntimeWarning,
                        stacklevel=2,
                    )
                    if raise_errors:
                        self._raise_pending()
                        return None
                    return self._pop_suppressed()
            self._queue.put(None)
            self._thread.join()
            self._queue = None
            self._thread = None
        if raise_errors:
            self._raise_pending()
            return None
        return self._pop_suppressed()

    def _pop_suppressed(self) -> BaseException | None:
        err, self._error = self._error, None
        if err is not None:
            warnings.warn(
                "async checkpoint write failed and was suppressed during "
                f"unwind: {err!r} — the latest on-disk checkpoint may "
                "predate the crash round",
                RuntimeWarning,
                stacklevel=3,
            )
        return err

    def _raise_pending(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        if self.keep <= 0:
            return
        for r in sorted(self._rounds())[: -self.keep]:
            for ext in ("npz", "json", "sha256"):
                (self.dir / f"ckpt_{r:06d}.{ext}").unlink(missing_ok=True)

    # -- restore -------------------------------------------------------------

    def _rounds(self) -> list[int]:
        if not self.dir.exists():
            return []
        out = []
        for p in self.dir.iterdir():
            m = self._PAT.search(p.name)
            if m:
                out.append(int(m.group(1)))
        return out

    def verify(self, round_idx: int) -> None:
        """Check round ``round_idx``'s npz against its sha256 sidecar;
        raises ``CheckpointIntegrityError`` on a mismatch or a missing
        file. A checkpoint without a sidecar passes (a torn one still
        fails to parse in ``_load_leaves``)."""
        path = self.dir / f"ckpt_{round_idx:06d}.npz"
        sha_path = self.dir / f"ckpt_{round_idx:06d}.sha256"
        if not path.exists():
            raise CheckpointIntegrityError(
                f"checkpoint round {round_idx}: {path.name} is missing"
            )
        if sha_path.exists():
            want = sha_path.read_text().strip()
            got = _sha256_of(path)
            if got != want:
                raise CheckpointIntegrityError(
                    f"checkpoint round {round_idx}: sha256 mismatch "
                    f"(disk {got[:12]}… != sidecar {want[:12]}…) — the "
                    "file is torn or corrupt"
                )

    def _load_leaves(self, round_idx: int, template_leaves) -> list:
        """Verify, load and check the leaves against the template's
        count and shapes; a parse failure is a CheckpointIntegrityError."""
        path = self.dir / f"ckpt_{round_idx:06d}.npz"
        self.verify(round_idx)
        try:
            with np.load(path) as data:
                loaded = [data[f"arr_{i}"] for i in range(len(data.files))]
        except Exception as exc:  # torn/garbage npz — zipfile/pickle errors
            raise CheckpointIntegrityError(
                f"checkpoint round {round_idx}: unreadable npz "
                f"({type(exc).__name__}: {exc})"
            ) from exc
        if len(loaded) != len(template_leaves):
            raise ValueError(
                f"checkpoint has {len(loaded)} leaves, template has "
                f"{len(template_leaves)}"
            )
        for i, (got, want) in enumerate(zip(loaded, template_leaves)):
            if tuple(got.shape) != tuple(want.shape):
                raise ValueError(
                    f"leaf {i}: checkpoint shape {got.shape} != model "
                    f"{tuple(want.shape)}"
                )
        return loaded

    @staticmethod
    def _to_template(template: Any, loaded: list) -> Any:
        """The loaded arrays as tensors in ``template``'s structure, each
        on its template leaf's device."""
        it = iter(loaded)
        return trees.tree_map(
            lambda t: torch.as_tensor(next(it), device=t.device), template
        )

    def restore(self, round_idx: int, template: Any) -> Any:
        """Round ``round_idx`` in the structure of ``template``; the
        sha256 is verified first and a mismatch raises."""
        loaded = self._load_leaves(round_idx, trees.tree_leaves(template))
        return self._to_template(template, loaded)

    def restore_latest(self, template: Any) -> tuple[Any, int] | None:
        """(params, round) of the newest LAST-GOOD checkpoint, or None:
        a checkpoint that fails its sha256 or does not parse is warned
        about and skipped (``keep`` ≥ 2 keeps the fallback)."""
        leaves = trees.tree_leaves(template)
        for cand in sorted(self._rounds(), reverse=True):
            try:
                loaded = self._load_leaves(cand, leaves)
            except CheckpointIntegrityError as exc:
                warnings.warn(
                    f"skipping corrupt checkpoint (round {cand}): {exc} — "
                    "falling back to the previous last-good checkpoint",
                    RuntimeWarning,
                    stacklevel=2,
                )
                continue
            return self._to_template(template, loaded), cand
        return None

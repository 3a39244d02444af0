"""Model evaluation: accuracy and AUC.

Counterpart of ``qfedx_tpu/fed/evaluate.py``: batch-256 forwards over
padded batches (every batch has the same shape, so on the card every
evaluation sweep is one Launch A of the scan-body kernel at tb = 256),
no gradients, accuracy and the binary AUC computed on the host from the
logits. The result has the reference's keys: ``accuracy``, ``n`` and,
for two classes, ``auc``.
"""

from __future__ import annotations

import numpy as np
import torch

from qfedx_tpu_torch.models.api import Model
from qfedx_tpu_torch.serve.forward import persistent_forward


def make_evaluator(model: Model, batch_size: int = 256, apply_fn=None,
                   max_batches: int | None = None):
    """Return ``evaluate(params, x, y) -> dict``. ``apply_fn`` overrides
    ``model.apply`` — required for sv-sharded models (``model.sv_size >
    1``), whose bare apply runs only inside an sv group
    (``models.vqc_sharded.host_apply``). ``max_batches`` caps per-call
    work: metrics come from the first ``max_batches·batch_size``
    examples and ``n`` reports the subset."""
    if apply_fn is None and model.sv_size > 1:
        raise ValueError(
            f"model {model.name} is sv-sharded; pass apply_fn="
            "host_apply(model, mesh) (its bare apply has sv collectives "
            "that cannot be jitted outside a shard_map)"
        )
    # One shared forward per model, with the serving engine's
    # (serve/forward.py).
    batch_logits = persistent_forward(
        apply_fn if apply_fn is not None else model.apply)

    def evaluate(params, x, y):
        x = np.asarray(x, dtype=np.float32)
        y = np.asarray(y)
        if max_batches is not None and len(x) > max_batches * batch_size:
            x = x[: max_batches * batch_size]
            y = y[: max_batches * batch_size]
        n = len(x)
        pad = (-n) % batch_size
        if pad:
            x = np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)])
        logits = []
        with torch.inference_mode():
            for i in range(0, len(x), batch_size):
                out = batch_logits(params, x[i: i + batch_size])
                logits.append(out.cpu().numpy())
        logits = np.concatenate(logits)[:n]
        pred = logits.argmax(axis=-1)
        acc = float((pred == y).mean()) if n else 0.0
        out = {"accuracy": acc, "n": n}
        if logits.shape[-1] == 2:
            out["auc"] = binary_auc(y, logits[:, 1] - logits[:, 0])
        return out

    return evaluate


def binary_auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """ROC AUC via the rank-sum (Mann–Whitney U) formulation, with tie
    handling by average ranks. Pure numpy."""
    labels = np.asarray(labels).astype(bool)
    n_pos = int(labels.sum())
    n_neg = len(labels) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(len(scores), dtype=np.float64)
    sorted_scores = scores[order]
    i = 0
    while i < len(scores):
        j = i
        while j + 1 < len(scores) and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        ranks[order[i: j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    rank_sum_pos = ranks[labels].sum()
    u = rank_sum_pos - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))

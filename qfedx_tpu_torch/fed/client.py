"""Local client training, client-folded.

Counterpart of ``qfedx_tpu/fed/client.py``'s ``make_optimizer`` and
``make_local_update_clients``. The C clients of a round train together:
their parameter trees carry a leading client axis, the model's
``apply_clients`` runs every client's batch as one (C·B, 2^n) slab with
per-client coefficient groups (through the scan-body kernel on the
card), and the loss is Σ_c mean-CE_c — each client's gradient lands in
its own parameter slice. E epochs of shuffled batches; returns each
client's wrapped update Δθ, its sample count and its mean epoch loss.

The optimizers are explicit, functional, per-client update rules that
reproduce ``optax.adam(lr)`` and ``optax.sgd(lr, momentum)`` step for
step (``torch.optim`` is not used). Shuffles come from the caller: a
``torch.Generator`` draws each client's per-epoch permutation, or an
explicit (C, E, S) ``perms`` tensor gives them (the parity tests inject
the permutations the reference drew from its key stream).

Not ported yet (the reference's vmap client path): SPSA and per-example
DP, which raise NotImplementedError.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from qfedx_tpu_torch.fed.config import FedConfig
from qfedx_tpu_torch.models.api import Model
from qfedx_tpu_torch.utils import trees

_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


class Optimizer(NamedTuple):
    """``init(params) -> state``; ``update(grads, state) -> (updates,
    state)``; updates are added to the parameters."""

    init: Callable
    update: Callable


def make_optimizer(cfg: FedConfig) -> Optimizer:
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0, bias
    correction 1 − b^count in f32) or ``optax.sgd(lr, momentum=m or
    None)`` (trace t = g + m·t, update −lr·t)."""
    lr = cfg.learning_rate
    if cfg.optimizer == "adam":
        b1, b2, eps = _ADAM_B1, _ADAM_B2, _ADAM_EPS

        def init(params):
            zeros = trees.tree_map(torch.zeros_like, params)
            device = trees.tree_leaves(params)[0].device
            return {"count": torch.zeros((), dtype=torch.int32,
                                         device=device),
                    "mu": zeros, "nu": trees.tree_map(torch.zeros_like,
                                                      params)}

        def update(grads, state):
            mu = trees.tree_map(lambda g, t: (1 - b1) * g + b1 * t,
                                grads, state["mu"])
            nu = trees.tree_map(lambda g, t: (1 - b2) * g**2 + b2 * t,
                                grads, state["nu"])
            count = state["count"] + 1
            c1 = 1 - b1 ** count.float()
            c2 = 1 - b2 ** count.float()
            updates = trees.tree_map(
                lambda m, v: -lr * ((m / c1) / (torch.sqrt(v / c2) + eps)),
                mu, nu,
            )
            return updates, {"count": count, "mu": mu, "nu": nu}

        return Optimizer(init, update)

    momentum = cfg.momentum or None

    def init(params):
        if momentum is None:
            return {}
        return {"trace": trees.tree_map(torch.zeros_like, params)}

    def update(grads, state):
        if momentum is None:
            return trees.tree_map(lambda g: -lr * g, grads), state
        trace = trees.tree_map(lambda g, t: g + momentum * t, grads,
                               state["trace"])
        return trees.tree_map(lambda t: -lr * t, trace), {"trace": trace}

    return Optimizer(init, update)


def _cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                   ) -> torch.Tensor:
    """optax.softmax_cross_entropy_with_integer_labels."""
    picked = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - picked


def draw_perms(generator: torch.Generator, clients: int, epochs: int,
               samples: int) -> torch.Tensor:
    """(C, E, S) int64: client c's permutation for epoch e, drawn in
    (client, epoch) order from ``generator``."""
    return torch.stack([
        torch.stack([torch.randperm(samples, generator=generator)
                     for _ in range(epochs)])
        for _ in range(clients)
    ])


def make_local_update_clients(model: Model, cfg: FedConfig) -> Callable:
    """Build ``local_update_c(global_params, x, y, mask, generator=None,
    perms=None)``: x [C, S, ...], y [C, S], mask [C, S] → (delta,
    n_samples, mean_loss), each with leading client axis C. Exactly one
    of ``generator``/``perms`` gives the shuffles."""
    if cfg.optimizer == "spsa" or (
        cfg.dp is not None and cfg.dp.mode == "example"
    ):
        raise NotImplementedError(
            "SPSA and per-example DP run on the vmap client path, which "
            "is not ported yet"
        )
    if model.apply_clients is None:
        raise NotImplementedError(
            f"model {model.name} has no apply_clients; the vmap client "
            "path is not ported yet"
        )
    tx = make_optimizer(cfg)

    def loss_fn(cparams, global_params, xb, yb, mb):
        logits = model.apply_clients(cparams, xb)  # (C, Bb, K)
        ce = _cross_entropy(logits, yb)
        loss_c = torch.sum(ce * mb, dim=1) / torch.clamp(
            torch.sum(mb, dim=1), min=1.0
        )
        if cfg.algorithm == "fedprox":
            # Per-client proximal term: ‖θ_c − θ_global‖² over every
            # leaf's non-client axes.
            prox = sum(
                torch.sum(torch.square(cp - gp),
                          dim=tuple(range(1, cp.ndim)))
                for cp, gp in zip(trees.tree_leaves(cparams),
                                  trees.tree_leaves(global_params))
            )
            loss_c = loss_c + 0.5 * cfg.prox_mu * prox
        return loss_c

    def local_update_c(global_params, x, y, mask, generator=None,
                       perms=None):
        c, s = x.shape[0], x.shape[1]
        if s % cfg.batch_size != 0:
            raise ValueError(
                f"padded client size {s} not a multiple of batch "
                f"{cfg.batch_size}"
            )
        if (generator is None) == (perms is None):
            raise ValueError("pass exactly one of generator and perms")
        if perms is None:
            perms = draw_perms(generator, c, cfg.local_epochs, s)
        perms = torch.as_tensor(perms, dtype=torch.int64, device=x.device)
        if tuple(perms.shape) != (c, cfg.local_epochs, s):
            raise ValueError(
                f"perms of shape {tuple(perms.shape)}, expected "
                f"{(c, cfg.local_epochs, s)}"
            )
        n_batches = s // cfg.batch_size
        rows = torch.arange(c, device=x.device)[:, None]
        cparams = trees.tree_map(
            lambda p: p[None].expand((c,) + tuple(p.shape)).clone(),
            global_params,
        )
        opt_state = tx.init(cparams)
        epoch_losses = []
        for e in range(cfg.local_epochs):
            perm = perms[:, e]

            def shuffle(a):  # (C, S, ...) → (C, nb, Bb, ...)
                g = a[rows, perm]
                return g.reshape((c, n_batches, cfg.batch_size)
                                 + tuple(a.shape[2:]))

            xs, ys, ms = shuffle(x), shuffle(y), shuffle(mask)
            losses = []
            for b in range(n_batches):
                leaves = trees.tree_map(
                    lambda p: p.detach().requires_grad_(True), cparams
                )
                with torch.enable_grad():
                    loss_c = loss_fn(leaves, global_params, xs[:, b],
                                     ys[:, b], ms[:, b])
                    flat = trees.tree_leaves(leaves)
                    grads = torch.autograd.grad(loss_c.sum(), flat)
                with torch.no_grad():
                    it = iter(grads)
                    grads = trees.tree_map(lambda _: next(it), leaves)
                    updates, opt_state = tx.update(grads, opt_state)
                    cparams = trees.tree_add(
                        trees.tree_map(torch.Tensor.detach, leaves), updates
                    )
                losses.append(loss_c.detach())
            epoch_losses.append(torch.stack(losses).mean(dim=0))
        with torch.no_grad():
            # (C, …) − (…) broadcasts the global leaf over the clients.
            delta = model.wrap_delta(trees.tree_sub(cparams, global_params))
        return delta, torch.sum(mask, dim=1), torch.stack(
            epoch_losses).mean(dim=0)

    return local_update_c

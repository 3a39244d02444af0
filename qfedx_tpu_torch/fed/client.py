"""Local client training: folded (all clients at once) and one client.

Counterpart of ``qfedx_tpu/fed/client.py``: ``make_optimizer``,
``make_spsa_grad``, the per-example DP-SGD gradient
(``_make_dp_example_grad``), ``make_local_update`` (one client) and
``make_local_update_clients`` (client-folded). In the folded form the C
clients of a round train together: their parameter trees carry a
leading client axis, the model's ``apply_clients`` runs every client's
batch as one (C·B, 2^n) slab with per-client coefficient groups
(through the scan-body kernel on the card), and the loss is Σ_c
mean-CE_c, so each client's gradient lands in its own parameter slice.
E epochs of shuffled batches; each returns the wrapped update Δθ, the
sample count and the mean epoch loss.

Three gradient routes, on either form:

- the plain gradient (torch autograd: Launches B and C on the card);
- SPSA: the loss at θ ± cΔ with a Rademacher Δ, forward only (under
  ``torch.no_grad``, so Launch A on the card); folded, θ_c + cΔ_c and
  θ_c − cΔ_c run as the 2C client groups of one forward;
- per-example DP-SGD: every example's gradient clipped to C, summed,
  one N(0, σ²C²I) draw added per local step, divided by the static lot
  B. Folded, the C·B examples run as C·B groups of one sample each with
  θ broadcast, so one forward and one backward give every per-example
  gradient; one client alone loops over its examples.

Folded SPSA and per-example DP split their groups into forwards of at
most 32 (``apply_groups``), the most a stacked program hands the kernel.

The reference keeps SPSA and per-example DP on its vmap path because
their PRNG keys live inside the traced estimator. The port's random
trees come from outside (``step_draws``: SPSA's Δ or the DP noise, one
tree per local step, drawn by ``fed/round.RoundDraws`` or injected by
the parity tests), so nothing forces the unfolded path.

The optimizers are explicit, functional, per-client update rules that
reproduce ``optax.adam(lr)`` and ``optax.sgd(lr, momentum)`` step for
step (``torch.optim`` is not used); SPSA updates like SGD. Shuffles come
from the caller: a ``torch.Generator`` draws each client's per-epoch
permutation, or an explicit (C, E, S) ``perms`` tensor gives them (the
parity tests inject the permutations the reference drew).

A model with ``apply_train`` (the TinyCNN's dropout, the VQC's finite
shots and Kraus trajectories) trains through it on every route of the
one-client update, with the step's draws from ``train_draws`` (a dict of
the model's ``StepDraw`` streams, each (E·S/B, B, …): one (B, …) draw
per local step; SPSA's θ ± cΔ share it, as the reference's two
evaluations share their key, and per-example DP hands example i its
row, as the reference hands it its own key). Such models never fold
(``fed/round.fold_clients_enabled``). A parameter the loss does not
reach (the ansatz under finite shots, whose counts carry no gradient in
either package) gets a zero gradient.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from qfedx_tpu_torch.fed.config import FedConfig
from qfedx_tpu_torch.fed.privacy import (
    batched_global_norm,
    clip_factor,
    lead_scale,
)
from qfedx_tpu_torch.models.api import Model
from qfedx_tpu_torch.ops.fuse import _ROWMAT_GROUP_MAX
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
        torch.stack([torch.randperm(samples, generator=generator)  # qfedx: ignore[QFX006] the shuffle stream: drawn from the caller's seeded round generator in (client, epoch) order, the reference's; RoundDraws covers every stream but the shuffles and the masks
                     for _ in range(epochs)])
        for _ in range(clients)
    ])


def _forward(model: Model, params, xb, db):
    """``model.apply_train`` with the step's draws ``db`` where the model
    has one, else ``model.apply``."""
    if model.apply_train is None:
        return model.apply(params, xb)
    return model.apply_train(params, xb, db)


def _grads(loss: torch.Tensor, leaves: list) -> list:
    """∂loss/∂leaves; a leaf the loss does not reach gets zeros."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def _unflatten(leaves_like, flat) -> dict:
    it = iter(flat)
    return trees.tree_map(lambda _: next(it), leaves_like)


def apply_groups(model: Model, cparams, x) -> torch.Tensor:
    """``model.apply_clients`` over G groups, on the batched engine in
    chunks of at most ``_ROWMAT_GROUP_MAX`` groups: a stacked program of
    more groups keeps a per-group ``g1`` that the kernel does not take
    (``scan_body.route_ok``), so SPSA's 2C and per-example DP's C·B
    groups reach the kernel at any count, as the reference's vmapped
    per-client and per-example forwards do."""
    g = x.shape[0]
    batched = model.engine is not None and model.engine() == "batched"
    if not batched or g <= _ROWMAT_GROUP_MAX:
        return model.apply_clients(cparams, x)
    return torch.cat([
        model.apply_clients(
            trees.tree_map(lambda p: p[i:i + _ROWMAT_GROUP_MAX], cparams),
            x[i:i + _ROWMAT_GROUP_MAX])
        for i in range(0, g, _ROWMAT_GROUP_MAX)])


def make_spsa_grad(loss_fn: Callable, c: float, folded: bool = False
                   ) -> Callable:
    """SPSA: ĝ = [L(θ+cΔ) − L(θ−cΔ)] / (2c) · Δ with a Rademacher Δ
    (Δ⁻¹ = Δ). ``spsa_grad(params, global_params, xb, yb, mb, delta)``
    returns ((L₊+L₋)/2, ĝ); ``loss_fn`` is the route's loss and ``db``
    the step's ``apply_train`` draws, shared by both evaluations. Folded (per-client
    (C, …) leaves), θ ± cΔ run as the 2C client groups of one forward;
    forward only either way."""

    def spsa_grad(params, global_params, xb, yb, mb, delta, db=None):
        plus = trees.tree_map(lambda p, d: p + c * d, params, delta)
        minus = trees.tree_map(lambda p, d: p - c * d, params, delta)
        with torch.no_grad():
            if folded:
                both = trees.tree_map(lambda a, b: torch.cat([a, b]), plus,
                                      minus)
                lp, lm = loss_fn(both, global_params,
                                 *(torch.cat([a, a]) for a in (xb, yb, mb))
                                 ).chunk(2)
            else:
                # Draws only reach a loss that takes them.
                batch = (xb, yb, mb) if db is None else (xb, yb, mb, db)
                lp = loss_fn(plus, global_params, *batch)
                lm = loss_fn(minus, global_params, *batch)
        return (lp + lm) / 2.0, lead_scale(delta, (lp - lm) / (2.0 * c))

    return spsa_grad


def _dp_noised_mean(ex_grads, mb, noise, dp, lot: int):
    """(Σ_i min(1, C/max(‖g_i‖, 1e-12))·m_i·g_i + σC·z) / lot, the
    example axis being ``mb``'s last: ``ex_grads`` leaves (…, B, *shape),
    ``mb`` (…, B), ``noise`` leaves (…, *shape)."""
    k = mb.ndim
    factor = clip_factor(batched_global_norm(ex_grads, k), dp.clip_norm) * mb
    scale = dp.noise_multiplier * dp.clip_norm
    return trees.tree_map(
        lambda g, z: (torch.sum(g, dim=k - 1) + scale * z) / float(lot),
        lead_scale(ex_grads, factor), noise,
    )


def _make_dp_example_grad(model: Model, cfg: FedConfig, folded: bool
                          ) -> Callable:
    """Per-example DP-SGD gradient (BASELINE.md config 2), the Abadi et
    al. estimator with lot size B:

        g̃ = ( Σ_i min(1, C/max(‖g_i‖, 1e-12))·m_i·g_i + N(0, σ²C²I) ) / B

    with one noise tree per local step (``noise``). Padded examples
    (m_i = 0) contribute nothing, and B stays the static batch size, so
    padding never changes the noise scale. The FedProx gradient
    μ(θ − θ_global) is added outside the clipped sum. Returns the
    masked mean example loss and g̃."""
    dp = cfg.dp
    lot = cfg.batch_size

    def folded_grads(cparams, xb, yb):
        # C·B groups of one sample each, θ_c broadcast over its B
        # examples: the gradient of Σ CE by group is every example's own.
        c, b = xb.shape[0], xb.shape[1]
        leaves = trees.tree_map(
            lambda p: p[:, None].expand((c, b) + tuple(p.shape[1:]))
            .reshape((c * b,) + tuple(p.shape[1:])).detach()
            .requires_grad_(True), cparams)
        with torch.enable_grad():
            logits = apply_groups(
                model, leaves, xb.reshape((c * b, 1) + tuple(xb.shape[2:])))
            ce = _cross_entropy(logits[:, 0], yb.reshape(c * b))
            grads = torch.autograd.grad(ce.sum(), trees.tree_leaves(leaves))
        grads = [g.reshape((c, b) + tuple(g.shape[1:])) for g in grads]
        return ce.detach().reshape(c, b), _unflatten(cparams, grads)

    def client_grads(params, xb, yb, db):
        # One client alone: one forward and backward per example.
        losses, per_ex = [], []
        for i in range(xb.shape[0]):
            leaves = trees.tree_map(
                lambda p: p.detach().requires_grad_(True), params)
            with torch.enable_grad():
                logits = _forward(model, leaves, xb[i:i + 1],
                                  None if db is None
                                  else {k: v[i:i + 1] for k, v in db.items()})
                ce = _cross_entropy(logits, yb[i:i + 1])[0]
                per_ex.append(_grads(ce, trees.tree_leaves(leaves)))
            losses.append(ce.detach())
        grads = [torch.stack(g) for g in zip(*per_ex)]
        return torch.stack(losses), _unflatten(params, grads)

    def grad_fn(params, global_params, xb, yb, mb, noise, db=None):
        if folded:
            losses, ex_grads = folded_grads(params, xb, yb)
        else:
            losses, ex_grads = client_grads(params, xb, yb, db)
        with torch.no_grad():
            g = _dp_noised_mean(ex_grads, mb, noise, dp, lot)
            if cfg.algorithm == "fedprox":
                g = trees.tree_map(
                    lambda gi, p, gp: gi + cfg.prox_mu * (p - gp),
                    g, params, global_params)
            loss = torch.sum(losses * mb, dim=-1) / torch.clamp(
                torch.sum(mb, dim=-1), min=1.0)
        return loss, g

    return grad_fn


def _autograd_grad(loss_fn: Callable) -> Callable:
    """``jax.value_and_grad`` of ``loss_fn``; a per-client loss (C,) is
    summed, so each client's gradient lands in its own slice."""

    def grad_fn(params, global_params, xb, yb, mb, _draw=None, db=None):
        leaves = trees.tree_map(lambda p: p.detach().requires_grad_(True),
                                params)
        with torch.enable_grad():
            loss = loss_fn(leaves, global_params, xb, yb, mb, db)
            grads = _grads(loss.sum(), trees.tree_leaves(leaves))
        return loss.detach(), _unflatten(leaves, grads)

    return grad_fn


def _grad_route(model: Model, cfg: FedConfig, loss_fn: Callable,
                folded: bool) -> tuple[Callable, bool]:
    """The config's gradient estimator and whether it takes a random tree
    per local step."""
    if cfg.dp is not None and cfg.dp.mode == "example":
        return _make_dp_example_grad(model, cfg, folded), True
    if cfg.optimizer == "spsa":
        return make_spsa_grad(loss_fn, cfg.spsa_c, folded), True
    return _autograd_grad(loss_fn), False


def _local_steps(tx: Optimizer, grad_fn: Callable, params, global_params,
                 batches, draw_at: Callable, n_batches: int):
    """Run the local steps ``batches`` yields in order (E epochs of
    ``n_batches``; each step's batch, mask and draws or None);
    returns the final parameters and the mean over epochs of each
    epoch's mean step loss."""
    opt_state = tx.init(params)
    losses = []
    for t, (xb, yb, mb, db) in enumerate(batches):
        loss, grads = grad_fn(params, global_params, xb, yb, mb, draw_at(t),
                              db)
        with torch.no_grad():
            updates, opt_state = tx.update(grads, opt_state)
            params = trees.tree_add(
                trees.tree_map(torch.Tensor.detach, params), updates)
        losses.append(loss)
    per_epoch = torch.stack(losses).reshape(
        (-1, n_batches) + tuple(losses[0].shape)).mean(dim=1)
    return params, per_epoch.mean(dim=0)


def _check_steps(cfg: FedConfig, s: int, needs_draws: bool, step_draws):
    if s % cfg.batch_size != 0:
        raise ValueError(
            f"padded client size {s} not a multiple of batch "
            f"{cfg.batch_size}"
        )
    if needs_draws and step_draws is None:
        raise ValueError("SPSA and per-example DP need step_draws (one "
                         "random tree per local step)")


def make_local_update(model: Model, cfg: FedConfig) -> Callable:
    """Build ``local_update(global_params, x, y, mask, perms,
    step_draws=None, train_draws=None)`` for ONE client: x [S, ...], y
    [S], mask [S], perms (E, S) → (delta, n_samples, mean_loss).
    ``step_draws``: a tree of (E·S/B, …) leaves, the random tree of each
    local step (SPSA's Δ, per-example DP's noise). ``train_draws``: a dict
    of the model's ``train_draws`` streams, each (E·S/B, B, *shape), each
    step's draws, required by a model with ``apply_train``. Runs ``model.apply`` (or ``apply_train``), so it
    serves models without ``apply_clients``, models with
    ``apply_train`` and ``QFEDX_FOLD_CLIENTS=0``."""
    tx = make_optimizer(cfg)

    def loss_fn(params, global_params, xb, yb, mb, db=None):
        ce = _cross_entropy(_forward(model, params, xb, db), yb)
        loss = torch.sum(ce * mb) / torch.clamp(torch.sum(mb), min=1.0)
        if cfg.algorithm == "fedprox":
            loss = loss + 0.5 * cfg.prox_mu * trees.global_norm_sq(
                trees.tree_sub(params, global_params))
        return loss

    grad_fn, needs_draws = _grad_route(model, cfg, loss_fn, folded=False)

    def local_update(global_params, x, y, mask, perms, step_draws=None,
                     train_draws=None):
        s = x.shape[0]
        _check_steps(cfg, s, needs_draws, step_draws)
        if model.apply_train is not None and train_draws is None:
            raise ValueError(f"model {model.name} trains through "
                             "apply_train: pass train_draws, one draw per "
                             "step")
        n_batches = s // cfg.batch_size
        perms = torch.as_tensor(perms, dtype=torch.int64, device=x.device)

        def batches():
            for e in range(cfg.local_epochs):
                perm = perms[e]
                xs, ys, ms = (a[perm].reshape((n_batches, cfg.batch_size)
                                              + tuple(a.shape[1:]))
                              for a in (x, y, mask))
                for b in range(n_batches):
                    t = e * n_batches + b
                    db = (None if train_draws is None
                          else {k: v[t] for k, v in train_draws.items()})
                    yield xs[b], ys[b], ms[b], db

        def draw_at(t):
            if step_draws is None:
                return None
            return trees.tree_map(lambda d: d[t], step_draws)

        params, loss = _local_steps(tx, grad_fn, global_params,
                                    global_params, batches(), draw_at,
                                    n_batches)
        with torch.no_grad():
            delta = model.wrap_delta(trees.tree_sub(params, global_params))
        return delta, torch.sum(mask), loss

    return local_update


def make_local_update_clients(model: Model, cfg: FedConfig) -> Callable:
    """Build ``local_update_c(global_params, x, y, mask, generator=None,
    perms=None, step_draws=None)``: x [C, S, ...], y [C, S], mask [C, S]
    → (delta, n_samples, mean_loss), each with leading client axis C.
    Exactly one of ``generator``/``perms`` gives the shuffles;
    ``step_draws`` (leaves (C, E·S/B, …)) the random tree of each client's
    local steps where the route takes one."""
    if model.apply_clients is None:
        raise ValueError(
            f"model {model.name} has no apply_clients; use "
            "make_local_update"
        )
    tx = make_optimizer(cfg)

    def loss_fn(cparams, global_params, xb, yb, mb, _db=None):
        logits = forward(model, cparams, xb)  # (C, Bb, K)
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

    # SPSA's 2C groups in chunks the kernel takes; the plain gradient
    # keeps one program of C groups, as the reference's fold does.
    forward = (apply_groups if cfg.optimizer == "spsa"
               else lambda m, p, x: m.apply_clients(p, x))
    grad_fn, needs_draws = _grad_route(model, cfg, loss_fn, folded=True)

    def local_update_c(global_params, x, y, mask, generator=None,
                       perms=None, step_draws=None):
        c, s = x.shape[0], x.shape[1]
        _check_steps(cfg, s, needs_draws, step_draws)
        perms = resolve_perms(cfg, c, s, generator, perms, x.device)
        n_batches = s // cfg.batch_size
        rows = torch.arange(c, device=x.device)[:, None]

        def batches():
            for e in range(cfg.local_epochs):
                perm = perms[:, e]

                def shuffle(a):  # (C, S, ...) → (C, nb, Bb, ...)
                    return a[rows, perm].reshape(
                        (c, n_batches, cfg.batch_size) + tuple(a.shape[2:]))

                xs, ys, ms = shuffle(x), shuffle(y), shuffle(mask)
                for b in range(n_batches):
                    yield xs[:, b], ys[:, b], ms[:, b], None

        def draw_at(t):
            if step_draws is None:
                return None
            return trees.tree_map(lambda d: d[:, t], step_draws)

        cparams = trees.tree_map(
            lambda p: p[None].expand((c,) + tuple(p.shape)).clone(),
            global_params,
        )
        cparams, loss = _local_steps(tx, grad_fn, cparams, global_params,
                                     batches(), draw_at, n_batches)
        with torch.no_grad():
            # (C, …) − (…) broadcasts the global leaf over the clients.
            delta = model.wrap_delta(trees.tree_sub(cparams, global_params))
        return delta, torch.sum(mask, dim=1), loss

    return local_update_c


def resolve_perms(cfg: FedConfig, clients: int, samples: int,
                  generator=None, perms=None, device=None) -> torch.Tensor:
    """The (C, E, S) shuffles: drawn from ``generator`` or given as
    ``perms`` (exactly one of the two)."""
    if (generator is None) == (perms is None):
        raise ValueError("pass exactly one of generator and perms")
    if perms is None:
        perms = draw_perms(generator, clients, cfg.local_epochs, samples)
    perms = torch.as_tensor(perms, dtype=torch.int64, device=device)
    if tuple(perms.shape) != (clients, cfg.local_epochs, samples):
        raise ValueError(
            f"perms of shape {tuple(perms.shape)}, expected "
            f"{(clients, cfg.local_epochs, samples)}"
        )
    return perms

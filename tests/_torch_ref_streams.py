"""The reference's random draws, recomputed with jax for the port's tests.

jax.random cannot be reproduced in torch, so the parity tests recompute
the arrays the reference's round program draws from its round key and
inject them into the port: the shuffles (``perms``) and the streams of
``qfedx_tpu_torch.fed.round.RoundDraws`` (participation, client-mode DP
noise, the byzantine noise, per-example DP noise and SPSA's Rademacher
Δ per local step, and the noisy VQC's Kraus branch draws and shot
uniforms). Each function follows the derivation in
``qfedx_tpu/fed/{round,client,sampling,privacy}.py`` and
``qfedx_tpu/utils/trees.tree_random_normal``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from qfedx_tpu.fed.round import BYZ_KEY_SALT, DP_KEY_SALT, TRAIN_KEY_SALT
from qfedx_tpu.utils import trees as rtrees


def client_key(round_key, cid):
    return jax.random.fold_in(jax.random.fold_in(round_key, TRAIN_KEY_SALT),
                              cid)


def perms(round_key, clients, epochs, samples):
    """(C, E, S): client c's permutation for epoch e (both the folded and
    the vmap local update draw these)."""
    out = [[np.asarray(jax.random.permutation(jax.random.split(ek)[0],
                                              samples))
            for ek in jax.random.split(client_key(round_key, c), epochs)]
           for c in range(clients)]
    return torch.as_tensor(np.asarray(out), dtype=torch.int64)


def step_keys(key, epochs, samples, batch):
    """The E·S/B per-step keys of ``make_local_update`` for ``key``."""
    out = []
    for ek in jax.random.split(key, epochs):
        out.extend(jax.random.split(jax.random.split(ek)[1],
                                    samples // batch))
    return out


def spsa_delta(bk, params):
    """SPSA's Rademacher Δ of the step key ``bk`` (``make_spsa_grad``)."""
    k_delta, _ = jax.random.split(jax.random.fold_in(bk, 0x59A))
    leaves, treedef = jax.tree_util.tree_flatten(params)
    keys = jax.random.split(k_delta, len(leaves))
    return jax.tree_util.tree_unflatten(treedef, [
        np.asarray(jax.random.rademacher(k, np.shape(x), dtype=np.float32))
        for k, x in zip(keys, leaves)])


def example_noise(bk, params):
    """Per-example DP's noise tree of the step key ``bk``."""
    k_noise, _ = jax.random.split(jax.random.fold_in(bk, 0xDE5))
    return jax.tree.map(np.asarray, rtrees.tree_random_normal(k_noise,
                                                              params))


def _stack(trees_):
    return jax.tree.map(lambda *a: np.stack(a), *trees_)


def step_stream(round_key, params, clients, epochs, samples, batch, kind):
    """(C, E·S/B, …) leaves: ``kind`` ("spsa_delta" or "example_noise")
    at every local step of every client, keyed as the vmap path keys
    them."""
    fn = spsa_delta if kind == "spsa_delta" else example_noise
    return _stack([_stack([fn(bk, params) for bk in step_keys(
        client_key(round_key, c), epochs, samples, batch)])
        for c in range(clients)])


def client_noise(round_key, params, clients, salt):
    """(C, …) leaves: ``tree_random_normal(fold_in(fold_in(round_key,
    salt), cid), Δ)`` — client-mode DP (``DP_KEY_SALT``) or the byzantine
    noise (``BYZ_KEY_SALT``)."""
    base = jax.random.fold_in(round_key, salt)
    return _stack([jax.tree.map(np.asarray, rtrees.tree_random_normal(
        jax.random.fold_in(base, c), params)) for c in range(clients)])


def participation(round_key, clients, fraction):
    if fraction >= 1.0:
        return np.ones(clients, np.float32)
    return np.asarray(jax.random.bernoulli(
        jax.random.fold_in(round_key, 0x5A3D), fraction, (clients,)),
        np.float32)


def round_streams(round_key, params, cfg, clients, samples):
    """Every ``RoundDraws`` stream the reference's round of ``cfg`` (a
    reference or port FedConfig) draws from ``round_key``."""
    out = {"participation": participation(round_key, clients,
                                          cfg.client_fraction),
           "byzantine_noise": client_noise(round_key, params, clients,
                                           BYZ_KEY_SALT)}
    if cfg.dp is not None and cfg.dp.mode == "client":
        out["dp_noise"] = client_noise(round_key, params, clients,
                                       DP_KEY_SALT)
    kind = ("example_noise" if cfg.dp is not None and cfg.dp.mode == "example"
            else "spsa_delta" if cfg.optimizer == "spsa" else None)
    if kind is not None:
        out[kind] = step_stream(round_key, params, clients, cfg.local_epochs,
                                samples, cfg.batch_size, kind)
    return out


# --- the noisy VQC's draws (``shot_uniform``, ``branch_gumbel``) -------------


def sample_keys(bk, batch, route="plain"):
    """The per-sample keys the reference's ``apply_train`` uses at the
    step key ``bk``: ``split(key, B)`` of the key the route hands it —
    ``bk`` itself, SPSA's shared forward key (``fold_in(bk, 0x59A)``'s
    second split), or under per-example DP example i's own key (the i-th
    split of ``fold_in(bk, 0xDE5)``'s second split, then ``split(·, 1)``
    inside the one-sample ``apply_train``)."""
    if route == "plain":
        return list(jax.random.split(bk, batch))
    if route == "spsa":
        k_fwd = jax.random.split(jax.random.fold_in(bk, 0x59A))[1]
        return list(jax.random.split(k_fwd, batch))
    k_fwd = jax.random.split(jax.random.fold_in(bk, 0xDE5))[1]
    return [jax.random.split(k, 1)[0]
            for k in jax.random.split(k_fwd, batch)]


def _gumbel_block(k_traj, n_layers, branches, n):
    rows = []
    for layer in range(n_layers):
        for ci, k in enumerate(branches):
            qkeys = jax.random.split(jax.random.fold_in(k_traj,
                                                        layer * 8 + ci), n)
            g = jax.vmap(lambda kq, k=k: jax.random.gumbel(
                kq, (k,), jnp.float32))(qkeys)
            rows.append(jnp.pad(g, ((0, 0), (0, 4 - k))))
    return jnp.stack(rows).reshape(n_layers, len(branches), n, 4)


_gumbel_blocks = jax.jit(jax.vmap(_gumbel_block, (0, None, None, None)),
                         static_argnums=(1, 2, 3))


def branch_gumbel(keys, n_layers, branches, n):
    """(B, L, channels, n, 4) f32: the Gumbel draws behind the
    reference's ``jax.random.categorical`` branch choices for per-sample
    keys ``keys`` (``split(k)[0]`` is the trajectory key;
    ``fold_in(·, layer·8 + channel)`` keys a layer's channel,
    ``split(·, n)`` its qubits); ``branches`` lists each channel's k, and
    the unused entries of a k < 4 channel are 0."""
    k_traj = jnp.stack([jax.random.split(k)[0] for k in keys])
    return np.asarray(_gumbel_blocks(k_traj, n_layers, tuple(branches), n))


def binomial_cdf(c, shots, p):
    """F(c) = P(X ≤ c) for X ~ Binomial(shots, p), in f64 (F(−1) = 0)."""
    from scipy.stats import binom

    return binom.cdf(np.asarray(c, np.float64), shots,
                     np.asarray(p, np.float64))


def shot_uniforms(counts, p0, shots):
    """The U[0, 1) that the port's inverse CDF maps to ``counts`` at
    ``p0``: the middle of [F(c−1), F(c))."""
    lo = binomial_cdf(np.asarray(counts) - 1, shots, p0)
    hi = binomial_cdf(counts, shots, p0)
    return (lo + hi) / 2.0

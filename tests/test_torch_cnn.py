"""Port vs reference: the TinyCNN (BASELINE.md config 3) and the
one-client update's ``apply_train`` route.

- ``make_tiny_cnn``: logits at 28×28×1 and 32×32×3 against the
  reference's flax module on the same weights (``params_from_jax``),
  within 1e-5, and ``init``'s flax distributions (lecun-normal kernels,
  zero biases);
- ``apply_train`` with the keep mask flax drew for a dropout key, within
  1e-5. The mask is captured from the reference module itself
  (``capture_intermediates``, ``Dense_0`` set to a constant positive
  output so every entry of the mask shows), never re-derived from
  flax's rng folding;
- a FedAvg and a FedProx SGD round against ``make_fed_round`` with the
  reference's shuffles and per-step masks injected, within 1e-5;
- the one-client update honours ``apply_train`` (the step-0 regression:
  a toy model whose ``apply_train`` differs from ``apply`` gives the
  reference's loss and update), on the plain, SPSA and per-example DP
  routes;
- the ``dropout_keep`` stream of ``RoundDraws``: seeded, per client;
- a checkpoint written by either package restores in the other (logits
  within 1e-6); ``train --model cnn`` then ``serve --run-dir`` through
  the CLI on image requests.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ref_streams as streams
from qfedx_tpu.fed.client import make_local_update as ref_local_update
from qfedx_tpu.fed.config import DPConfig as RDPConfig
from qfedx_tpu.fed.config import FedConfig as RFedConfig
from qfedx_tpu.fed.round import (
    client_mesh,
    make_fed_round as ref_make_round,
    shard_client_data,
)
from qfedx_tpu.models.api import Model as RModel
from qfedx_tpu.models.cnn import TinyCNN as RTinyCNN
from qfedx_tpu.models.cnn import make_tiny_cnn as ref_make
from qfedx_tpu.run import checkpoint as rckpt
from qfedx_tpu_torch.fed.client import make_local_update
from qfedx_tpu_torch.fed.config import DPConfig, FedConfig
from qfedx_tpu_torch.fed.round import RoundDraws, make_fed_round
from qfedx_tpu_torch.models.api import Model, StepDraw
from qfedx_tpu_torch.models.cnn import make_tiny_cnn, params_from_jax
from qfedx_tpu_torch.run import checkpoint as pckpt
from qfedx_tpu_torch.run import cli as pcli
from qfedx_tpu_torch.run import config as pconfig
from qfedx_tpu_torch.utils import trees

ATOL = 1e-5
CKPT_ATOL = 1e-6
C, S, BATCH, K = 2, 8, 4, 3
SHAPES = {"28x28x1": (28, 28, 1), "32x32x3": (32, 32, 3)}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on one CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _images(shape, n, seed):
    x = np.random.default_rng(seed).uniform(0, 1, (n,) + shape)
    x = x.astype(np.float32)
    return x[..., 0] if shape[-1] == 1 else x  # [B, H, W] for one channel


def _pair(shape, seed=0, num_classes=K):
    """The reference model, its params, and the port's model and params
    converted from them."""
    h, w, c = shape
    rmodel = ref_make(num_classes, h, w, c)
    rparams = jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(seed)))
    model = make_tiny_cnn(num_classes, h, w, c, device="cpu")
    return rmodel, rparams, model, params_from_jax(rparams, device="cpu")


def _close(got, want, atol):
    for g, w in zip(trees.tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol,
                                   rtol=0)


def ref_keep(bk, batch, shape):
    """The (batch, 64) keep mask flax's Dropout draws for key ``bk``:
    captured from the reference module with ``Dense_0`` giving 1
    everywhere, so its Dropout output is 2 where kept and 0 elsewhere
    (the mask depends on the key and the module path alone)."""
    h, w, c = shape
    module = RTinyCNN(num_classes=K)
    x = jnp.ones((batch, h, w, c), jnp.float32)
    params = module.init(jax.random.PRNGKey(0), x)["params"]
    params = {**params, "Dense_0": {
        "kernel": jnp.zeros_like(params["Dense_0"]["kernel"]),
        "bias": jnp.ones_like(params["Dense_0"]["bias"])}}
    _, state = module.apply({"params": params}, x, train=True,
                            rngs={"dropout": bk},
                            capture_intermediates=True,
                            mutable=["intermediates"])
    out = np.asarray(state["intermediates"]["Dropout_0"]["__call__"][0])
    assert set(np.unique(out)) <= {0.0, 2.0}
    return out != 0


# --- the module -----------------------------------------------------------------


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_logits_match_reference(shape):
    rmodel, rparams, model, params = _pair(SHAPES[shape])
    x = _images(SHAPES[shape], 5, 1)
    got = model.apply(params, x).numpy()
    want = np.asarray(rmodel.apply(rparams, jnp.asarray(x)))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_init_draws_flax_defaults():
    """lecun-normal kernels (truncated at ±2σ, unit-variance rescaled by
    fan-in) and zero biases; a seed fixes the draw."""
    model = make_tiny_cnn(10, 32, 32, 3, device="cpu")
    p = model.init(3)
    for name, layer in p.items():
        k = layer["kernel"]
        fan_in = int(np.prod(k.shape[:-1]))
        std = 1.0 / np.sqrt(fan_in)
        assert float(k.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6
        assert abs(float(k.std()) - std) < 0.25 * std, name
        assert torch.equal(layer["bias"], torch.zeros_like(layer["bias"]))
    assert all(torch.equal(a, b) for a, b in zip(
        trees.tree_leaves(p), trees.tree_leaves(model.init(3))))


def test_apply_train_matches_reference_mask():
    shape = SHAPES["28x28x1"]
    rmodel, rparams, model, params = _pair(shape)
    x = _images(shape, 6, 2)
    bk = jax.random.PRNGKey(17)
    keep = ref_keep(bk, 6, shape)
    assert 0 < keep.mean() < 1
    got = model.apply_train(
        params, x, {"dropout_keep": torch.as_tensor(keep)}).numpy()
    want = np.asarray(rmodel.apply_train(rparams, jnp.asarray(x), bk))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    # Dropout is on: the training forward is not the evaluation one.
    assert np.abs(got - model.apply(params, x).numpy()).max() > 1e-3


# --- the federated round ----------------------------------------------------


def _round_streams(key, shape):
    """The reference's shuffles and every step's keep mask for ``key``."""
    keeps = np.stack([np.stack([
        ref_keep(bk, BATCH, shape)
        for bk in streams.step_keys(streams.client_key(key, c), 1, S,
                                    BATCH)]) for c in range(C)])
    return streams.perms(key, C, 1, S), keeps


@pytest.mark.parametrize("algorithm", ["fedavg", "fedprox"])
def test_round_matches_reference(algorithm):
    shape = SHAPES["28x28x1"]
    kw = dict(local_epochs=1, batch_size=BATCH, learning_rate=0.1,
              momentum=0.9, algorithm=algorithm,
              prox_mu=0.5 if algorithm == "fedprox" else 0.0)
    rmodel, rparams, model, params = _pair(shape, seed=1)
    rng = np.random.default_rng(5)
    cx = rng.uniform(0, 1, (C, S) + shape[:2]).astype(np.float32)
    cy = rng.integers(0, K, (C, S)).astype(np.int32)
    cm = np.ones((C, S), np.float32)
    cm[1, -1] = 0.0
    mesh = client_mesh(num_devices=1)
    rf = ref_make_round(rmodel, RFedConfig(**kw), mesh, num_clients=C)
    key = jax.random.PRNGKey(40)
    want, wst = rf(rparams, *shard_client_data(
        mesh, jnp.asarray(cx), jnp.asarray(cy), jnp.asarray(cm)), key)
    perms, keeps = _round_streams(key, shape)
    prf = make_fed_round(model, FedConfig(**kw), num_clients=C)
    got, gst = prf(params, *(torch.as_tensor(a) for a in (cx, cy, cm)),
                   perms=perms,
                   draws=RoundDraws(0, 0, {"dropout_keep": keeps}))
    _close(got, jax.tree.map(np.asarray, want), ATOL)
    assert abs(float(gst.mean_loss) - float(wst.mean_loss)) <= ATOL
    assert float(gst.total_weight) == float(wst.total_weight)


def test_round_needs_its_draws_for_dropout():
    _, _, model, params = _pair(SHAPES["28x28x1"])
    prf = make_fed_round(model, FedConfig(local_epochs=1, batch_size=BATCH),
                         num_clients=C)
    x = torch.zeros((C, S, 28, 28))
    with pytest.raises(ValueError, match="dropout"):
        prf(params, x, torch.zeros((C, S), dtype=torch.int64),
            torch.ones((C, S)), generator=torch.Generator().manual_seed(0))


def test_dropout_keep_stream_is_seeded_per_client():
    spec = (StepDraw("dropout_keep", "keep", (64,), 0.5),)
    a = RoundDraws(7, 3).train_draws(spec, 3, 5, 8, "cpu")["dropout_keep"]
    b = RoundDraws(7, 3).train_draws(spec, 3, 5, 8, "cpu")["dropout_keep"]
    assert a.shape == (3, 5, 8, 64) and a.dtype == torch.bool
    assert torch.equal(a, b)
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a, RoundDraws(7, 4).train_draws(
        spec, 3, 5, 8, "cpu")["dropout_keep"])
    assert abs(float(a.float().mean()) - 0.5) < 0.05


# --- step 0: the one-client update honours apply_train ------------------------


def _toy_pair(n_features=3, classes=2):
    """A linear toy whose ``apply_train`` differs from ``apply``: logits
    times a Bernoulli(0.5) mask over (B, K), scaled by 2, in both
    packages (the reference draws the mask from the step key)."""

    def r_apply(p, x):
        return x @ p["w"] + p["b"]

    def r_apply_train(p, x, key):
        keep = jax.random.bernoulli(key, 0.5, (x.shape[0], classes))
        return jnp.where(keep, 2.0 * r_apply(p, x), 0.0)

    def apply(p, x):
        return x @ p["w"] + p["b"]

    def apply_train(p, x, draws):
        return torch.where(draws["dropout_keep"], 2.0 * apply(p, x),
                           torch.zeros(()))

    rmodel = RModel(init=None, apply=r_apply, apply_train=r_apply_train)
    model = Model(init=None, apply=apply, apply_train=apply_train,
                  train_draws=(StepDraw("dropout_keep", "keep", (classes,),
                                        0.5),))
    rng = np.random.default_rng(9)
    params = {"b": np.zeros(classes, np.float32),
              "w": rng.normal(size=(n_features, classes)).astype(np.float32)}
    return rmodel, model, params


def test_one_client_update_honours_apply_train():
    rmodel, model, params = _toy_pair()
    rng = np.random.default_rng(10)
    x = rng.normal(size=(S, 3)).astype(np.float32)
    y = rng.integers(0, 2, S).astype(np.int32)
    m = np.ones(S, np.float32)
    kw = dict(local_epochs=2, batch_size=BATCH, learning_rate=0.2)
    key = jax.random.PRNGKey(3)
    wd, wn, wl = ref_local_update(rmodel, RFedConfig(**kw))(
        params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m), key)
    epochs = jax.random.split(key, 2)
    perms = np.stack([np.asarray(jax.random.permutation(
        jax.random.split(ek)[0], S)) for ek in epochs])
    keep = np.stack([np.asarray(jax.random.bernoulli(bk, 0.5, (BATCH, 2)))
                     for bk in streams.step_keys(key, 2, S, BATCH)])
    update = make_local_update(model, FedConfig(**kw))
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    data = [torch.as_tensor(a) for a in (x, y, m)]
    gd, gn, gl = update(tp, *data, perms,
                        train_draws={"dropout_keep": torch.as_tensor(keep)})
    _close(gd, jax.tree.map(np.asarray, wd), ATOL)
    assert abs(float(gl) - float(wl)) <= ATOL and float(gn) == float(wn)
    # The old route (``model.apply`` only) gives another loss.
    plain = make_local_update(dataclasses.replace(model, apply_train=None),
                              FedConfig(**kw))
    _, _, pl = plain(tp, *data, perms)
    assert abs(float(pl) - float(wl)) > 1e-3
    with pytest.raises(ValueError, match="train_draws"):
        update(tp, *data, perms)


def _route_keep(bk, route):
    """The toy's (B, K) mask on ``route`` for step key ``bk``: SPSA's two
    evaluations share the forward key split from ``fold_in(bk, 0x59A)``;
    per-example DP gives example i the i-th split of its forward key."""
    if route == "spsa":
        k_fwd = jax.random.split(jax.random.fold_in(bk, 0x59A))[1]
        return np.asarray(jax.random.bernoulli(k_fwd, 0.5, (BATCH, 2)))
    k_fwd = jax.random.split(jax.random.fold_in(bk, 0xDE5))[1]
    return np.concatenate([
        np.asarray(jax.random.bernoulli(k, 0.5, (1, 2)))
        for k in jax.random.split(k_fwd, BATCH)])


@pytest.mark.parametrize("route", ["spsa", "dp_example"])
def test_apply_train_on_spsa_and_per_example_dp(route):
    """The one-client update hands ``apply_train`` the step's mask on the
    SPSA and per-example DP routes too, as the reference does."""
    rmodel, model, params = _toy_pair()
    rng = np.random.default_rng(12)
    x = rng.normal(size=(S, 3)).astype(np.float32)
    y = rng.integers(0, 2, S).astype(np.int32)
    m = np.ones(S, np.float32)
    kw = dict(local_epochs=1, batch_size=BATCH, learning_rate=0.2)
    if route == "spsa":
        rkw, pkw = dict(kw, optimizer="spsa"), dict(kw, optimizer="spsa")
    else:
        dp = dict(clip_norm=1.0, noise_multiplier=1.0, mode="example")
        rkw = dict(kw, dp=RDPConfig(**dp))
        pkw = dict(kw, dp=DPConfig(**dp))
    key = jax.random.PRNGKey(5)
    wd, _, wl = ref_local_update(rmodel, RFedConfig(**rkw))(
        params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m), key)
    bkeys = streams.step_keys(key, 1, S, BATCH)
    draw = streams.spsa_delta if route == "spsa" else streams.example_noise
    step_draws = jax.tree.map(lambda *a: torch.as_tensor(np.stack(a)),
                              *(draw(bk, params) for bk in bkeys))
    keep = np.stack([_route_keep(bk, route) for bk in bkeys])
    perms = np.asarray(jax.random.permutation(
        jax.random.split(jax.random.split(key, 1)[0])[0], S))[None]
    gd, _, gl = make_local_update(model, FedConfig(**pkw))(
        {k: torch.as_tensor(v) for k, v in params.items()},
        *(torch.as_tensor(a) for a in (x, y, m)), perms,
        step_draws=step_draws,
        train_draws={"dropout_keep": torch.as_tensor(keep)})
    _close(gd, jax.tree.map(np.asarray, wd), ATOL)
    assert abs(float(gl) - float(wl)) <= ATOL


# --- checkpoints and the CLI ------------------------------------------------


def test_checkpoints_cross_both_ways(tmp_path):
    shape = SHAPES["32x32x3"]
    rmodel, rparams, model, _ = _pair(shape, seed=4)
    x = _images(shape, 4, 6)
    rckpt.Checkpointer(tmp_path / "r", every=1).save(3, rparams)
    got, r = pckpt.Checkpointer(tmp_path / "r").restore_latest(model.init(0))
    assert r == 3
    np.testing.assert_allclose(
        model.apply(got, x).numpy(),
        np.asarray(rmodel.apply(rparams, jnp.asarray(x))),
        atol=CKPT_ATOL, rtol=0)
    pparams = model.init(5)
    pckpt.Checkpointer(tmp_path / "p", every=1).save(2, pparams)
    back = rckpt.Checkpointer(tmp_path / "p", every=1).restore(2, rparams)
    np.testing.assert_allclose(
        np.asarray(rmodel.apply(back, jnp.asarray(x))),
        model.apply(pparams, x).numpy(), atol=CKPT_ATOL, rtol=0)


@pytest.fixture
def small_data(monkeypatch):
    monkeypatch.setattr(pcli, "DataConfig", functools.partial(
        pconfig.DataConfig, synthetic_train=256, synthetic_test=64))


def test_cli_train_then_serve_cnn(tmp_path, small_data):
    summary = pcli.main([
        "train", "--model", "cnn", "--dataset", "cifar10", "--classes",
        "0,1", "--clients", "2", "--rounds", "2", "--local-epochs", "1",
        "--algorithm", "fedprox", "--prox-mu", "0.01", "--checkpoint-every",
        "1", "--run-root", str(tmp_path), "--name", "cnn"], device="cpu")
    assert 0.0 <= summary["final_accuracy"] <= 1.0
    run = tmp_path / "cnn"
    cfg = json.loads((run / "config.json").read_text())
    assert cfg["model"]["model"] == "cnn"
    assert cfg["fed"]["algorithm"] == "fedprox"
    x = _images(SHAPES["32x32x3"], 3, 7)
    lines = [json.dumps({"id": i, "features": v.tolist()})
             for i, v in enumerate(x)] + ["{not json"]
    (tmp_path / "in.jsonl").write_text("\n".join(lines) + "\n")
    out = tmp_path / "out.jsonl"
    served = pcli.main(["serve", "--run-dir", str(run), "--input",
                        str(tmp_path / "in.jsonl"), "--output", str(out),
                        "--buckets", "1,4"], device="cpu")
    assert served["served"] == 3 and served["responses"] == 4
    resp = [json.loads(line) for line in out.read_text().splitlines()]
    assert resp[-1]["code"] == 400
    model = make_tiny_cnn(2, 32, 32, 3, device="cpu")
    params, r = pckpt.Checkpointer(run / "checkpoints").restore_latest(
        model.init(0))
    assert r == 2
    want = model.apply(params, x).numpy()
    got = np.array([q["logits"] for q in resp[:3]])
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)

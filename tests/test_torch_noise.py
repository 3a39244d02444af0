"""Port vs reference: noise on the VQC (noise/channels.py,
noise/trajectory.py, the noisy routes of models/vqc.py, the draws of
fed/round.RoundDraws and fed/client.py, run/config.build_model and
serving a noisy run directory).

- the Kraus sets, the confusion matrix and map, ``apply_to_z``,
  ``noisy_logits``, ``composed`` and ``exact_shots``: 1e-6;
- ``apply_channel``/``apply_channel_all`` with the reference's Gumbel
  draws injected (the reference's ``jax.random.categorical`` is
  ``argmax(logits + gumbel(key))``): the same branch and state within
  1e-6, in f32 and bf16; ``trajectory_average`` over the same
  trajectories within 1e-6;
- shot counts: uniforms injected in the middle of [F(c−1), F(c)) for
  each count c that ``jax.random.binomial`` drew give that count;
- ``apply`` and ``apply_train`` logits at n = 4 and n = 10 under both
  placements, draws injected: 1e-5;
- one FedAvg round per placement, and the SPSA and per-example DP
  routes under circuit noise, against ``make_fed_round`` with every draw
  injected: θ and the loss within 1e-5; under plain shots training the
  ansatz Δθ is exactly 0 in both packages (the counts carry no
  gradient);
- circuit noise with the reupload encoding raises ValueError in both;
- the CLI: a noisy ``train`` then ``serve --run-dir``, the port's run
  served by the reference and a reference run directory served by the
  port, logits within 2e-5;
- the route probe at n = 12, L = 2 with the reference's TPU program
  shape forced: which scan-body launches evaluation and one local step
  run under each noise mode, in both packages.

Below n = 10 the reference runs its "dot" gate form (its XLA:CPU form);
at the slab widths the TPU program shape with its ``lax.scan`` route
(QFEDX_PALLAS=0), except in the probe, which traces the Pallas route.
"""

import dataclasses
import functools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import _torch_ref_streams as streams
from qfedx_tpu.fed import client as rclient
from qfedx_tpu.fed.config import DPConfig as RDPConfig
from qfedx_tpu.fed.config import FedConfig as RFedConfig
from qfedx_tpu.fed.round import (
    client_mesh,
    make_fed_round as ref_make_round,
    shard_client_data,
)
from qfedx_tpu.models.vqc import make_vqc_classifier as ref_make
from qfedx_tpu.noise import channels as rch
from qfedx_tpu.noise import trajectory as rtr
from qfedx_tpu.ops import fuse as rfuse
from qfedx_tpu.ops import pallas_body as rpb
from qfedx_tpu.ops import statevector as rsv
from qfedx_tpu.ops.cpx import CArray as JC
from qfedx_tpu_torch.fed import client as pclient
from qfedx_tpu_torch.fed.config import DPConfig, FedConfig
from qfedx_tpu_torch.fed.round import RoundDraws, make_fed_round
from qfedx_tpu_torch.models.vqc import make_vqc_classifier, params_from_jax
from qfedx_tpu_torch.noise import channels as pch
from qfedx_tpu_torch.noise import trajectory as ptr
from qfedx_tpu_torch.ops import scan_body
from qfedx_tpu_torch.ops.cpx import CArray as TC
from qfedx_tpu_torch.run import cli as pcli
from qfedx_tpu_torch.run import config as pconfig
from qfedx_tpu_torch.utils import trees

MAP_ATOL = 1e-6
STATE_ATOL = 1e-6
LOGIT_ATOL = 1e-5
ROUND_ATOL = 1e-5
SERVE_ATOL = 2e-5
L, K, C, S, BATCH = 2, 2, 2, 8, 4
SHOTS = 256
# Strengths large enough that the channels move the logits and every
# branch of a channel is drawn in these small runs.
NOISE = dict(depolarizing_p=0.2, amp_damping_gamma=0.15, readout_e01=0.05,
             readout_e10=0.05)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on one CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _form(mp, n, pallas="0"):
    """The reference's program shape for width ``n`` (the port reads the
    same pins when its model runs)."""
    for pin in ("QFEDX_FUSE", "QFEDX_SCAN_LAYERS", "QFEDX_BATCHED"):
        mp.setenv(pin, "1")
    mp.setenv("QFEDX_PALLAS", pallas)
    mp.setenv("QFEDX_GATE_FORM", "dot" if n < 10 else "flip")
    mp.setenv("QFEDX_SLAB_LANES", "matmul")
    mp.setattr(rfuse, "_gather_ok", lambda: True)
    mp.setattr(rfuse, "_growmat_merge_ok", lambda: True)


@pytest.fixture(autouse=True)
def small_form(monkeypatch):
    _form(monkeypatch, 4)


def _leaves(tree):
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return trees.tree_leaves(tree) if isinstance(tree, dict) else [tree]


def _close(got, want, atol, what=""):
    got, want = _leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want), what
    for g, w in zip(got, want):
        np.testing.assert_allclose(
            g.detach().float().numpy() if isinstance(g, torch.Tensor)
            else np.asarray(g, np.float32),
            np.asarray(w, np.float32), atol=atol, rtol=0, err_msg=what)


def _models(n, placement, shots=SHOTS, encoding="angle", **noise):
    kw = dict(NOISE, **noise)
    circuit = placement == "circuit"
    rmodel = ref_make(n, L, K, encoding=encoding, noise_model=rch.NoiseModel(
        shots=shots, circuit_level=circuit, **kw))
    model = make_vqc_classifier(
        n, L, K, encoding=encoding, device="cpu", noise_model=pch.NoiseModel(
            shots=shots, circuit_level=circuit, **kw))
    return rmodel, model


def _params(n, seed=0):
    """Reference-layout parameters with a non-trivial readout."""
    rng = np.random.default_rng(seed)
    return {"ansatz": {k: rng.uniform(-2, 2, (L, n)).astype(np.float32)
                       for k in ("rx", "rz")},
            "readout": {"scale": rng.uniform(0.5, 2, K).astype(np.float32),
                        "bias": rng.uniform(-0.5, 0.5, K).astype(np.float32)}}


def _unit(params):
    """``params`` with the readout at scale 1, bias 0: logits = noisy ⟨Z⟩."""
    return dict(params, readout={"scale": np.ones(K, np.float32),
                                 "bias": np.zeros(K, np.float32)})


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _branches(nm):
    return tuple(int(k.re.shape[0]) for k in nm.kraus_channels())


@functools.lru_cache(maxsize=None)
def _ref_train_fn(n, rnoise):
    return jax.jit(ref_make(n, L, K, noise_model=rnoise).apply_train)


def _as_port(rnoise):
    return pch.NoiseModel(**dataclasses.asdict(rnoise))


def step_draws(rnoise, n, bk, xb, params, route="plain"):
    """The port's ``apply_train`` draws for the reference's step key
    ``bk`` on ``route``: the Gumbel draws behind its trajectories' branch
    choices and, with shots (plain route), the uniforms that give the
    counts it drew — read from its unit-readout logits, which are
    2·count/shots − 1 — placed at the port's own p₀."""
    keys = streams.sample_keys(bk, xb.shape[0], route)
    out = {}
    circuit = rnoise.circuit_level and _branches(rnoise)
    if circuit:
        out["branch_gumbel"] = torch.tensor(streams.branch_gumbel(
            keys, L, _branches(rnoise), n))
    if rnoise.shots is not None:
        assert route == "plain"
        unit = _unit(params)
        logits = np.asarray(_ref_train_fn(n, rnoise)(
            _jax(unit), jnp.asarray(xb), bk))
        counts = np.rint((logits + 1.0) * rnoise.shots / 2.0)
        exact = make_vqc_classifier(n, L, K, device="cpu", noise_model=(
            dataclasses.replace(_as_port(rnoise), shots=None)))
        tunit = params_from_jax(unit, device="cpu")
        with torch.no_grad():
            z = (exact.apply_train(tunit, xb, out) if circuit
                 else exact.apply(tunit, xb))
        p0 = torch.clamp((1.0 + z) / 2.0, 0.0, 1.0).numpy()
        out["shot_uniform"] = torch.as_tensor(streams.shot_uniforms(
            counts, p0, rnoise.shots))
    return out


# --- channels and maps ---------------------------------------------------------

_KRAUS = {
    "depolarizing": (rch.depolarizing_kraus, pch.depolarizing_kraus, 0.3),
    "damping": (rch.amplitude_damping_kraus, pch.amplitude_damping_kraus,
                0.4),
    "bit_flip": (rch.bit_flip_kraus, pch.bit_flip_kraus, 0.2),
    "phase_flip": (rch.phase_flip_kraus, pch.phase_flip_kraus, 0.1),
}


@pytest.mark.parametrize("name", sorted(_KRAUS))
def test_kraus_sets_match_reference(name):
    rfn, pfn, p = _KRAUS[name]
    want, got = rfn(p), pfn(p, "cpu")
    assert tuple(got.re.shape) == tuple(want.re.shape)
    assert (got.im is None) == (want.im is None)
    _close([got.re] + ([] if got.im is None else [got.im]),
           [want.re] + ([] if want.im is None else [want.im]), MAP_ATOL)


def test_confusion_and_z_maps_match_reference():
    rng = np.random.default_rng(0)
    z = rng.uniform(-1, 1, (6, 3)).astype(np.float32)
    _close([pch.confusion_matrix(0.03, 0.07, "cpu")],
           [rch.confusion_matrix(0.03, 0.07)], MAP_ATOL)
    _close([pch.apply_confusion_to_z(torch.as_tensor(z), 0.03, 0.07)],
           [rch.apply_confusion_to_z(jnp.asarray(z), 0.03, 0.07)], MAP_ATOL)
    rnm = rch.NoiseModel(**NOISE)
    pnm = _as_port(rnm)
    _close([pnm.apply_to_z(torch.as_tensor(z))],
           [rnm.apply_to_z(jnp.asarray(z), None)], MAP_ATOL)
    # noisy_logits on a dense n = 4 state (per-sample, as the vmap route).
    re = rng.normal(size=(5,) + (2,) * 4).astype(np.float32)
    im = rng.normal(size=re.shape).astype(np.float32)
    nrm = np.sqrt((re**2 + im**2).reshape(5, -1).sum(1)).reshape(
        (5,) + (1,) * 4)
    re, im = re / nrm, im / nrm
    readout = _params(4)["readout"]
    want = jax.vmap(lambda r, i: rnm.noisy_logits(
        JC(r, i), _jax(readout), None))(jnp.asarray(re), jnp.asarray(im))
    got = pnm.noisy_logits(TC(torch.as_tensor(re), torch.as_tensor(im)),
                           params_from_jax(readout, device="cpu"), n=4)
    _close([got], [want], MAP_ATOL)
    with pytest.raises(ValueError, match="shot"):
        dataclasses.replace(pnm, shots=10).apply_to_z(torch.as_tensor(z))


@pytest.mark.parametrize("p,gamma,n", [
    (0.02, 0.01, 3), (0.1, 0.0, 4), (0.0, 0.2, 5), (0.3, 1.0, 3),
    (0.5, 0.5, 1), (0.2, 0.15, 2)])
def test_composed_matches_reference(p, gamma, n):
    want = rch.NoiseModel(p, gamma, 0.01, 0.02, circuit_level=True
                          ).composed(n)
    got = pch.NoiseModel(p, gamma, 0.01, 0.02, circuit_level=True
                         ).composed(n)
    assert dataclasses.asdict(got) == pytest.approx(
        dataclasses.asdict(want), abs=1e-12)


@pytest.mark.parametrize("shots", [None, 100])
def test_exact_shots_matches_reference(shots):
    """With shots the infinite-shot model drops ``circuit_level`` (the
    evaluator's composed strengths depend on it); without, it is the
    model itself."""
    kw = dict(NOISE, shots=shots, circuit_level=True)
    want = rch.NoiseModel(**kw).exact_shots()
    got = pch.NoiseModel(**kw).exact_shots()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.circuit_level == (shots is None)


# --- trajectories -------------------------------------------------------------


def _batch_state(n, batch, seed, dtype):
    rng = np.random.default_rng(seed)
    re = rng.normal(size=(batch,) + (2,) * n).astype(np.float32)
    im = rng.normal(size=re.shape).astype(np.float32)
    nrm = np.sqrt((re**2 + im**2).reshape(batch, -1).sum(1)).reshape(
        (batch,) + (1,) * n)
    re, im = re / nrm, im / nrm
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "f32" else torch.bfloat16
    return (JC(jnp.asarray(re, jdt), jnp.asarray(im, jdt)),
            TC(torch.as_tensor(re).to(tdt), torch.as_tensor(im).to(tdt)))


def _gumbels(keys, k):
    g = np.zeros((len(keys), 4), np.float32)
    for i, key in enumerate(keys):
        g[i, :k] = np.asarray(jax.random.gumbel(key, (k,), jnp.float32))
    return g


@pytest.mark.parametrize("channel", ["depolarizing", "damping"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_channel_matches_reference(dtype, channel):
    """Sixteen states, one key each: the reference's categorical branch
    equals argmax(log p + g) on its Gumbel draws, and the port's state
    equals the reference's (every branch is drawn among them)."""
    n, batch, qubit = 4, 16, 2
    rfn, pfn, _ = _KRAUS[channel]
    p = 0.75 if channel == "depolarizing" else 0.5
    rk, pk = rfn(p), pfn(p, "cpu")
    k = int(rk.re.shape[0])
    rstate, pstate = _batch_state(n, batch, 1, dtype)
    keys = list(jax.random.split(jax.random.PRNGKey(3), batch))
    want = jax.vmap(lambda s, key: rtr.apply_channel(s, rk, qubit, key))(
        rstate, jnp.stack(keys))
    got = ptr.apply_channel(pstate, pk, qubit, torch.as_tensor(
        _gumbels(keys, k)), n)
    assert got.re.dtype == pstate.re.dtype
    _close([got.re, got.im], [want.re, want.im], STATE_ATOL, "state")
    # The branches drawn: every one of the channel's k appears.
    probs = np.stack([np.asarray(jax.vmap(lambda s: jnp.sum(
        rsv.cabs2(rsv.apply_gate(s, JC(rk.re[i], None if rk.im is None
                                       else rk.im[i]), qubit)),
        dtype=jnp.float32))(rstate)) for i in range(k)], -1)
    idx = [int(jax.random.categorical(key, jnp.log(jnp.maximum(
        jnp.asarray(pr), 1e-30)))) for key, pr in zip(keys, probs)]
    assert idx == list(np.argmax(np.log(np.maximum(probs, 1e-30))
                                 + _gumbels(keys, k)[:, :k], -1))
    assert set(idx) == set(range(k)), idx


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_channel_all_matches_reference(dtype):
    n, batch = 4, 6
    rk, pk = rch.depolarizing_kraus(0.5), pch.depolarizing_kraus(0.5, "cpu")
    rstate, pstate = _batch_state(n, batch, 2, dtype)
    keys = list(jax.random.split(jax.random.PRNGKey(4), batch))
    want = jax.vmap(lambda s, key: rtr.apply_channel_all(s, rk, key))(
        rstate, jnp.stack(keys))
    g = np.stack([_gumbels(list(jax.random.split(key, n)), 4)
                  for key in keys])
    got = ptr.apply_channel_all(pstate, pk, torch.as_tensor(g), n)
    _close([got.re, got.im], [want.re, want.im], STATE_ATOL)


def test_trajectory_average_matches_reference():
    """64 trajectories of damping after depolarizing on a 3-qubit product
    state: the averaged ⟨Z⟩ within 1e-6 over the same branches."""
    n, t = 3, 64
    rng = np.random.default_rng(5)
    amps = rng.uniform(0, 1, n).astype(np.float32)
    rdep, rdamp = rch.depolarizing_kraus(0.3), rch.amplitude_damping_kraus(
        0.4)
    pdep, pdamp = (pch.depolarizing_kraus(0.3, "cpu"),
                   pch.amplitude_damping_kraus(0.4, "cpu"))
    from qfedx_tpu.circuits.encoders import angle_encode as r_enc
    from qfedx_tpu_torch.circuits.encoders import angle_encode as p_enc
    from qfedx_tpu_torch.ops.statevector import expect_z_all

    def robs(key):
        k1, k2 = jax.random.split(key)
        s = rtr.apply_channel_all(r_enc(jnp.asarray(amps)), rdep, k1)
        return rsv.expect_z_all(rtr.apply_channel_all(s, rdamp, k2))

    key = jax.random.PRNGKey(6)
    want = jax.jit(rtr.trajectory_average(robs, t))(key)
    tkeys = jax.random.split(key, t)
    g1, g2 = (np.stack([_gumbels(list(jax.random.split(
        jax.random.split(k)[j], n)), 4) for k in tkeys]) for j in (0, 1))

    def pobs(draws):
        s = p_enc(torch.as_tensor(amps).expand(t, n))
        s = ptr.apply_channel_all(s, pdep, draws["dep"], n)
        return expect_z_all(ptr.apply_channel_all(s, pdamp, draws["damp"],
                                                  n), n)

    got = ptr.trajectory_average(pobs, t)({"dep": torch.as_tensor(g1),
                                           "damp": torch.as_tensor(g2)})
    _close([got], [want], STATE_ATOL)
    with pytest.raises(ValueError, match="trajectories"):
        ptr.trajectory_average(pobs, t + 1)({"dep": torch.as_tensor(g1)})


@pytest.mark.parametrize("shots", [1, 100, 1024])
def test_shot_counts_equal_reference_counts(shots):
    """For every count ``jax.random.binomial`` drew, a uniform in the
    middle of [F(c−1), F(c)) gives that count (p₀ = 0 and 1 included)."""
    rng = np.random.default_rng(shots)
    p0 = rng.uniform(0, 1, 200).astype(np.float32)
    p0[:2] = (0.0, 1.0)
    keys = jax.random.split(jax.random.PRNGKey(shots), 200)
    counts = np.asarray(jax.vmap(lambda k, p: jax.random.binomial(
        k, shots, p))(keys, jnp.asarray(p0)))
    u = streams.shot_uniforms(counts, p0, shots)
    got = pch.binomial_counts(torch.as_tensor(p0), shots, torch.as_tensor(u))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), counts)
    assert counts[0] == 0 and counts[1] == shots


# --- the model ---------------------------------------------------------------


def _features(n, batch, seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (batch, n)).astype(
        np.float32)


@pytest.mark.parametrize("placement", ["readout", "circuit"])
@pytest.mark.parametrize("n", [4, 10])
def test_logits_match_reference(monkeypatch, n, placement):
    """``apply`` (the evaluator's noise: no shots, composed strengths under
    circuit placement) and ``apply_train`` with the reference's draws
    injected, within 1e-5; the engine is the dense one under noise."""
    _form(monkeypatch, n)
    if placement == "circuit":
        # The trajectory's per-qubit channels in the reference's XLA:CPU
        # gate form, which compiles in a fraction of its TPU form's time.
        monkeypatch.setenv("QFEDX_GATE_FORM", "dot")
    # At the slab width one channel (depolarizing, the complex Kraus set)
    # under circuit placement: the reference compiles every channel on
    # every qubit.
    noise = dict(NOISE, **({"amp_damping_gamma": 0.0}
                           if n >= 10 and placement == "circuit" else {}))
    rmodel, model = _models(n, placement, **noise)
    assert model.engine() == "vmap"
    params = _params(n)
    tparams = params_from_jax(params, device="cpu")
    x = _features(n, BATCH)
    with torch.no_grad():
        _close([model.apply(tparams, x)],
               [jax.jit(rmodel.apply)(_jax(params), jnp.asarray(x))],
               LOGIT_ATOL, "apply")
    bk = jax.random.PRNGKey(11)
    rnoise = rch.NoiseModel(shots=SHOTS, circuit_level=placement == "circuit",
                            **noise)
    draws = step_draws(rnoise, n, bk, x, params)
    assert sorted(draws) == sorted(d.stream for d in model.train_draws)
    want = _ref_train_fn(n, rnoise)(_jax(params), jnp.asarray(x), bk)
    _close([model.apply_train(tparams, x, draws)], [want], LOGIT_ATOL,
           "apply_train")
    # Shots: the logits sit on the readout's grid of counts.
    counts = (want - params["readout"]["bias"]) / params["readout"][
        "scale"]
    np.testing.assert_allclose((np.asarray(counts) + 1) * SHOTS / 2,
                               np.rint((np.asarray(counts) + 1) * SHOTS / 2),
                               atol=2e-3)


def test_circuit_noise_without_shots_matches_reference_gradients():
    """The trajectory forward's gradient (through the chosen branches and
    their norms; the score-function term is dropped in both packages)
    within 2e-5 at n = 4."""
    n = 4
    rmodel, model = _models(n, "circuit", shots=None)
    params = _params(n, seed=3)
    x = _features(n, BATCH, seed=4)
    y = np.array([0, 1, 1, 0], np.int32)
    bk = jax.random.PRNGKey(12)
    draws = step_draws(rch.NoiseModel(circuit_level=True, **NOISE), n, bk,
                       x, params)

    def rloss(p):
        return optax.softmax_cross_entropy_with_integer_labels(
            rmodel.apply_train(p, jnp.asarray(x), bk), jnp.asarray(y)).mean()

    wloss, want = jax.jit(jax.value_and_grad(rloss))(_jax(params))
    leaves = trees.tree_map(lambda v: v.requires_grad_(True),
                            params_from_jax(params, device="cpu"))
    loss = pclient._cross_entropy(model.apply_train(leaves, x, draws),
                                  torch.as_tensor(y)).mean()
    it = iter(torch.autograd.grad(loss, trees.tree_leaves(leaves)))
    _close(trees.tree_map(lambda _: next(it), leaves), want, 2e-5)
    assert abs(float(loss) - float(wloss)) <= LOGIT_ATOL


def test_reupload_with_circuit_noise_raises():
    with pytest.raises(ValueError, match="circuit-level"):
        _models(4, "circuit", encoding="reupload")


# --- rounds -------------------------------------------------------------------


def _round_data(n, seed=0):
    rng = np.random.default_rng(seed)
    cx = rng.uniform(0, 1, (C, S, n)).astype(np.float32)
    cy = rng.integers(0, K, (C, S)).astype(np.int32)
    cm = np.ones((C, S), np.float32)
    cm[1, -2:] = 0.0
    return cx, cy, cm


def _round_given(rnoise, n, key, params, cx, rcfg, route):
    """Every stream the port's round takes, from the reference's round
    key: the client-level ones (``streams.round_streams``) and each local
    step's ``apply_train`` draws on ``route``."""
    given = streams.round_streams(key, params, rcfg, C, S)
    perms = streams.perms(key, C, 1, S).numpy()
    per_client = []
    for c in range(C):
        bks = streams.step_keys(streams.client_key(key, c), 1, S, BATCH)
        xs = cx[c][perms[c, 0]].reshape(S // BATCH, BATCH, n)
        per_client.append([step_draws(rnoise, n, bk, xs[t], params, route)
                           for t, bk in enumerate(bks)])
    for stream in per_client[0][0]:
        given[stream] = np.stack([np.stack([d[stream].numpy() for d in cl])
                                  for cl in per_client])
    return given, torch.as_tensor(perms)


_ROUNDS = {
    # placement, shots, optimizer or DP, route of apply_train's keys
    "readout-shots-sgd": ("readout", SHOTS, dict(learning_rate=0.2,
                                                 momentum=0.9), "plain"),
    "readout-shots-adam": ("readout", SHOTS, dict(optimizer="adam",
                                                  learning_rate=0.05),
                           "plain"),
    # SGD, not Adam, under circuit noise: the last layer's RZ angles have
    # an exactly zero gradient (Pauli and damping branch weights ignore
    # phases), and Adam's first step turns the rounding noise there into
    # ±lr in either package.
    "circuit-sgd": ("circuit", None, dict(learning_rate=0.2,
                                          momentum=0.9), "plain"),
    "circuit-spsa": ("circuit", None, dict(optimizer="spsa",
                                           learning_rate=0.1), "spsa"),
    "circuit-dp-example": ("circuit", None, dict(
        learning_rate=0.1, dp=(1.0, 1.2)), "example"),
}
# The SPSA and per-example DP cases hold the routes' draws (their key
# chains), which do not depend on the channels: damping alone keeps the
# reference's compile short.
_ROUND_NOISE = {"circuit-spsa": {"depolarizing_p": 0.0},
                "circuit-dp-example": {"depolarizing_p": 0.0}}


@pytest.mark.parametrize("kind", sorted(_ROUNDS))
def test_round_matches_reference(monkeypatch, kind):
    """One FedAvg round at n = 4 against ``make_fed_round`` with every
    draw injected (shuffles, SPSA's Δ, DP's noise, the branch draws, the
    shot uniforms): θ and the mean loss within 1e-5. Under shots with a
    plain gradient the ansatz is exactly where it started in both
    packages: the counts carry no gradient, so only the readout learns."""
    n = 4
    placement, shots, opt, route = _ROUNDS[kind]
    kw = dict(opt, local_epochs=1, batch_size=BATCH)
    dp = kw.pop("dp", None)
    rcfg = RFedConfig(**kw, dp=None if dp is None else RDPConfig(
        clip_norm=dp[0], noise_multiplier=dp[1], mode="example"))
    cfg = FedConfig(**kw, dp=None if dp is None else DPConfig(
        clip_norm=dp[0], noise_multiplier=dp[1], mode="example"))
    noise = dict(NOISE, **_ROUND_NOISE.get(kind, {}))
    rmodel, model = _models(n, placement, shots=shots, **noise)
    rnoise = rch.NoiseModel(shots=shots, circuit_level=placement == "circuit",
                            **noise)
    params = _params(n, seed=2)
    data = _round_data(n)
    mesh = client_mesh(num_devices=1)
    rf = ref_make_round(rmodel, rcfg, mesh, num_clients=C)
    key = jax.random.PRNGKey(30)
    wp, ws = rf(_jax(params), *shard_client_data(
        mesh, *(jnp.asarray(a) for a in data)), key)
    given, perms = _round_given(rnoise, n, key, params, data[0], rcfg, route)
    prf = make_fed_round(model, cfg, num_clients=C)
    gp, gs = prf(params_from_jax(params, device="cpu"),
                 *(torch.as_tensor(a) for a in data), perms=perms,
                 draws=RoundDraws(0, 0, given))
    _close(gp, jax.tree.map(np.asarray, wp), ROUND_ATOL, "theta")
    assert abs(float(gs.mean_loss) - float(ws.mean_loss)) <= ROUND_ATOL
    if shots is not None and "spsa" not in kind:
        for leaf in ("rx", "rz"):
            assert np.array_equal(np.asarray(wp["ansatz"][leaf]),
                                  params["ansatz"][leaf])
            assert np.array_equal(gp["ansatz"][leaf].numpy(),
                                  params["ansatz"][leaf])
        assert not np.array_equal(gp["readout"]["scale"].numpy(),
                                  params["readout"]["scale"])


def test_reference_shots_gradient_is_zero_on_the_ansatz():
    """The behaviour the port copies: ``jax.grad`` through
    ``jax.random.binomial`` counts is 0, so the reference's ansatz
    gradient under shots is exactly 0 and the readout's is not."""
    rmodel, _ = _models(2, "readout")
    x = jnp.asarray(_features(2, BATCH))

    def loss(p):
        return optax.softmax_cross_entropy_with_integer_labels(
            rmodel.apply_train(p, x, jax.random.PRNGKey(0)),
            jnp.zeros(BATCH, jnp.int32)).mean()

    g = jax.jit(jax.grad(loss))(_jax(_params(2)))
    assert not np.any(np.asarray(g["ansatz"]["rx"]))
    assert not np.any(np.asarray(g["ansatz"]["rz"]))
    assert np.any(np.asarray(g["readout"]["scale"]))


def test_shots_leave_the_ansatz_unchanged_at_a_slab_width(monkeypatch):
    """n = 10 with Adam under shots, the port's own draws: Δθ of the
    ansatz is exactly 0 (the state runs without autograd) and the readout
    moves."""
    n = 10
    _form(monkeypatch, n)
    _, model = _models(n, "readout")
    params = params_from_jax(_params(n), device="cpu")
    cx, cy, cm = _round_data(n, seed=3)
    prf = make_fed_round(model, FedConfig(optimizer="adam",
                                          learning_rate=0.05,
                                          local_epochs=1, batch_size=BATCH),
                         num_clients=C)
    new, stats = prf(params, *(torch.as_tensor(a) for a in (cx, cy, cm)),
                     generator=torch.Generator().manual_seed(0),
                     draws=RoundDraws(3, 0))
    for leaf in ("rx", "rz"):
        assert torch.equal(new["ansatz"][leaf], params["ansatz"][leaf])
    assert not torch.equal(new["readout"]["bias"], params["readout"]["bias"])
    assert np.isfinite(float(stats.mean_loss))


# --- the CLI and serving ----------------------------------------------------------


def _noise_argv(placement):
    return ["--depolarizing", "0.05", "--damping", "0.03", "--readout-flip",
            "0.02", "--shots", "128", "--noise-placement", placement]


@pytest.mark.parametrize("placement", ["readout", "circuit"])
def test_cli_noisy_run_serves_in_both_packages(monkeypatch, tmp_path,
                                               placement):
    """``train`` with every noise flag, then ``serve --run-dir``: the
    port's run restores in the reference and serves the same logits; a
    run directory the reference writes restores in the port and serves
    the reference's logits (2e-5). Serving reads ``eval_noise``."""
    from qfedx_tpu.run import checkpoint as rckpt
    from qfedx_tpu.run import config as rconfig
    from qfedx_tpu.run import metrics as rmetrics
    from qfedx_tpu.serve.engine import engine_from_run_dir as ref_engine
    from qfedx_tpu_torch.serve import engine_from_run_dir

    n = 4
    monkeypatch.setattr(pcli, "DataConfig", functools.partial(
        pconfig.DataConfig, synthetic_train=128, synthetic_test=64))
    argv = ["train", "--model", "vqc", "--qubits", str(n), "--layers",
            str(L), "--classes", "0,1", "--clients", "2", "--rounds", "1",
            "--local-epochs", "1", "--checkpoint-every", "1", "--lr", "0.1",
            "--run-root", str(tmp_path), "--name", "port",
            *_noise_argv(placement)]
    pcli.main(argv, device="cpu")
    run = tmp_path / "port"
    row = json.loads((run / "metrics.jsonl").read_text().splitlines()[0])
    rmetrics.validate_metrics_record(row)
    assert np.isfinite(row["loss"])
    x = _features(n, 5, seed=7)
    (tmp_path / "in.jsonl").write_text(
        "\n".join(json.dumps(v.tolist()) for v in x) + "\n")
    served = pcli.main(["serve", "--run-dir", str(run), "--input",
                        str(tmp_path / "in.jsonl"), "--output",
                        str(tmp_path / "out.jsonl"), "--buckets", "1,8"],
                       device="cpu")
    assert served["served"] == 5
    got = np.array([json.loads(line)["logits"] for line in
                    (tmp_path / "out.jsonl").read_text().splitlines()])
    rengine, _ = ref_engine(run)
    np.testing.assert_allclose(got, np.asarray(rengine.infer(x)),
                               atol=SERVE_ATOL, rtol=0)
    # A run directory the reference writes, served by the port.
    cfg = rconfig.experiment_config_from_dict(
        json.loads((run / "config.json").read_text()))
    with rmetrics.ExperimentRun(tmp_path, "ref", config=cfg) as rrun:
        rckpt.Checkpointer(rrun.dir / "checkpoints", every=1).save(
            1, _jax(_params(n, seed=9)))
    engine, info = engine_from_run_dir(tmp_path / "ref", device="cpu")
    assert engine.model.engine() == "vmap"
    rengine, _ = ref_engine(tmp_path / "ref")
    np.testing.assert_allclose(engine.infer(x), np.asarray(rengine.infer(x)),
                               atol=SERVE_ATOL, rtol=0)


# --- the route probe ----------------------------------------------------------------

# Launches per noise mode at n = 12, L = 2: evaluation (the reference and
# the port), then one local step (the reference, the port). Shots: the
# counts carry no gradient, so the reference's step runs Launch B and
# prunes C, and the port's state runs without autograd (Launch A).
# Circuit placement: the channels are barriers between layers, so the
# step runs no kernel in either package (SPSA's forwards neither).
PROBE = {
    "readout": ("A", "BC", "BC"),
    "shots": ("A", "B", "A"),
    "circuit": ("A", "", ""),
    "circuit-spsa": ("A", "", ""),
}


def _ref_probe(mp):
    calls = []
    run = rpb._run

    def counted(spec, packed, xs, with_boundaries):
        caller = sys._getframe(1).f_code.co_name
        calls.append("C" if caller == "_pallas_scan_bwd"
                     else "B" if with_boundaries else "A")
        return run(spec, packed, xs, with_boundaries)

    mp.setattr(rpb, "_run", counted)
    return calls


def _port_probe(mp):
    calls = []
    sweep = scan_body.scan_body

    def counted(packed, spec, xs, with_boundaries=False, adjoint=False):
        calls.append("C" if adjoint else "B" if with_boundaries else "A")
        return sweep(packed, spec, xs, with_boundaries, adjoint)

    mp.setattr(scan_body, "scan_body", counted)
    return calls


@pytest.mark.parametrize("mode", sorted(PROBE))
def test_route_probe(monkeypatch, mode):
    """Which scan-body launches evaluation and one local step run under
    each noise mode at n = 12, L = 2 (the reference traced with its TPU
    program shape and Pallas route, its ``_run`` counted; the port's
    ``scan_body`` calls counted on the CPU, where they take the plain
    sweep)."""
    n, b = 12, 2
    _form(monkeypatch, n, pallas="1")
    placement = "circuit" if mode.startswith("circuit") else "readout"
    shots = SHOTS if mode == "shots" else None
    # One channel (damping) under circuit placement: the launches follow
    # the per-layer structure, and tracing 2·n channel applications of
    # the reference's trajectory costs seconds each.
    rmodel, model = _models(n, placement, shots=shots, **(
        {"depolarizing_p": 0.0} if placement == "circuit" else {}))
    kw = dict(local_epochs=1, batch_size=b, learning_rate=0.1)
    if mode == "circuit-spsa":
        kw["optimizer"] = "spsa"
    rcfg, cfg = RFedConfig(**kw), FedConfig(**kw)
    params = _params(n)
    x = _features(n, b)
    y = np.array([0, 1], np.int32)
    m = np.ones(b, np.float32)
    rcalls, pcalls = _ref_probe(monkeypatch), _port_probe(monkeypatch)
    want_eval, want_ref, want_port = PROBE[mode]

    jax.make_jaxpr(rmodel.apply)(_jax(params), jnp.asarray(x))
    tparams = params_from_jax(params, device="cpu")
    with torch.no_grad():
        model.apply(tparams, x)
    assert ("".join(rcalls), "".join(pcalls)) == (want_eval, want_eval)
    rcalls.clear(), pcalls.clear()

    if mode == "readout":  # folded in both packages
        cx, cy, cm = (np.stack([a, a]) for a in (x, y, m))
        jax.make_jaxpr(rclient.make_local_update_clients(rmodel, rcfg))(
            _jax(params), jnp.asarray(cx), jnp.asarray(cy), jnp.asarray(cm),
            jax.random.split(jax.random.PRNGKey(0), 2))
        pclient.make_local_update_clients(model, cfg)(
            tparams, *(torch.as_tensor(a) for a in (cx, cy, cm)),
            perms=torch.zeros((2, 1, b), dtype=torch.int64))
    else:
        jax.make_jaxpr(rclient.make_local_update(rmodel, rcfg))(
            _jax(params), jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
            jax.random.PRNGKey(0))
        draws = RoundDraws(0, 0)
        step = (None if mode != "circuit-spsa" else trees.tree_map(
            lambda d: d[0], draws.tree("spsa_delta", tparams, 1, 1)))
        tdraws = {k: v[0] for k, v in draws.train_draws(
            model.train_draws, 1, 1, b, "cpu").items()}
        pclient.make_local_update(model, cfg)(
            tparams, *(torch.as_tensor(a) for a in (x, y, m)),
            torch.zeros((1, b), dtype=torch.int64), step_draws=step,
            train_draws=tdraws)
    assert ("".join(rcalls), "".join(pcalls)) == (want_ref, want_port)

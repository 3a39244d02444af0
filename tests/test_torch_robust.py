"""Port vs reference: robust aggregation, byzantine inputs, client
sampling and the unfolded client path (fed/robust.py, fed/sampling.py
and their branches in fed/round.py).

- ``robust_combine``, ``clip_update`` and ``trimmed_fraction_stat``
  against the reference within 1e-6, over absentees, m = 0, m even and
  odd; ``torch.sort`` puts NaN last ascending, as ``jnp.sort`` does (the
  combine's absentee rule rests on it);
- rounds under each aggregator (mean, clip_mean with a finite bound,
  trimmed_mean, median), with and without a ``byzantine`` input (a
  ``scale:100`` client, a ``sign_flip`` one and a noise one, its σ·N(0, I)
  injected), against the reference's ``make_fed_round`` within 1e-5,
  with ``clipped_clients`` and ``trimmed_fraction`` equal;
- client sampling below 1 with the reference's Bernoulli mask injected,
  alone, with survivors and with secure aggregation (the pair graph over
  sampled ∧ surviving clients; each package's masks cancel);
- a robust rule with secure aggregation raises the reference's
  ValueError;
- the unfolded client path (``QFEDX_FOLD_CLIENTS=0``) equals the folded
  one within 1e-5 on every gradient route and aggregator.

The reference runs at n = 4 in its "dot" gate form (its XLA:CPU form;
the aggregation does not depend on the width), the unfolded-path check
at n = 10 on the port alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ref_streams as streams
from qfedx_tpu.fed import robust as rrobust
from qfedx_tpu.fed.config import DPConfig as RDPConfig
from qfedx_tpu.fed.config import FedConfig as RFedConfig
from qfedx_tpu.fed.round import (
    client_mesh,
    make_fed_round as ref_make_round,
    shard_client_data,
)
from qfedx_tpu.models.vqc import make_vqc_classifier as ref_make
from qfedx_tpu.ops import fuse as rfuse
from qfedx_tpu_torch.fed import robust as probust
from qfedx_tpu_torch.fed.config import DPConfig, FedConfig
from qfedx_tpu_torch.fed.round import RoundDraws, make_fed_round
from qfedx_tpu_torch.models.vqc import make_vqc_classifier, params_from_jax
from qfedx_tpu_torch.utils import trees

COMBINE_ATOL = 1e-6
ROUND_ATOL = 1e-5
N, L, C, S, BATCH = 4, 2, 4, 8, 4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on one CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def tpu_form(monkeypatch):
    for pin in ("QFEDX_FUSE", "QFEDX_SCAN_LAYERS", "QFEDX_BATCHED",
                "QFEDX_PALLAS"):
        monkeypatch.setenv(pin, "1")
    monkeypatch.setenv("QFEDX_GATE_FORM", "dot")  # the reference, n < 10
    monkeypatch.setenv("QFEDX_SLAB_LANES", "matmul")
    monkeypatch.setattr(rfuse, "_gather_ok", lambda: True)
    monkeypatch.setattr(rfuse, "_growmat_merge_ok", lambda: True)


def _close(got, want, atol, what=""):
    for g, w in zip(trees.tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol,
                                   rtol=0, err_msg=what)


# --- the primitives -------------------------------------------------------------


def test_sort_puts_nan_last_like_jnp():
    v = np.array([[3.0, np.nan], [np.nan, -1.0], [-2.0, 5.0], [np.nan, 0.0]],
                 np.float32)
    got = torch.sort(torch.as_tensor(v), dim=0).values.numpy()
    want = np.asarray(jnp.sort(jnp.asarray(v), axis=0))
    np.testing.assert_array_equal(got, want)
    assert np.isnan(got[-2:, 0]).all() and np.isnan(got[-1, 1])


_PRESENT = {
    "odd": [1, 1, 1, 1, 1],
    "even": [1, 1, 1, 1, 1, 1],
    "absentees": [1, 0, 1, 1, 0, 1, 1],
    "one": [0, 0, 1, 0],
    "none": [0, 0, 0],
}


@pytest.mark.parametrize("trim", [0.1, 0.25, 0.4])
@pytest.mark.parametrize("present", sorted(_PRESENT))
@pytest.mark.parametrize("mode", ["trimmed_mean", "median"])
def test_robust_combine_matches_reference(mode, present, trim):
    pres = np.asarray(_PRESENT[present], np.float32)
    rng = np.random.default_rng(len(pres))
    stacked = {"a": rng.normal(size=(len(pres), 3, 5)).astype(np.float32),
               "b": {"c": rng.normal(size=(len(pres), 7)).astype(np.float32)}}
    stacked["a"][0, 0, 0] = 8.0  # an outlier, O(1) as the atol assumes
    got, gm, gtf = probust.robust_combine(
        jax.tree.map(torch.as_tensor, stacked), torch.as_tensor(pres), mode,
        trim)
    want, wm, wtf = rrobust.robust_combine(
        jax.tree.map(jnp.asarray, stacked), jnp.asarray(pres), mode, trim)
    _close(got, want, COMBINE_ATOL)
    assert float(gm) == float(wm)
    assert abs(float(gtf) - float(wtf)) <= COMBINE_ATOL
    if present == "none":
        assert all(torch.equal(v, torch.zeros_like(v))
                   for v in trees.tree_leaves(got))


@pytest.mark.parametrize("mode", ["trimmed_mean", "median", "clip_mean"])
def test_trimmed_fraction_stat_matches_reference(mode):
    for m in range(8):
        for trim in (0.0, 0.1, 0.3, 0.49):
            got = float(probust.trimmed_fraction_stat(mode, trim, m))
            want = float(rrobust.trimmed_fraction_stat(mode, trim, m))
            assert abs(got - want) <= COMBINE_ATOL, (m, trim)


@pytest.mark.parametrize("bound", [0.5, 2.0, 50.0])
def test_clip_update_matches_reference(bound):
    """Each of four stacked client trees against the reference's clip of
    that client alone: the scaled tree and the was_clipped flag."""
    rng = np.random.default_rng(7)
    deltas = [{"x": rng.normal(size=(3, 4)).astype(np.float32) * s,
               "y": {"z": rng.normal(size=(2,)).astype(np.float32) * s}}
              for s in (0.01, 0.5, 1.0, 10.0)]
    stacked = jax.tree.map(lambda *a: torch.as_tensor(np.stack(a)), *deltas)
    got, flags = probust.clip_update(stacked, bound, lead=1)
    for c, d in enumerate(deltas):
        want, flag = rrobust.clip_update(jax.tree.map(jnp.asarray, d), bound)
        _close(trees.tree_map(lambda v: v[c], got), want, COMBINE_ATOL)
        assert float(flags[c]) == float(flag)
    one, flag = probust.clip_update(trees.tree_map(lambda v: v[3], stacked),
                                    bound)
    assert float(flag) == float(flags[3])


def test_resolve_aggregator_pin(monkeypatch):
    cfg = FedConfig(aggregator="median")
    assert probust.resolve_aggregator(cfg) == "median"
    monkeypatch.setenv("QFEDX_AGG", "trimmed_mean")
    assert probust.resolve_aggregator(cfg) == "trimmed_mean"
    monkeypatch.setenv("QFEDX_AGG", "medain")
    with pytest.raises(ValueError, match="QFEDX_AGG"):
        probust.resolve_aggregator(cfg)


# --- rounds ---------------------------------------------------------------------

# (multiplier, σ) per client: honest, scale:100, sign_flip, noise.
BYZANTINE = np.array([[1.0, 0.0], [100.0, 0.0], [-1.0, 0.0], [1.0, 0.3]],
                     np.float32)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    cx = rng.uniform(0, 1, (C, S, N)).astype(np.float32)
    cy = rng.integers(0, 2, (C, S)).astype(np.int32)
    cm = np.ones((C, S), np.float32)
    cm[2, -3:] = 0.0
    return cx, cy, cm


def _rounds(monkeypatch, cfg_kw, byzantine=None, survivors=None,
            rounds=1, dp=None):
    """``rounds`` reference rounds and the port's from the same θ with
    every draw injected; returns [(port, reference)] per round."""
    rcfg = RFedConfig(local_epochs=1, batch_size=BATCH, learning_rate=0.1,
                      momentum=0.9, **cfg_kw,
                      dp=None if dp is None else RDPConfig(**dp))
    cfg = FedConfig(local_epochs=1, batch_size=BATCH, learning_rate=0.1,
                    momentum=0.9, **cfg_kw,
                    dp=None if dp is None else DPConfig(**dp))
    data = _data()
    rmodel = ref_make(N, L, 2)
    params = jax.tree.map(lambda v: np.asarray(v) * 8.0,
                          rmodel.init(jax.random.PRNGKey(0)))
    mesh = client_mesh(num_devices=1)
    monkeypatch.setenv("QFEDX_PALLAS", "0")
    rf = ref_make_round(rmodel, rcfg, mesh, num_clients=C)
    rdata = shard_client_data(mesh, *(jnp.asarray(a) for a in data))
    model = make_vqc_classifier(N, L, 2, device="cpu")
    prf = make_fed_round(model, cfg, num_clients=C)
    rp, pp = params, params_from_jax(params, device="cpu")
    tdata = [torch.as_tensor(a) for a in data]
    out = []
    for r in range(rounds):
        key = jax.random.PRNGKey(300 + r)
        rp, rst = rf(rp, *rdata, key,
                     None if survivors is None else jnp.asarray(survivors),
                     None if byzantine is None else jnp.asarray(byzantine))
        pp, pst = prf(pp, *tdata, perms=streams.perms(key, C, 1, S),
                      survivors=survivors, byzantine=byzantine,
                      sa_seed=11 + r,
                      draws=RoundDraws(0, r, streams.round_streams(
                          key, params, rcfg, C, S)))
        out.append(((pp, pst), (jax.tree.map(np.asarray, rp), rst)))
    return out


def _check(got, want, atol=ROUND_ATOL):
    (gp, gs), (wp, ws) = got, want
    _close(gp, wp, atol, "theta")
    assert abs(float(gs.mean_loss) - float(ws.mean_loss)) <= atol
    assert abs(float(gs.total_weight) - float(ws.total_weight)) <= 1e-6
    for field in ("num_participants", "rejected_updates", "dropped_clients",
                  "applied", "clipped_clients"):
        assert float(getattr(gs, field)) == float(getattr(ws, field)), field
    assert abs(float(gs.trimmed_fraction) - float(ws.trimmed_fraction)
               ) <= 1e-7


_AGGS = {
    "mean": {},
    "clip_mean": dict(aggregator="clip_mean", clip_bound=0.05),
    "trimmed_mean": dict(aggregator="trimmed_mean", trim_fraction=0.25),
    "median": dict(aggregator="median"),
}


@pytest.mark.parametrize("attack", [False, True], ids=["honest", "byzantine"])
@pytest.mark.parametrize("agg", sorted(_AGGS))
def test_aggregator_round_matches_reference(monkeypatch, agg, attack):
    [(got, want)] = _rounds(monkeypatch, _AGGS[agg],
                            byzantine=BYZANTINE if attack else None)
    _check(got, want)
    if agg == "clip_mean":
        assert float(got[1].clipped_clients) >= (3.0 if attack else 1.0)
    if agg == "trimmed_mean":
        assert float(got[1].trimmed_fraction) == 0.5


def test_robust_rules_bound_the_attackers_pull():
    """Under attack, θ after a median, trimmed_mean or clip_mean round is
    closer to the honest round's θ than plain mean's (the defense
    works; port only, the same draws in every round)."""
    model = make_vqc_classifier(N, L, 2, device="cpu")
    params = trees.tree_map(lambda v: v * 8.0, model.init(0))
    data = [torch.as_tensor(a) for a in _data()]

    def theta(agg, byzantine):
        rf = make_fed_round(model, FedConfig(
            local_epochs=1, batch_size=BATCH, learning_rate=0.1,
            **_AGGS[agg]), num_clients=C)
        return rf(params, *data, generator=torch.Generator().manual_seed(0),
                  byzantine=byzantine, draws=RoundDraws(0, 0))[0]

    def dist(a, b):
        return sum(float(torch.sum((x - y) ** 2)) for x, y in zip(
            trees.tree_leaves(a), trees.tree_leaves(b))) ** 0.5

    honest = theta("mean", None)
    pull = {agg: dist(theta(agg, BYZANTINE), honest)
            for agg in ("mean", "median", "trimmed_mean", "clip_mean")}
    for agg in ("median", "trimmed_mean", "clip_mean"):
        assert pull[agg] < pull["mean"], pull


@pytest.mark.parametrize("case", ["alone", "survivors", "secure-agg", "dp",
                                  "median"])
def test_sampling_below_one_matches_reference(monkeypatch, case):
    """client_fraction = 0.5 with the reference's Bernoulli mask (clients
    0–2 of 4 at this round key) equals the reference's round."""
    kw = dict(client_fraction=0.5)
    extra = {}
    if case == "survivors":
        extra["survivors"] = np.array([1, 1, 0, 1], np.float32)
    elif case == "secure-agg":
        kw["secure_agg"] = True
    elif case == "dp":
        extra["dp"] = dict(clip_norm=0.5, noise_multiplier=0.8)
    elif case == "median":
        kw["aggregator"] = "median"
    [(got, want)] = _rounds(monkeypatch, kw, **extra)
    _check(got, want)
    # The round sampled a strict subset (else this would not test it).
    mask = streams.participation(jax.random.PRNGKey(300), C, 0.5)
    assert 0 < mask.sum() < C


def test_port_draws_its_own_participation():
    """Without injection the port draws Bernoulli(p) from (seed, round):
    the same mask for the same round, another for another round, and
    about p·C clients over many rounds."""
    masks = [RoundDraws(4, r).participation(64, 0.3) for r in range(20)]
    assert np.array_equal(masks[0], RoundDraws(4, 0).participation(64, 0.3))
    assert not np.array_equal(masks[0], masks[1])
    assert 0.25 < np.mean(masks) < 0.35
    assert set(np.unique(masks)) <= {0.0, 1.0}


@pytest.mark.parametrize("agg", ["trimmed_mean", "median"])
def test_robust_rule_with_secure_agg_raises_as_reference(agg):
    kw = dict(secure_agg=True, aggregator=agg)
    with pytest.raises(ValueError) as want:
        ref_make_round(ref_make(N, L, 2), RFedConfig(**kw),
                       client_mesh(num_devices=1), num_clients=C)
    with pytest.raises(ValueError) as got:
        make_fed_round(make_vqc_classifier(N, L, 2, device="cpu"),
                       FedConfig(**kw), num_clients=C)
    assert str(got.value).split(" Use ")[0] == str(want.value).split(
        " Use ")[0]


# --- folded vs unfolded (port only, n = 10) --------------------------------------

_ROUTES = {
    "sgd": dict(learning_rate=0.1, momentum=0.9),
    "adam-fedprox": dict(optimizer="adam", learning_rate=0.05,
                         algorithm="fedprox", prox_mu=0.2),
    "spsa": dict(optimizer="spsa", learning_rate=0.1),
    "dp-client": dict(learning_rate=0.1, dp=DPConfig(clip_norm=0.5)),
    "dp-example": dict(learning_rate=0.1, dp=DPConfig(mode="example")),
    "median-byzantine": dict(learning_rate=0.1, aggregator="median"),
}


@pytest.mark.parametrize("route", sorted(_ROUTES))
def test_unfolded_path_equals_folded(monkeypatch, route):
    n = 10
    rng = np.random.default_rng(5)
    data = [torch.as_tensor(rng.uniform(0, 1, (C, S, n)).astype(np.float32)),
            torch.as_tensor(rng.integers(0, 2, (C, S))),
            torch.ones(C, S)]
    model = make_vqc_classifier(n, L, 2, device="cpu")
    params = trees.tree_map(lambda v: v * 8.0, model.init(0))
    cfg = FedConfig(local_epochs=1, batch_size=BATCH, **_ROUTES[route])
    byz = BYZANTINE if route.endswith("byzantine") else None
    out = []
    for fold in ("1", "0"):
        monkeypatch.setenv("QFEDX_FOLD_CLIENTS", fold)
        rf = make_fed_round(model, cfg, num_clients=C)
        out.append(rf(params, *data, generator=torch.Generator().manual_seed(
            3), byzantine=byz, draws=RoundDraws(1, 0)))
    (fp, fs), (up, us) = out
    for a, b in zip(trees.tree_leaves(fp), trees.tree_leaves(up)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ROUND_ATOL,
                                   rtol=0)
    assert abs(float(fs.mean_loss) - float(us.mean_loss)) <= ROUND_ATOL
    assert float(fs.num_participants) == float(us.num_participants)


# --- the CLI runs every federation flag of the resident round --------------------

_CLI_FLAGS = {
    "dp-client": ["--dp-clip", "1.0", "--dp-sigma", "1.0"],
    "dp-example": ["--dp-clip", "1.0", "--dp-sigma", "1.4", "--dp-mode",
                   "example"],
    "clip-mean": ["--aggregator", "clip_mean", "--clip-bound", "0.05"],
    "trimmed-mean": ["--aggregator", "trimmed_mean", "--trim-fraction",
                     "0.25"],
    "median": ["--aggregator", "median"],
    "sampling": ["--client-fraction", "0.6"],
    "sampling-secure-agg": ["--client-fraction", "0.5", "--secure-agg"],
    "spsa": ["--optimizer", "spsa"],
}


@pytest.mark.parametrize("flags", sorted(_CLI_FLAGS))
def test_cli_runs_federation_flags(monkeypatch, tmp_path, flags):
    """``train`` with each flag runs (n = 4, 4 clients, 2 rounds) and its
    rows say so: ε under DP (the summary's final_epsilon too), the rule's
    ledger under clip_mean and the robust rules."""
    import functools
    import json

    from qfedx_tpu_torch.run import cli as pcli
    from qfedx_tpu_torch.run import config as pconfig

    monkeypatch.setattr(pcli, "DataConfig", functools.partial(
        pconfig.DataConfig, synthetic_train=128, synthetic_test=64))
    argv = ["train", "--model", "vqc", "--qubits", "4", "--layers", "1",
            "--classes", "0,1", "--clients", "4", "--rounds", "2",
            "--local-epochs", "1", "--batch-size", "8", "--run-root",
            str(tmp_path), "--name", "f", *_CLI_FLAGS[flags]]
    summary = pcli.main(argv, device="cpu")
    rows = [json.loads(line) for line in
            (tmp_path / "f" / "metrics.jsonl").read_text().splitlines()]
    assert [r["round"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in rows)
    if flags.startswith("dp"):
        eps = [r["epsilon"] for r in rows]
        assert eps[0] < eps[1] and summary["final_epsilon"] == eps[1]
        assert np.isfinite(summary["final_epsilon"])
    else:
        assert summary["final_epsilon"] is None
    agg = {"clip-mean": "clip_mean", "trimmed-mean": "trimmed_mean",
           "median": "median"}.get(flags)
    if agg is not None:
        assert all(r["aggregator"] == agg for r in rows)
        key = "clipped_clients" if agg == "clip_mean" else "trimmed_fraction"
        assert all(key in r for r in rows)

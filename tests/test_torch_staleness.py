"""Port vs reference: the streamed trainer
(qfedx_tpu_torch/run/trainer.py ``train_federated_streamed``) with its
waves, dropped waves and staleness buffer.

Both packages train on one ``ArrayRegistry`` (n = 4, L = 1, the
reference in its "dot" form); the port starts from the reference's
init and takes its shuffles and draws (``tests/_torch_ref_streams.py``:
``perms_for_round``/``draws_for_round`` over the cohort, keyed as the
reference keys round r). Each case compares θ (``THETA_ATOL``; with
secure aggregation the two packages' masks are other numbers, and what
they leave is within it) and every per-round ledger key: the counts,
the staleness ledger, the aggregator's, ε (bit for bit) exactly, the
loss within ``THETA_ATOL``, the final evaluation within one sample.

Cases, mirroring ``tests/test_stream.py`` and ``tests/test_staleness.py``:
one wave ≡ the port's resident trainer (bit for bit); depth invariance
(bit for bit) and the wave split; resume replays identically; ε at the
global cohort's q; QFEDX_HIER=off needs one wave; QFEDX_STALE without
stragglers ≡ off; a buffered straggler folded into the next round at
age 1 (mean with ring masks, median); at lr = 0 a straggler leaves θ
where it started; an over-age straggler discarded; a dead wave under
ring masks ≡ the round with its clients as non-survivors and no masks;
a ``KeyboardInterrupt`` from ``on_round_end`` drains and checkpoints;
QFEDX_STALE needs the hierarchy and the guards; the CLI's staleness
flags reach ``FedConfig`` as the reference's do.

Lateness comes only from registries gated by a ``threading.Event``
(the reference's own wall-clock straggler test is flaky): the gated
wave's fetch blocks until the test releases it from ``on_round_end``,
so the consumer's ``wave_deadline_s`` always expires first.
"""

import threading

import jax
import numpy as np
import pytest
import torch

import _torch_ref_streams as streams
from qfedx_tpu.data.stream import ArrayRegistry as RArrayRegistry
from qfedx_tpu.fed.config import DPConfig as RDPConfig
from qfedx_tpu.fed.config import FedConfig as RFedConfig
from qfedx_tpu.fed.round import client_mesh
from qfedx_tpu.models.vqc import make_vqc_classifier as ref_make
from qfedx_tpu.ops import fuse as rfuse
from qfedx_tpu.run.trainer import train_federated_streamed as ref_streamed
from qfedx_tpu_torch.data.stream import ArrayRegistry
from qfedx_tpu_torch.fed.config import DPConfig, FedConfig
from qfedx_tpu_torch.fed.round import RoundDraws, make_fed_round
from qfedx_tpu_torch.models.vqc import make_vqc_classifier, params_from_jax
from qfedx_tpu_torch.run import checkpoint as pckpt
from qfedx_tpu_torch.run.trainer import (
    train_federated,
    train_federated_streamed,
)
from qfedx_tpu_torch.utils import trees

THETA_ATOL = 1e-5  # SGD rounds, port vs reference (and masks' residue)
DEADLINE_S = 0.5  # the consumer's wave deadline; gated waves always miss it
C, S, N, L, E, BATCH = 16, 4, 4, 1, 1, 2
EXACT_KEYS = ("round", "cohort", "waves", "participants", "dropped_clients",
              "rejected_updates", "dropped_waves", "skipped", "late_waves",
              "stale_partials_applied", "stale_discarded_waves",
              "aggregator", "clipped_clients", "trimmed_fraction", "epsilon",
              "n")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on one CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def small_form(monkeypatch):
    for pin in ("QFEDX_FUSE", "QFEDX_SCAN_LAYERS", "QFEDX_BATCHED"):
        monkeypatch.setenv(pin, "1")
    monkeypatch.setenv("QFEDX_PALLAS", "0")
    monkeypatch.setenv("QFEDX_GATE_FORM", "dot")
    monkeypatch.setenv("QFEDX_SLAB_LANES", "matmul")
    monkeypatch.setattr(rfuse, "_gather_ok", lambda: True)
    monkeypatch.setattr(rfuse, "_growmat_merge_ok", lambda: True)
    for pin in ("QFEDX_STALE", "QFEDX_HIER", "QFEDX_GUARDS", "QFEDX_STREAM"):
        monkeypatch.delenv(pin, raising=False)


def _data(clients=C, seed=7):
    rng = np.random.default_rng(seed)
    cx = rng.uniform(0, 1, (clients, S, N)).astype(np.float32)
    cy = (cx.mean(axis=2) > 0.5).astype(np.int32)
    cm = np.ones((clients, S), dtype=np.float32)
    return cx, cy, cm


def _test_set():
    rng = np.random.default_rng(9)
    tx = rng.uniform(0, 1, (32, N)).astype(np.float32)
    return tx, (tx.mean(axis=1) > 0.5).astype(np.int32)


class Gated:
    """A registry over packed arrays whose fetch of the wave starting at
    cohort client ``first_id`` blocks while ``armed`` is set, until
    ``release`` is; ``fail_from`` makes every fetch of that wave raise."""

    def __init__(self, data, first_id=None, fail=False):
        self.cx, self.cy, self.cm = data
        self.num_clients = len(self.cx)
        self.first_id, self.fail = first_id, fail
        self.armed, self.release = threading.Event(), threading.Event()

    def batch(self, ids):
        if self.first_id is not None and ids[0] == self.first_id:
            if self.fail:
                raise RuntimeError("registry shard down")
            if self.armed.is_set():
                assert self.release.wait(60), "the test never released"
        return self.cx[ids], self.cy[ids], self.cm[ids]


def _cfgs(**kw):
    dp = kw.pop("dp", None)
    base = dict(local_epochs=E, batch_size=BATCH, learning_rate=0.1,
                momentum=0.9)
    base.update(kw)
    return (RFedConfig(**base, dp=None if dp is None else RDPConfig(**dp)),
            FedConfig(**base, dp=None if dp is None else DPConfig(**dp)))


def _pair(cfg_kw, *, cohort=C, wave=4, rounds=2, seed=3, registry=None,
          hooks=None, ref=True, clients=C, **run_kw):
    """The streamed run in both packages (the reference only when
    ``ref``): [(θ, rows)] port first. ``registry`` makes a fresh
    registry per package; ``hooks(rows, reg)`` its on_round_end."""
    rcfg, cfg = _cfgs(**cfg_kw)
    data = _data(clients)
    tx, ty = _test_set()
    rmodel = ref_make(N, L, 2)
    init_key, rkb = jax.random.split(jax.random.PRNGKey(seed))
    init = jax.tree.map(np.asarray, rmodel.init(init_key))
    kw = dict(cohort_size=cohort, wave_size=wave, num_rounds=rounds,
              seed=seed, eval_every=rounds + 1, **run_kw)
    out = []
    for port in (True, False) if ref else (True,):
        reg = registry(data) if registry else (
            ArrayRegistry if port else RArrayRegistry)(*data)
        rows = []
        hook = (lambda r, m, rows=rows, reg=reg: (
            rows.append(m), hooks and hooks(r, rows, reg)))
        if port:
            res = train_federated_streamed(
                make_vqc_classifier(N, L, 2, device="cpu"), cfg, reg, tx, ty,
                on_round_end=hook, params=params_from_jax(init,
                                                          device="cpu"),
                perms_for_round=lambda r: streams.perms(
                    jax.random.fold_in(rkb, r), cohort, E, S),
                draws_for_round=lambda r: streams.round_streams(
                    jax.random.fold_in(rkb, r), init, rcfg, cohort, S),
                **kw)
            theta = [t.numpy() for t in trees.tree_leaves(res.params)]
        else:
            res = ref_streamed(rmodel, rcfg, reg, tx, ty, on_round_end=hook,
                               mesh=client_mesh(num_devices=1), **kw)
            theta = [np.asarray(t) for t in jax.tree.leaves(res.params)]
        out.append((theta, rows, res))
    return out


def _same(got, want, atol=THETA_ATOL):
    (gt, grows, gres), (wt, wrows, wres) = got, want
    for g, w in zip(gt, wt):
        np.testing.assert_allclose(g, w, atol=atol, rtol=0)
    assert len(grows) == len(wrows)
    for g, w in zip(grows, wrows):
        assert set(g) == set(w) - {"phases", "mem_bytes_in_use"}, (g, w)
        for k in EXACT_KEYS:
            assert g.get(k) == w.get(k), (k, g, w)
        np.testing.assert_allclose(g["loss"], w["loss"], atol=atol, rtol=0)
        if "accuracy" in w:
            assert abs(g["accuracy"] - w["accuracy"]) <= 1.0 / w["n"]
    assert gres.epsilons == wres.epsilons
    np.testing.assert_allclose(gres.comm_mb_per_round,
                               wres.comm_mb_per_round, rtol=1e-12)


# --- the plain paths -------------------------------------------------------------


def test_one_wave_equals_the_resident_trainer():
    """Bit for bit on the same arrays (Adam, sampling, ring masks), as
    the reference's one-wave run equals its resident trainer."""
    cx, cy, cm = _data()
    tx, ty = _test_set()
    model = make_vqc_classifier(N, L, 2, device="cpu")
    _, cfg = _cfgs(optimizer="adam", client_fraction=0.5, secure_agg=True)
    flat = train_federated(model, cfg, cx, cy, cm, tx, ty, num_rounds=2,
                           seed=5)
    streamed = train_federated_streamed(
        model, cfg, ArrayRegistry(cx, cy, cm), tx, ty, cohort_size=C,
        num_rounds=2, seed=5, device="cpu")
    for a, b in zip(trees.tree_leaves(flat.params),
                    trees.tree_leaves(streamed.params)):
        assert torch.equal(a, b)
    assert flat.losses == streamed.losses
    assert flat.accuracies == streamed.accuracies


def test_one_wave_matches_reference():
    _same(*_pair(dict(client_fraction=0.5, aggregator="clip_mean",
                      clip_bound=0.05), wave=C))


def test_depth_invariance_and_wave_split():
    cfg_kw = dict(secure_agg=True, client_fraction=0.5)
    d0, ref = _pair(cfg_kw, stream_depth=0)
    d2, = _pair(cfg_kw, stream_depth=2, ref=False)
    for a, b in zip(d0[0], d2[0]):
        np.testing.assert_array_equal(a, b)
    _same(d0, ref)
    whole, = _pair(cfg_kw, wave=C, ref=False)
    for a, b in zip(whole[0], d0[0]):
        np.testing.assert_allclose(a, b, atol=THETA_ATOL, rtol=0)
    assert d0[2].comm_mb_per_round == pytest.approx(
        whole[2].comm_mb_per_round * 5 / 2)


def test_resume_replays_identically(tmp_path):
    """Cohorts of 8 from 16 clients: rounds 0–3 straight equal rounds
    0–1, a restore and rounds 2–3, and the reference's straight run."""
    kw = dict(cohort=8, wave=4)
    straight, ref = _pair({}, rounds=4, **kw)
    _same(straight, ref)
    _pair({}, rounds=2, ref=False,
          checkpointer=pckpt.Checkpointer(tmp_path / "ck", every=2), **kw)
    resumed, = _pair({}, rounds=4, ref=False,
                     checkpointer=pckpt.Checkpointer(tmp_path / "ck",
                                                     every=2), **kw)
    for a, b in zip(straight[0], resumed[0]):
        np.testing.assert_array_equal(a, b)
    assert [r["round"] for r in resumed[1]] == [3, 4]
    assert resumed[1] == [dict(r, time_s=q["time_s"]) for r, q in
                          zip(straight[1][2:], resumed[1])]


def test_epsilon_at_the_global_cohort():
    """Client DP under registry sampling: ε at q = fraction · cohort /
    registry, equal to the reference's, below a cohort = registry run's."""
    kw = dict(client_fraction=0.5, dp=dict(clip_norm=1.0,
                                           noise_multiplier=1.0))
    sub, ref = _pair(kw, cohort=8, wave=8, clients=32)
    _same(sub, ref)
    full, = _pair(kw, cohort=32, wave=8, clients=32, ref=False)
    assert len(sub[2].epsilons) == 2
    assert sub[2].epsilons[-1] < full[2].epsilons[-1]


def _refused(match, wave):
    """Both packages refuse the streamed run before training."""
    for port in (True, False):
        with pytest.raises(ValueError, match=match):
            if port:
                train_federated_streamed(
                    make_vqc_classifier(N, L, 2, device="cpu"), FedConfig(),
                    ArrayRegistry(*_data()), None, None, cohort_size=C,
                    wave_size=wave, num_rounds=1)
            else:
                ref_streamed(ref_make(N, L, 2), RFedConfig(),
                             RArrayRegistry(*_data()), None, None,
                             cohort_size=C, wave_size=wave, num_rounds=1,
                             mesh=client_mesh(num_devices=1))


def test_hier_off_needs_one_wave(monkeypatch):
    monkeypatch.setenv("QFEDX_HIER", "off")
    _refused("QFEDX_HIER", 4)
    _same(*_pair(dict(secure_agg=True), wave=C))


# --- staleness --------------------------------------------------------------------


@pytest.mark.parametrize("cfg_kw,exact", [
    ({}, True),
    (dict(dp=dict(clip_norm=1.0, noise_multiplier=0.5),
          client_fraction=0.5), True),
    (dict(secure_agg=True), False),
    (dict(aggregator="trimmed_mean", trim_fraction=0.25), True),
], ids=["plain", "dp", "ring", "trimmed_mean"])
def test_stale_on_without_stragglers_matches_off(monkeypatch, cfg_kw, exact):
    off, = _pair(dict(cfg_kw), ref=False)
    monkeypatch.setenv("QFEDX_STALE", "1")
    on, ref = _pair(dict(cfg_kw), wave_deadline_s=30.0)
    _same(on, ref)
    for a, b in zip(off[0], on[0]):
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, atol=THETA_ATOL, rtol=0)
    assert off[2].epsilons == on[2].epsilons
    assert [r["late_waves"] for r in on[1]] == [0, 0]


def _hold_round_1(r, rows, reg):
    """Arm the gate for round 1, release it when round 1 ends."""
    if r == 0:
        reg.armed.set()
    elif r == 1:
        reg.armed.clear()
        reg.release.set()


def _gated(data):
    return Gated(data, first_id=12)


@pytest.mark.parametrize("cfg_kw", [dict(secure_agg=True),
                                    dict(aggregator="median")],
                         ids=["mean-ring", "median"])
def test_buffered_straggler_folds_in_next_round(monkeypatch, cfg_kw):
    monkeypatch.setenv("QFEDX_STALE", "1")
    got, want = _pair(cfg_kw, rounds=3, registry=_gated, hooks=_hold_round_1,
                      wave_deadline_s=DEADLINE_S, stale_poll_s=30.0)
    _same(got, want)
    rows = got[1]
    assert [r["late_waves"] for r in rows] == [0, 1, 0]
    assert [r["stale_partials_applied"] for r in rows] == [0, 0, 1]
    assert [r["participants"] for r in rows] == [16, 12, 20]
    assert all(r["dropped_clients"] == 0 for r in rows)


def test_lr0_straggler_leaves_theta_unchanged(monkeypatch):
    monkeypatch.setenv("QFEDX_STALE", "1")
    cfg_kw = dict(learning_rate=0.0, momentum=0.0, secure_agg=True,
                  secure_agg_scale=4.0)
    got, want = _pair(cfg_kw, rounds=3, registry=_gated, hooks=_hold_round_1,
                      wave_deadline_s=DEADLINE_S, stale_poll_s=30.0)
    _same(got, want)
    assert got[1][2]["stale_partials_applied"] == 1
    init_key, _ = jax.random.split(jax.random.PRNGKey(3))
    init = jax.tree.map(np.asarray, ref_make(N, L, 2).init(init_key))
    for a, b in zip(got[0], jax.tree.leaves(init)):
        np.testing.assert_allclose(a, b, atol=THETA_ATOL, rtol=0)


def test_overage_straggler_is_discarded(monkeypatch):
    monkeypatch.setenv("QFEDX_STALE", "1")

    def gated(data):
        reg = Gated(data, first_id=12)
        reg.armed.set()  # round 0's last wave never arrives in time
        return reg

    def hold(r, rows, reg):
        reg.armed.clear()  # round 1's fetch of the same clients is prompt
        if r == 1:  # round 1 has discarded it: let the thread go
            reg.release.set()

    got, want = _pair(dict(staleness_max_age=1), rounds=2, registry=gated,
                      hooks=hold,
                      wave_deadline_s=DEADLINE_S, stale_poll_s=0.2)
    _same(got, want)
    rows = got[1]
    assert rows[0]["late_waves"] == 1
    assert rows[1]["stale_partials_applied"] == 0
    assert rows[1]["stale_discarded_waves"] == 1
    assert rows[1]["dropped_clients"] == 4


def test_dead_wave_under_ring_masks_equals_the_survivor_round():
    """A wave whose fetch fails for good is dropped; the server adds the
    dead clients' regenerated masks back, so θ equals the round with
    those clients as non-survivors and no masks at all."""
    cfg_kw = dict(secure_agg=True, client_fraction=0.75)
    got, want = _pair(cfg_kw, rounds=1,
                      registry=lambda d: Gated(d, first_id=4, fail=True))
    _same(got, want)
    row = got[1][0]
    assert row["dropped_waves"] == 1
    rcfg, cfg = _cfgs(**cfg_kw)
    init_key, rkb = jax.random.split(jax.random.PRNGKey(3))
    init = jax.tree.map(np.asarray, ref_make(N, L, 2).init(init_key))
    key = jax.random.fold_in(rkb, 0)
    draws = RoundDraws(3, 0, streams.round_streams(key, init, rcfg, C, S))
    part = draws.participation(C, 0.75)
    assert row["dropped_clients"] == int(part[4:8].sum()) > 0
    survivors = np.ones(C, np.float32)
    survivors[4:8] = 0.0
    _, plain = _cfgs(client_fraction=0.75)
    theta, stats = make_fed_round(make_vqc_classifier(N, L, 2, device="cpu"),
                                  plain, num_clients=C)(
        params_from_jax(init, device="cpu"),
        *(torch.as_tensor(a) for a in _data()),
        perms=streams.perms(key, C, E, S), survivors=survivors, draws=draws)
    for a, b in zip(got[0], trees.tree_leaves(theta)):
        np.testing.assert_allclose(a, b.numpy(), atol=THETA_ATOL, rtol=0)
    assert row["participants"] == int(stats.num_participants)


def test_keyboard_interrupt_drains_and_checkpoints(tmp_path):
    def interrupt(r, rows, reg):
        if r == 1:
            raise KeyboardInterrupt

    straight, ref = _pair({}, rounds=4)
    _same(straight, ref)
    # Uploaders of other tests in this process may still be finishing.
    before = set(threading.enumerate())
    with pytest.raises(KeyboardInterrupt):
        _pair({}, rounds=4, ref=False, hooks=interrupt,
              checkpointer=pckpt.Checkpointer(tmp_path / "ck", every=100))
    assert not [t for t in threading.enumerate() if t not in before
                and t.name == "qfedx-ingest" and t.is_alive()]
    ck = pckpt.Checkpointer(tmp_path / "ck", every=100)
    assert ck._rounds() == [1]  # the last completed round, saved at once
    ck.verify(1)
    resumed, = _pair({}, rounds=4, ref=False,
                     checkpointer=pckpt.Checkpointer(tmp_path / "ck",
                                                     every=100))
    for a, b in zip(straight[0], resumed[0]):
        np.testing.assert_array_equal(a, b)


def test_stale_needs_hier_and_guards(monkeypatch):
    monkeypatch.setenv("QFEDX_STALE", "1")
    monkeypatch.setenv("QFEDX_HIER", "off")
    _refused("QFEDX_STALE", C)
    monkeypatch.delenv("QFEDX_HIER")
    monkeypatch.setenv("QFEDX_GUARDS", "off")
    _refused("QFEDX_GUARDS", 4)


def test_cli_staleness_flags_reach_fed_config():
    from qfedx_tpu.run import cli as rcli
    from qfedx_tpu_torch.run import cli as pcli

    argv = ["train", "--staleness-mode", "poly", "--staleness-alpha", "2.0",
            "--staleness-max-age", "3"]
    got = pcli.config_from_args(pcli.build_parser().parse_args(argv)).fed
    want = rcli.config_from_args(rcli.build_parser().parse_args(argv)).fed
    assert (got.staleness_mode, got.staleness_alpha,
            got.staleness_max_age) == ("poly", 2.0, 3)
    assert (got.staleness_mode, got.staleness_alpha,
            got.staleness_max_age) == (want.staleness_mode,
                                       want.staleness_alpha,
                                       want.staleness_max_age)
    pcli._refuse_unported_train_flags(pcli.build_parser().parse_args(argv))

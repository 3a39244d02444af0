"""Port vs reference: the streamed trainer under fault plans
(qfedx_tpu_torch/run/trainer.py ``train_federated_streamed(fault_plan=)``).

- The reference's chaos smoke run (``tests/test_faults.py::
  test_chaos_smoke_streamed_run``: n = 3, L = 2, Adam, 8 clients in
  waves of 4, ring masks, clip_mean at 5.0; every round client 3 drops,
  client 5's data goes NaN, client 6 scales its upload ×1000, client 2
  trains on flipped labels, and round 1's first fetch fails once) runs
  through both packages, the reference's init, shuffles and draws
  injected into the port. Every row's casualty ledger is equal, and
  equal to the plan's counts. Under the reference's Adam both runs
  converge as the reference asks; θ is held (each round's checkpoint,
  written by both packages in one format, within ``THETA_ATOL``) on the
  same run under SGD with momentum. Under Adam it cannot be: the last
  layer's rz has a zero gradient, and Adam steps it by ±lr on each
  package's rounding noise (``tests/test_torch_fed.py``); the ×1000
  client's upload carries those steps ×1000 into its norm, so its
  clip_mean factor, and through it every leaf of θ, differs far beyond
  ``THETA_ATOL``.
- (n = 12 in a wave of 32 on the kernel route: ``tests/
  test_torch_chaos_kernel.py``.)
- QFEDX_STALE with the reference's straggler plan (``tests/
  test_staleness.py:71``: wave 1 of round 1 delayed far past the
  deadline) gives the reference's late/folded counts and θ.
- A wave killed by a persistent fetch fault beside planned drops, under
  ring masks: the reference's ledger and θ.
- ε is the same with and without injected drops, in both packages.
- A plan under QFEDX_GUARDS=off is refused by both.
"""

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
from qfedx_tpu.run.checkpoint import Checkpointer as RCheckpointer
from qfedx_tpu.run.trainer import train_federated_streamed as ref_streamed
from qfedx_tpu.utils.faults import FaultPlan as RFaultPlan
from qfedx_tpu_torch.data.stream import ArrayRegistry
from qfedx_tpu_torch.fed.config import DPConfig, FedConfig
from qfedx_tpu_torch.models.vqc import make_vqc_classifier, params_from_jax
from qfedx_tpu_torch.run.checkpoint import Checkpointer
from qfedx_tpu_torch.run.trainer import train_federated_streamed
from qfedx_tpu_torch.utils import trees
from qfedx_tpu_torch.utils.faults import FaultPlan

THETA_ATOL = 1e-5  # SGD rounds (tests/test_torch_staleness.py)
LEDGER = ("round", "cohort", "waves", "participants", "dropped_clients",
          "rejected_updates", "dropped_waves", "skipped", "late_waves",
          "stale_partials_applied", "stale_discarded_waves", "aggregator",
          "clipped_clients", "trimmed_fraction", "epsilon", "n")

CHAOS_RULES = [
    {"site": "client.compute", "kind": "drop", "clients": [3]},
    {"site": "client.compute", "kind": "nan", "clients": [5]},
    {"site": "client.byzantine", "kind": "scale:1000", "clients": [6]},
    {"site": "client.byzantine", "kind": "label_flip", "clients": [2]},
    {"site": "registry.fetch", "rounds": [1], "waves": [0], "times": 1},
]
# tests/test_staleness.py:71, with the deadline below its delay.
STRAGGLER_RULES = [
    {"site": "wave.delay", "kind": "delay:0.5", "rounds": [1],
     "waves": [1]},
]
STRAGGLER_DEADLINE_S = 0.3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on one CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _form(mp, n, pallas="0"):
    """The reference's program shape for width ``n``."""
    for pin in ("QFEDX_FUSE", "QFEDX_SCAN_LAYERS", "QFEDX_BATCHED"):
        mp.setenv(pin, "1")
    mp.setenv("QFEDX_PALLAS", pallas)
    mp.setenv("QFEDX_GATE_FORM", "dot" if n < 10 else "flip")
    mp.setenv("QFEDX_SLAB_LANES", "matmul")
    mp.setattr(rfuse, "_gather_ok", lambda: True)
    mp.setattr(rfuse, "_growmat_merge_ok", lambda: True)


@pytest.fixture(autouse=True)
def small_form(monkeypatch):
    _form(monkeypatch, 3)
    for pin in ("QFEDX_STALE", "QFEDX_HIER", "QFEDX_GUARDS", "QFEDX_STREAM",
                "QFEDX_FAULTS"):
        monkeypatch.delenv(pin, raising=False)


def _data(clients, samples, n, seed=7):
    rng = np.random.default_rng(seed)
    cx = rng.uniform(0, 1, (clients, samples, n)).astype(np.float32)
    cy = (cx.mean(axis=2) > 0.5).astype(np.int32)
    cm = np.ones((clients, samples), dtype=np.float32)
    return cx, cy, cm


def _test_set(n, seed=9):
    rng = np.random.default_rng(seed)
    tx = rng.uniform(0, 1, (64, n)).astype(np.float32)
    return tx, (tx.mean(axis=1) > 0.5).astype(np.int32)


def _run_pair(cfg_kw, rules, *, n, layers, clients, samples, wave, rounds,
              seed=2, tmp_path=None, dp=None, **run_kw):
    """The streamed run under ``rules`` in both packages: [(θ per round
    or None, rows, result)], port first. With ``tmp_path`` both packages
    checkpoint every round and θ per round is read back from disk."""
    rcfg = RFedConfig(**cfg_kw, dp=None if dp is None else RDPConfig(**dp))
    cfg = FedConfig(**cfg_kw, dp=None if dp is None else DPConfig(**dp))
    data = _data(clients, samples, n)
    tx, ty = _test_set(n)
    rmodel = ref_make(n, layers, 2)
    init_key, rkb = jax.random.split(jax.random.PRNGKey(seed))
    init = jax.tree.map(np.asarray, rmodel.init(init_key))
    kw = dict(cohort_size=clients, wave_size=wave, num_rounds=rounds,
              seed=seed, eval_every=rounds, **run_kw)
    out = []
    for port in (True, False):
        rows = []
        ck = None
        if tmp_path is not None:
            ck = (Checkpointer if port else RCheckpointer)(
                tmp_path / ("port" if port else "ref"), every=1, keep=rounds)
        plan = None if rules is None else (
            FaultPlan if port else RFaultPlan)(seed=0, rules=rules)
        if port:
            res = train_federated_streamed(
                make_vqc_classifier(n, layers, 2, device="cpu"), cfg,
                ArrayRegistry(*data), tx, ty, fault_plan=plan,
                on_round_end=lambda r, m: rows.append(m), checkpointer=ck,
                params=params_from_jax(init, device="cpu"),
                perms_for_round=lambda r: streams.perms(
                    jax.random.fold_in(rkb, r), clients, cfg.local_epochs,
                    samples),
                draws_for_round=lambda r: streams.round_streams(
                    jax.random.fold_in(rkb, r), init, rcfg, clients,
                    samples),
                **kw)
        else:
            res = ref_streamed(rmodel, rcfg, RArrayRegistry(*data), tx, ty,
                               fault_plan=plan,
                               on_round_end=lambda r, m: rows.append(m),
                               checkpointer=ck,
                               mesh=client_mesh(num_devices=1), **kw)
        thetas = None
        if ck is not None:
            ck.wait()
            thetas = []
            for r in range(1, rounds + 1):
                with np.load(ck.dir / f"ckpt_{r:06d}.npz") as z:
                    thetas.append([z[f"arr_{i}"] for i in range(len(z))])
        out.append((thetas, rows, res))
    return out, init


def _leaf_names(init):
    return ["/".join(str(getattr(k, "key", k)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(init)[0]]


def _same_rows(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) - {"phases", "mem_bytes_in_use"}, (g, w)
        for k in LEDGER:
            assert g.get(k) == w.get(k), (k, g, w)


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_chaos_smoke_matches_reference(tmp_path, optimizer):
    n, clients, rounds = 3, 8, 8
    cfg_kw = dict(local_epochs=2, batch_size=8, learning_rate=0.1,
                  optimizer=optimizer, secure_agg=True,
                  secure_agg_mode="ring", aggregator="clip_mean",
                  clip_bound=5.0)
    if optimizer == "sgd":
        cfg_kw["momentum"] = 0.9
    ((pt, prows, pres), (rt, rrows, rres)), init = _run_pair(
        cfg_kw, CHAOS_RULES, n=n, layers=2, clients=clients, samples=16,
        wave=4, rounds=rounds, tmp_path=tmp_path)
    _same_rows(prows, rrows)
    plan = FaultPlan(seed=0, rules=CHAOS_RULES)
    for r, row in enumerate(prows):
        want = plan.casualty_counts(r, np.arange(clients))
        byz = plan.byzantine_counts(r, np.arange(clients))
        assert row["dropped_clients"] == want["drop"] == 1
        assert row["rejected_updates"] == want["nan"] + want["inf"] == 1
        assert row["clipped_clients"] == byz["scale"] == 1
        assert row["participants"] == clients - 2
        assert "skipped" not in row
    for g_round in pt:
        assert all(np.all(np.isfinite(g)) for g in g_round)
    if optimizer == "adam":
        # The reference's own bar; θ is held under SGD (docstring).
        assert min(pres.final_accuracy, rres.final_accuracy) > 0.7
        assert abs(pres.final_accuracy - rres.final_accuracy) <= 2 / 64
        return
    names = _leaf_names(init)
    for r, (g_round, w_round) in enumerate(zip(pt, rt)):
        for name, g, w in zip(names, g_round, w_round):
            np.testing.assert_allclose(g, w, atol=THETA_ATOL, rtol=0,
                                       err_msg=f"round {r + 1} {name}")
    for g, w in zip(prows, rrows):
        np.testing.assert_allclose(g["loss"], w["loss"], atol=THETA_ATOL,
                                   rtol=0)
    assert abs(pres.final_accuracy - rres.final_accuracy) <= 1 / 64


def test_straggler_plan_matches_reference(monkeypatch):
    monkeypatch.setenv("QFEDX_STALE", "1")
    _form(monkeypatch, 4)
    cfg_kw = dict(local_epochs=1, batch_size=2, learning_rate=0.1,
                  momentum=0.9, secure_agg=True)
    ((_, prows, pres), (_, rrows, rres)), _ = _run_pair(
        cfg_kw, STRAGGLER_RULES, n=4, layers=1, clients=16, samples=4,
        wave=4, rounds=3, seed=3, wave_deadline_s=STRAGGLER_DEADLINE_S,
        stale_poll_s=30.0)
    _same_rows(prows, rrows)
    assert [r["late_waves"] for r in prows] == [0, 1, 0]
    assert [r["stale_partials_applied"] for r in prows] == [0, 0, 1]
    assert [r["participants"] for r in prows] == [16, 12, 20]
    for g, w in zip(trees.tree_leaves(pres.params),
                    jax.tree.leaves(rres.params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=THETA_ATOL, rtol=0)
    for g, w in zip(prows, rrows):
        np.testing.assert_allclose(g["loss"], w["loss"], atol=THETA_ATOL,
                                   rtol=0)


def test_dead_wave_beside_planned_drops_matches_reference():
    """A persistent registry.fetch fault kills wave 1 under ring masks
    while the plan drops one client inside it and one outside: the dead
    wave's sampled clients count as casualties (the planned one once),
    and the server adds back only the surviving dead clients' masks —
    θ and the ledger as the reference's."""
    _form_kw = dict(local_epochs=1, batch_size=2, learning_rate=0.1,
                    momentum=0.9, secure_agg=True)
    rules = [{"site": "registry.fetch", "waves": [1]},
             {"site": "client.compute", "kind": "drop", "clients": [5, 9]}]
    ((_, prows, pres), (_, rrows, rres)), _ = _run_pair(
        _form_kw, rules, n=3, layers=1, clients=16, samples=4, wave=4,
        rounds=2, seed=3)
    _same_rows(prows, rrows)
    assert [r["dropped_waves"] for r in prows] == [1, 1]
    assert [r["dropped_clients"] for r in prows] == [5, 5]
    assert [r["participants"] for r in prows] == [11, 11]
    for g, w in zip(trees.tree_leaves(pres.params),
                    jax.tree.leaves(rres.params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=THETA_ATOL, rtol=0)


def test_epsilon_unchanged_by_injected_drops():
    _form_kw = dict(local_epochs=1, batch_size=4, learning_rate=0.1,
                    client_fraction=0.5)
    dp = dict(clip_norm=1.0, noise_multiplier=1.0)
    drops = [{"site": "client.compute", "kind": "drop", "rate": 0.25}]
    out = {}
    for name, rules in (("clean", None), ("drops", drops)):
        (port, ref), _ = _run_pair(_form_kw, rules, n=3, layers=1,
                                   clients=8, samples=4, wave=8, rounds=2,
                                   seed=1, dp=dp)
        _same_rows(port[1], ref[1])
        assert port[2].epsilons == ref[2].epsilons
        out[name] = port
    assert sum(r["dropped_clients"] for r in out["drops"][1]) > 0
    assert out["clean"][2].epsilons == out["drops"][2].epsilons
    assert len(out["clean"][2].epsilons) == 2


def test_plan_needs_guards(monkeypatch):
    monkeypatch.setenv("QFEDX_GUARDS", "off")
    data = _data(8, 4, 3)
    for port in (True, False):
        with pytest.raises(ValueError, match="QFEDX_GUARDS"):
            if port:
                train_federated_streamed(
                    make_vqc_classifier(3, 1, 2, device="cpu"), FedConfig(),
                    ArrayRegistry(*data), None, None, cohort_size=8,
                    num_rounds=1, device="cpu", fault_plan=FaultPlan())
            else:
                ref_streamed(ref_make(3, 1, 2), RFedConfig(),
                             RArrayRegistry(*data), None, None,
                             cohort_size=8, num_rounds=1,
                             mesh=client_mesh(num_devices=1),
                             fault_plan=RFaultPlan())
    monkeypatch.setenv("QFEDX_FAULTS", '{"seed": 1, "rules": []}')
    with pytest.raises(ValueError, match="QFEDX_GUARDS"):
        train_federated_streamed(
            make_vqc_classifier(3, 1, 2, device="cpu"), FedConfig(),
            ArrayRegistry(*data), None, None, cohort_size=8, num_rounds=1,
            device="cpu")

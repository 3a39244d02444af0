"""The client-mesh round (``fed/round.py`` over ``mesh=``): independent
of the slot count, and held against the reference's 8-device round.

- ``make_fed_round`` over 2 and 4 CPU client slots equals the one-slot
  round (already held against the reference, tests/test_torch_fed.py
  and tests/test_torch_robust.py) within 1e-5 on θ and exactly on the
  counts, under each aggregator (mean, clip_mean with a finite bound,
  trimmed_mean, median), secure aggregation (ring, pairwise),
  client-mode and per-example DP, sampling below 1, and guards with
  survivors, a byzantine input and a non-finite client;
- ``make_fed_round_partial`` waves over 2 slots equal the one-slot
  waves, and the trainers take ``mesh=``;
- over 8 slots the trimmed-mean round equals the reference's round on
  its 8-device client mesh (each device one client: the combine needs
  the gathered deltas), its shuffles injected, within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ref_streams as streams
from qfedx_tpu.fed import round as rround
from qfedx_tpu.fed.config import FedConfig as RFedConfig
from qfedx_tpu.models.vqc import make_vqc_classifier as ref_make
from qfedx_tpu_torch.fed.config import DPConfig, FedConfig
from qfedx_tpu_torch.fed.round import (
    SA_SEED_SALT,
    RoundDraws,
    client_mesh,
    make_accumulate_partial,
    make_apply_partial,
    make_fed_round,
    make_fed_round_partial,
    round_generator,
    shard_client_data,
)
from qfedx_tpu_torch.fed.secure_agg import round_seed
from qfedx_tpu_torch.models.api import params_from_jax
from qfedx_tpu_torch.models.vqc import make_vqc_classifier
from qfedx_tpu_torch.utils import trees

N, L, C, S, BATCH = 4, 2, 8, 8, 4
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def dot_form(monkeypatch):
    monkeypatch.setenv("QFEDX_GATE_FORM", "dot")  # the reference, n < 10


def _data(seed=0):
    rng = np.random.default_rng(seed)
    cx = rng.uniform(0, 1, (C, S, N)).astype(np.float32)
    cy = rng.integers(0, 2, (C, S)).astype(np.int64)
    cm = np.ones((C, S), np.float32)
    cm[5, 6:] = 0.0  # a client with padding
    return cx, cy, cm


def _mesh(d):
    return client_mesh(devices=["cpu"] * d)


CASES = {
    "mean": dict(),
    "clip_mean": dict(aggregator="clip_mean", clip_bound=0.05),
    "trimmed_mean": dict(aggregator="trimmed_mean", trim_fraction=0.25),
    "median": dict(aggregator="median"),
    "ring": dict(secure_agg=True),
    "pairwise": dict(secure_agg=True, secure_agg_mode="pairwise"),
    "dp_client": dict(dp=DPConfig(clip_norm=0.5, noise_multiplier=1.1)),
    "dp_example": dict(dp=DPConfig(clip_norm=0.5, noise_multiplier=1.1,
                                   mode="example")),
    "sampled": dict(client_fraction=0.5),
}


def _round(model, cfg, mesh, params, guards_input=False, x=None):
    cx, cy, cm = _data() if x is None else x
    kw = {"draws": RoundDraws(3, 1)}
    if cfg.secure_agg:
        kw["sa_seed"] = round_seed(3, 1, SA_SEED_SALT)
    if guards_input:
        surv = np.ones(C, np.float32)
        surv[2] = 0.0
        byz = np.tile(np.float32([1.0, 0.0]), (C, 1))
        byz[6] = (100.0, 0.0)
        byz[1] = (1.0, 0.5)
        kw.update(survivors=surv, byzantine=byz)
    data = ((torch.as_tensor(cx), torch.as_tensor(cy), torch.as_tensor(cm))
            if mesh is None else shard_client_data(mesh, cx, cy, cm))
    return make_fed_round(model, cfg, C, mesh=mesh)(
        params, *data, generator=round_generator(3, 1), **kw)


def _same(a, b, atol=ATOL):
    (pa, sa), (pb, sb) = a, b
    for x, y in zip(trees.tree_leaves(pa), trees.tree_leaves(pb)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=atol, rtol=0)
    for f in ("num_participants", "rejected_updates", "dropped_clients",
              "clipped_clients", "applied"):
        assert float(getattr(sa, f)) == float(getattr(sb, f)), f
    for f in ("mean_loss", "total_weight", "trimmed_fraction"):
        assert abs(float(getattr(sa, f)) - float(getattr(sb, f))) <= atol, f


@pytest.mark.parametrize("slots", [2, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_client_mesh_round_is_slot_count_independent(case, slots):
    model = make_vqc_classifier(N, L, 2, device="cpu")
    params = model.init(0)
    cfg = FedConfig(local_epochs=1, batch_size=BATCH, learning_rate=0.1,
                    optimizer="sgd", **CASES[case])
    _same(_round(model, cfg, _mesh(slots), params),
          _round(model, cfg, None, params))


@pytest.mark.parametrize("slots", [2, 4])
@pytest.mark.parametrize("agg", ["clip_mean", "trimmed_mean"])
def test_guards_with_survivors_and_attackers(agg, slots):
    """Survivors, a ×100 attacker, a noise attacker and a NaN client: the
    quarantine ledger, the dropouts and ``clipped_clients`` sum over the
    slots as the update does."""
    model = make_vqc_classifier(N, L, 2, device="cpu")
    params = model.init(1)
    cx, cy, cm = _data(1)
    cx[4, 0, 0] = np.nan
    cfg = FedConfig(local_epochs=1, batch_size=BATCH, learning_rate=0.1,
                    optimizer="sgd", aggregator=agg, clip_bound=0.1)
    got = _round(model, cfg, _mesh(slots), params, True, (cx, cy, cm))
    want = _round(model, cfg, None, params, True, (cx, cy, cm))
    _same(got, want)
    assert float(want[1].rejected_updates) == 1.0
    assert float(want[1].dropped_clients) == 1.0


def test_partial_waves_over_slots_match_one_slot():
    """Two waves of 4 clients, each over 2 client slots, accumulated and
    applied ≡ the same waves on one slot (ring masks over the cohort)."""
    model = make_vqc_classifier(N, L, 2, device="cpu")
    params = model.init(2)
    cx, cy, cm = (torch.as_tensor(a) for a in _data(2))
    cfg = FedConfig(local_epochs=1, batch_size=BATCH, learning_rate=0.1,
                    optimizer="sgd", secure_agg=True)
    perms = torch.stack([torch.randperm(S, generator=torch.Generator()
                                        .manual_seed(c))[None]
                         for c in range(C)])
    out = []
    for mesh in (None, _mesh(2)):
        pf = make_fed_round_partial(model, cfg, 4, C, mesh=mesh)
        acc = None
        for w in range(2):
            sl = slice(4 * w, 4 * w + 4)
            part = pf(params, cx[sl], cy[sl], cm[sl], 4 * w,
                      perms=perms[sl], sa_seed=7, draws=RoundDraws(0, 0))
            acc = part if acc is None else make_accumulate_partial()(acc,
                                                                     part)
        out.append(make_apply_partial(cfg, C)(params, acc))
    _same(out[0], out[1])


def test_trainers_take_a_mesh():
    """``train_federated(mesh=)`` over 4 client slots gives the default
    one-slot run's rows and θ; ``train_federated_streamed`` takes a
    clients-only mesh for its waves and refuses a sharded model."""
    from qfedx_tpu_torch.data.stream import ArrayRegistry
    from qfedx_tpu_torch.models.vqc_sharded import (
        make_sharded_vqc_classifier,
    )
    from qfedx_tpu_torch.run.trainer import (
        train_federated,
        train_federated_streamed,
    )

    model = make_vqc_classifier(N, L, 2, device="cpu")
    cx, cy, cm = _data(4)
    tx = np.random.default_rng(5).uniform(0, 1, (32, N)).astype(np.float32)
    ty = (tx[:, 0] > 0.5).astype(np.int64)
    cfg = FedConfig(local_epochs=1, batch_size=BATCH, learning_rate=0.1,
                    optimizer="sgd")
    runs = [train_federated(model, cfg, cx, cy, cm, tx, ty, num_rounds=2,
                            seed=1, mesh=mesh)
            for mesh in (None, _mesh(4))]
    assert runs[0].accuracies == runs[1].accuracies
    np.testing.assert_allclose(runs[0].losses, runs[1].losses, atol=ATOL)
    for a, b in zip(trees.tree_leaves(runs[0].params),
                    trees.tree_leaves(runs[1].params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)
    reg = ArrayRegistry(cx, cy, cm)
    streamed = [train_federated_streamed(
        model, cfg, reg, tx, ty, cohort_size=8, wave_size=4, num_rounds=1,
        seed=1, device="cpu", mesh=mesh) for mesh in (None, _mesh(2))]
    for a, b in zip(trees.tree_leaves(streamed[0].params),
                    trees.tree_leaves(streamed[1].params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)
    with pytest.raises(ValueError, match="sv_size == 1"):
        train_federated_streamed(
            make_sharded_vqc_classifier(N, 2, device="cpu"), cfg, reg, tx,
            ty, cohort_size=8, device="cpu")


def test_mesh_divisibility_matches_reference():
    model = make_vqc_classifier(N, L, 2, device="cpu")
    with pytest.raises(ValueError) as got:
        make_fed_round(model, FedConfig(), 6, mesh=_mesh(4))
    with pytest.raises(ValueError) as want:
        rround.make_fed_round(ref_make(N, L, 2), RFedConfig(),
                              rround.client_mesh(4), num_clients=6)(
            {}, None, None, None, None)
    assert str(got.value) == str(want.value)


def test_eight_slot_trimmed_mean_matches_reference_8_device_round():
    """Eight CPU slots, one client each, against the reference's round on
    its 8-device client mesh: the per-client combine sees every slot's
    delta (the reference's all_gather), θ within 1e-5."""
    kw = dict(local_epochs=1, batch_size=BATCH, learning_rate=0.1,
              optimizer="sgd", aggregator="trimmed_mean", trim_fraction=0.25)
    rmodel = ref_make(N, L, 2)
    rparams = rmodel.init(jax.random.PRNGKey(11))
    cx, cy, cm = _data(6)
    key = jax.random.PRNGKey(12)
    rmesh = rround.client_mesh(num_devices=8)
    want, wstats = rround.make_fed_round(rmodel, RFedConfig(**kw), rmesh,
                                         num_clients=C)(
        rparams, *rround.shard_client_data(rmesh, cx, cy.astype(np.int32),
                                           jnp.asarray(cm)), key)
    model = make_vqc_classifier(N, L, 2, device="cpu")
    params = params_from_jax(jax.tree.map(np.asarray, rparams), device="cpu")
    mesh = _mesh(8)
    got, gstats = make_fed_round(model, FedConfig(**kw), C, mesh=mesh)(
        params, *shard_client_data(mesh, cx, cy, cm),
        perms=streams.perms(key, C, 1, S), draws=RoundDraws(0, 0))
    for g, w in zip(trees.tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)
    assert abs(float(gstats.trimmed_fraction)
               - float(wstats.trimmed_fraction)) <= 1e-6
    assert abs(float(gstats.mean_loss) - float(wstats.mean_loss)) <= ATOL

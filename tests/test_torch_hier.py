"""Port vs reference: the hierarchical round (qfedx_tpu_torch/fed/round.py
``make_fed_round_partial``, ``make_accumulate_partial``,
``make_apply_partial[s]``, ``stack_partials``, ``make_fed_rounds``; the
pins ``QFEDX_HIER`` and ``QFEDX_STALE``; fed/robust.py
``staleness_discount``).

Mirroring ``tests/test_hier.py`` on the port:

- one wave (the whole cohort) + apply ≡ the port's ``make_fed_round``
  bit for bit, under secure aggregation, client DP and sampling;
- W ∈ {2, 4} waves ≡ the flat round within ``SGD_ATOL`` (the same
  per-client updates summed in another order), counts exact;
- partials are additive (``PARTIAL_ATOL``); at lr = 0 the accumulated
  ring masks cancel across waves (``CANCEL_ATOL``), and under
  ``QFEDX_STALE`` one wave's masks cancel on their own.

Against the reference (its draws and shuffles injected through
``tests/_torch_ref_streams.py``; the port's masks are its own, so no
masked case is compared number for number):

- each wave's partial (``update_sum``, weight, loss and the counts)
  under mean, clip_mean, client DP and fraction 0.5 at n = 4 (the
  reference's "dot" form), and at n = 12, where the port's wave runs the
  kernel route (the plain sweep on the CPU) and the reference its Pallas
  route (interpreted), within ``PARTIAL_ATOL``;
- ``make_apply_partials`` with ``ages`` (constant and poly) under mean,
  trimmed_mean and median within ``APPLY_ATOL``; ``staleness_discount``
  within 1 ulp, exactly 1 at τ = 0; the two pins parse alike;
- a route probe in both packages at n = 12: a wave of 32 clients runs
  Launch B and C per local step in the port and Pallas B and C in the
  reference; a wave of 64 (more groups than ``_ROWMAT_GROUP_MAX``) runs
  neither.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ref_streams as streams
from qfedx_tpu.fed import robust as rrobust
from qfedx_tpu.fed import round as rround
from qfedx_tpu.fed.config import DPConfig as RDPConfig
from qfedx_tpu.fed.config import FedConfig as RFedConfig
from qfedx_tpu.models.vqc import make_vqc_classifier as ref_make
from qfedx_tpu.ops import fuse as rfuse
from qfedx_tpu.ops import pallas_body as rpb
from qfedx_tpu_torch.fed import robust as probust
from qfedx_tpu_torch.fed.client import resolve_perms
from qfedx_tpu_torch.fed import round as pround
from qfedx_tpu_torch.fed.config import DPConfig, FedConfig
from qfedx_tpu_torch.fed.round import (
    RoundDraws,
    RoundPartial,
    make_accumulate_partial,
    make_apply_partial,
    make_apply_partials,
    make_fed_round,
    make_fed_round_partial,
    make_fed_rounds,
    stack_partials,
)
from qfedx_tpu_torch.models.vqc import make_vqc_classifier, params_from_jax
from qfedx_tpu_torch.ops import scan_body
from qfedx_tpu_torch.utils import trees

SGD_ATOL = 1e-5  # W waves vs the flat round, SGD (summation order)
PARTIAL_ATOL = 1e-5  # a wave's partial, port vs reference or summed halves
CANCEL_ATOL = 1e-5  # lr = 0: what the ring masks leave
APPLY_ATOL = 1e-6  # the stacked aged apply on the same partials
C, S, N, L, BATCH = 8, 4, 4, 1, 2


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
    _form(monkeypatch, N)


def _data(n=N, clients=C, seed=0):
    rng = np.random.default_rng(seed)
    cx = rng.uniform(0, 1, (clients, S, n)).astype(np.float32)
    cy = rng.integers(0, 2, (clients, S)).astype(np.int32)
    cm = np.ones((clients, S), np.float32)
    cm[1, -1] = 0.0
    return cx, cy, cm


def _ref_params(n=N, layers=L, scale=8.0):
    p = ref_make(n, layers, 2).init(jax.random.PRNGKey(0))
    return jax.tree.map(lambda v: np.asarray(v) * scale, p)


def _port_cfg(**kw):
    dp = kw.pop("dp", None)
    base = dict(local_epochs=1, batch_size=BATCH, learning_rate=0.1,
                momentum=0.9)
    base.update(kw)
    return FedConfig(**base, dp=None if dp is None else DPConfig(**dp))


def _ref_cfg(**kw):
    dp = kw.pop("dp", None)
    base = dict(local_epochs=1, batch_size=BATCH, learning_rate=0.1,
                momentum=0.9)
    base.update(kw)
    return RFedConfig(**base, dp=None if dp is None else RDPConfig(**dp))


def _tensors(data):
    return [torch.as_tensor(a) for a in data]


def _port_waves(cfg, params, data, waves, seed=3, model=None):
    """The port's W-wave partials of one round and their sum."""
    model = model or make_vqc_classifier(N, L, 2, device="cpu")
    cx, cy, cm = _tensors(data)
    width = cx.shape[0] // waves
    pf = make_fed_round_partial(model, cfg, width, cx.shape[0])
    perms = resolve_perms(cfg, cx.shape[0], S,
                          torch.Generator().manual_seed(seed))
    parts = []
    for w in range(waves):
        lo = w * width
        sl = slice(lo, lo + width)
        parts.append(pf(params, cx[sl], cy[sl], cm[sl], lo,
                        perms=perms[sl], sa_seed=17,
                        draws=RoundDraws(seed, 0)))
    acc = parts[0]
    for p in parts[1:]:
        acc = make_accumulate_partial()(acc, p)
    return parts, acc, perms


def _flat(cfg, params, data, perms, seed=3):
    model = make_vqc_classifier(N, L, 2, device="cpu")
    rf = make_fed_round(model, cfg, num_clients=C)
    return rf(params, *_tensors(data), perms=perms, sa_seed=17,
              draws=RoundDraws(seed, 0))


def _leaves(tree):
    return trees.tree_leaves(tree)


_FLAT = dict(optimizer="adam", client_fraction=0.6, secure_agg=True,
             dp=dict(clip_norm=1.0, noise_multiplier=0.5))


def test_one_wave_is_bitexact_flat():
    cfg = _port_cfg(**_FLAT)
    params = params_from_jax(_ref_params(), device="cpu")
    data = _data(seed=3)
    _, acc, perms = _port_waves(cfg, params, data, 1)
    got, gstats = make_apply_partial(cfg, C)(params, acc)
    want, wstats = _flat(cfg, params, data, perms)
    for g, w in zip(_leaves(got), _leaves(want)):
        assert torch.equal(g, w)
    for field in ("mean_loss", "total_weight", "num_participants",
                  "dropped_clients", "applied"):
        assert float(getattr(gstats, field)) == float(getattr(wstats, field))


@pytest.mark.parametrize("waves", [2, 4])
@pytest.mark.parametrize("kw", [dict(secure_agg=True, client_fraction=0.5),
                                dict(dp=dict(clip_norm=1.0,
                                             noise_multiplier=0.5))],
                         ids=["ring-sampling", "dp"])
def test_wave_split_matches_flat(waves, kw):
    cfg = _port_cfg(**dict(kw))
    params = params_from_jax(_ref_params(), device="cpu")
    data = _data()
    _, acc, perms = _port_waves(cfg, params, data, waves)
    got, gstats = make_apply_partial(cfg, C)(params, acc)
    want, wstats = _flat(cfg, params, data, perms)
    for g, w in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=SGD_ATOL,
                                   rtol=0)
    assert float(gstats.num_participants) == float(wstats.num_participants)
    np.testing.assert_allclose(float(gstats.total_weight),
                               float(wstats.total_weight), rtol=1e-6)


def test_partials_are_additive():
    cfg = _port_cfg(secure_agg=True)
    params = params_from_jax(_ref_params(), device="cpu")
    data = _data(seed=5)
    whole, _, _ = _port_waves(cfg, params, data, 1)
    halves, summed, _ = _port_waves(cfg, params, data, 2)
    for a, b in zip(_leaves(whole[0].update_sum), _leaves(summed.update_sum)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=PARTIAL_ATOL,
                                   rtol=0)
    assert float(whole[0].weight_sum) == float(summed.weight_sum)


@pytest.mark.parametrize("waves", [1, 2, 4])
def test_ring_masks_cancel_across_waves(waves):
    """lr = 0: every Δθ is 0, so the accumulated update_sum is the sum of
    the ring masks, whose partners live in other waves."""
    cfg = _port_cfg(learning_rate=0.0, momentum=0.0, secure_agg=True,
                    client_fraction=0.5, secure_agg_scale=4.0)
    params = params_from_jax(_ref_params(), device="cpu")
    parts, acc, _ = _port_waves(cfg, params, _data(seed=1), waves)
    assert max(float(t.abs().max()) for t in _leaves(acc.update_sum)
               ) < CANCEL_ATOL
    if waves > 1:  # a lone wave carries its cross-wave edges
        assert max(float(t.abs().max())
                   for t in _leaves(parts[0].update_sum)) > 1e-2


def test_stale_wave_partial_is_self_cancelling(monkeypatch):
    cfg = _port_cfg(learning_rate=0.0, momentum=0.0, secure_agg=True)
    params = params_from_jax(_ref_params(), device="cpu")
    monkeypatch.setenv("QFEDX_STALE", "1")
    parts, _, _ = _port_waves(cfg, params, _data(seed=1), 4)
    for p in parts:
        assert max(float(t.abs().max()) for t in _leaves(p.update_sum)
                   ) < CANCEL_ATOL


# --- the partial against the reference ------------------------------------------

_PARTIAL_CASES = {
    "mean": {},
    "clip_mean": dict(aggregator="clip_mean", clip_bound=0.05),
    "dp": dict(dp=dict(clip_norm=0.5, noise_multiplier=0.8)),
    "fraction": dict(client_fraction=0.5),
}


def _compare_partials(monkeypatch, kw, n, layers, clients, waves,
                      pallas="0"):
    _form(monkeypatch, n, pallas)
    rcfg, cfg = _ref_cfg(**dict(kw)), _port_cfg(**dict(kw))
    params = _ref_params(n, layers)
    data = _data(n, clients)
    width = clients // waves
    key = jax.random.PRNGKey(41)
    mesh = rround.client_mesh(num_devices=1)
    rpf = rround.make_fed_round_partial(ref_make(n, layers, 2), rcfg, mesh,
                                        wave_clients=width,
                                        cohort_clients=clients)
    pf = make_fed_round_partial(make_vqc_classifier(n, layers, 2,
                                                    device="cpu"),
                                cfg, width, clients)
    perms = streams.perms(key, clients, 1, S)
    draws = RoundDraws(0, 0, streams.round_streams(key, params, rcfg,
                                                   clients, S))
    tparams = params_from_jax(params, device="cpu")
    tdata = _tensors(data)
    for w in range(waves):
        lo = w * width
        sl = slice(lo, lo + width)
        want = rpf(params, *rround.shard_client_data(
            mesh, *(jnp.asarray(a[sl]) for a in data)), np.int32(lo), key)
        got = pf(tparams, *(t[sl] for t in tdata), lo, perms=perms[sl],
                 draws=draws)
        for g, r in zip(_leaves(got.update_sum),
                        jax.tree.leaves(want.update_sum)):
            np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                       atol=PARTIAL_ATOL, rtol=0)
        for field in ("weight_sum", "loss_sum"):
            np.testing.assert_allclose(float(getattr(got, field)),
                                       float(getattr(want, field)),
                                       atol=PARTIAL_ATOL, rtol=0)
        for field in ("num_participants", "rejected_updates",
                      "dropped_clients", "clipped_clients"):
            assert float(getattr(got, field)) == float(getattr(want, field))
    return draws


@pytest.mark.parametrize("case", sorted(_PARTIAL_CASES))
def test_partial_matches_reference(monkeypatch, case):
    draws = _compare_partials(monkeypatch, _PARTIAL_CASES[case], N, L, C, 2)
    if case == "fraction":  # the draw sampled a strict subset
        assert 0 < draws.participation(C, 0.5).sum() < C


def test_partial_matches_reference_on_the_kernel_route(monkeypatch):
    """n = 12, L = 2: the port's waves run the scan-body route (counted),
    the reference's its Pallas route (interpreted)."""
    calls = _port_probe(monkeypatch)
    _compare_partials(monkeypatch, dict(client_fraction=0.5), 12, 2, 4, 2,
                      pallas="1")
    assert calls == ["B", "C"] * 4  # 2 waves x 2 local steps


# --- the aged apply and its pieces ------------------------------------------------


@pytest.mark.parametrize("mode,alpha", [("constant", 0.3), ("constant", 1.0),
                                        ("poly", 0.5), ("poly", 2.0)])
def test_staleness_discount_matches_reference(mode, alpha):
    ages = np.array([0, 1, 2, 3, 7, 0.5], np.float32)
    got = probust.staleness_discount(mode, alpha, ages).numpy()
    want = np.asarray(rrobust.staleness_discount(mode, alpha, ages))
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    assert got[0] == 1.0
    for f in (probust.staleness_discount, rrobust.staleness_discount):
        with pytest.raises(ValueError):
            f("linear", 1.0, ages)


def _stacked(waves=4, seed=0):
    rng = np.random.default_rng(seed)
    w = np.array([3.0, 0.0, 2.0, 4.0, 1.0][:waves], np.float32)
    upd = {"a": {"x": rng.normal(size=(waves, 3, 2)).astype(np.float32)},
           "b": {"y": rng.normal(size=(waves, 5)).astype(np.float32)}}
    upd = jax.tree.map(lambda u: u * w.reshape((-1,) + (1,) * (u.ndim - 1)),
                       upd)
    fields = dict(weight_sum=w, loss_sum=w * 0.7,
                  num_participants=w, rejected_updates=np.ones(waves,
                                                               np.float32),
                  dropped_clients=np.arange(waves, dtype=np.float32),
                  clipped_clients=np.zeros(waves, np.float32))
    return upd, fields


@pytest.mark.parametrize("ages", [None, (0, 0, 1, 2)], ids=["fresh", "aged"])
@pytest.mark.parametrize("mode", ["constant", "poly"])
@pytest.mark.parametrize("agg", ["mean", "trimmed_mean", "median"])
def test_apply_partials_matches_reference(agg, mode, ages):
    kw = dict(aggregator=agg, trim_fraction=0.25, staleness_mode=mode,
              staleness_alpha=0.5, min_participation=0.0)
    upd, fields = _stacked()
    params = {"a": {"x": np.ones((3, 2), np.float32)},
              "b": {"y": np.zeros(5, np.float32)}}
    ages_a = None if ages is None else np.asarray(ages, np.float32)
    want_p, want_s = rround.make_apply_partials(RFedConfig(**kw), 8)(
        jax.tree.map(jnp.asarray, params), rround.RoundPartial(
            update_sum=jax.tree.map(jnp.asarray, upd),
            **{k: jnp.asarray(v) for k, v in fields.items()}), ages=ages_a)
    got_p, got_s = make_apply_partials(FedConfig(**kw), 8)(
        trees.tree_map(torch.as_tensor, params), RoundPartial(
            update_sum=trees.tree_map(torch.as_tensor, upd),
            **{k: torch.as_tensor(v) for k, v in fields.items()}),
        ages=ages_a)
    for g, w in zip(_leaves(got_p), jax.tree.leaves(want_p)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=APPLY_ATOL,
                                   rtol=0)
    for field in want_s._fields:
        np.testing.assert_allclose(float(getattr(got_s, field)),
                                   float(getattr(want_s, field)),
                                   atol=APPLY_ATOL, rtol=0, err_msg=field)


def test_stack_then_apply_equals_accumulate_then_apply():
    cfg = _port_cfg()
    params = params_from_jax(_ref_params(), device="cpu")
    parts, acc, _ = _port_waves(cfg, params, _data(seed=2), 4)
    a, _ = make_apply_partial(cfg, C)(params, acc)
    b, _ = make_apply_partials(cfg, C)(params, stack_partials(parts))
    c, _ = make_apply_partials(cfg, C)(params, stack_partials(parts),
                                       ages=np.zeros(4, np.float32))
    for x, y, z in zip(_leaves(a), _leaves(b), _leaves(c)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=APPLY_ATOL,
                                   rtol=0)
        assert torch.equal(y, z)  # s(0) = 1 exactly
    with pytest.raises(ValueError, match="ages"):
        make_apply_partials()(params, stack_partials(parts),
                              ages=np.zeros(4, np.float32))
    with pytest.raises(ValueError):
        stack_partials([])


@pytest.mark.parametrize("pin", ["QFEDX_HIER", "QFEDX_STALE"])
@pytest.mark.parametrize("value", [None, "on", "0", "1", "off", "maybe"])
def test_pins_parse_as_reference(monkeypatch, pin, value):
    if value is None:
        monkeypatch.delenv(pin, raising=False)
    else:
        monkeypatch.setenv(pin, value)
    name = "hier_enabled" if pin == "QFEDX_HIER" else "stale_enabled"
    outs = []
    for mod in (pround, rround):
        try:
            outs.append(getattr(mod, name)())
        except ValueError:
            outs.append("ValueError")
    assert outs[0] == outs[1]


@pytest.mark.parametrize("agg", ["trimmed_mean", "median"])
def test_robust_rule_with_masks_needs_two_waves(agg):
    model = make_vqc_classifier(N, L, 2, device="cpu")
    rmodel, mesh = ref_make(N, L, 2), rround.client_mesh(num_devices=1)
    kw = dict(aggregator=agg, secure_agg=True)
    with pytest.raises(ValueError) as want:
        rround.make_fed_round_partial(rmodel, _ref_cfg(**kw), mesh, 8, 8)
    with pytest.raises(ValueError) as got:
        make_fed_round_partial(model, _port_cfg(**kw), 8, 8)
    assert str(got.value) == str(want.value)
    rround.make_fed_round_partial(rmodel, _ref_cfg(**kw), mesh, 4, 8)
    make_fed_round_partial(model, _port_cfg(**kw), 4, 8)


def test_make_fed_rounds_equals_sequential_rounds():
    cfg = _port_cfg(secure_agg=True, client_fraction=0.5)
    model = make_vqc_classifier(N, L, 2, device="cpu")
    params = params_from_jax(_ref_params(), device="cpu")
    data = _tensors(_data())
    ex = torch.as_tensor(np.random.default_rng(1).uniform(
        0, 1, (6, N)).astype(np.float32))
    ey = torch.tensor([0, 1, 1, 0, 1, 0])
    got, (stats, accs) = make_fed_rounds(model, cfg, C, 3, with_eval=True,
                                         seed=9)(params, *data, 2, ex, ey)
    rf = make_fed_round(model, cfg, num_clients=C)
    p = params
    for i, r in enumerate(range(2, 5)):
        p, st = rf(p, *data, generator=pround.round_generator(9, r),
                   sa_seed=pround.round_seed(9, r, pround.SA_SEED_SALT),
                   draws=RoundDraws(9, r))
        assert float(st.mean_loss) == float(stats[i].mean_loss)
        with torch.inference_mode():
            acc = (model.apply(p, ex).argmax(-1) == ey).float().mean()
        assert float(acc) == float(accs[i])
    for a, b in zip(_leaves(got), _leaves(p)):
        assert torch.equal(a, b)


# --- the route probe -----------------------------------------------------------------


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


@pytest.mark.parametrize("width,want", [(32, "BC"), (64, "")])
def test_route_probe(monkeypatch, width, want):
    """One wave of ``width`` clients at n = 12, L = 2, one local step of
    B = 2: the reference's partial traced with its Pallas route, the
    port's run on the CPU (its kernel route takes the plain sweep)."""
    n, layers = 12, 2
    _form(monkeypatch, n, pallas="1")
    kw = dict(local_epochs=1, batch_size=2, learning_rate=0.1)
    rcfg, cfg = RFedConfig(**kw), FedConfig(**kw)
    params = _ref_params(n, layers, scale=1.0)
    rng = np.random.default_rng(7)
    cx = rng.uniform(0, 1, (width, 2, n)).astype(np.float32)
    cy = rng.integers(0, 2, (width, 2)).astype(np.int32)
    cm = np.ones((width, 2), np.float32)
    rcalls, pcalls = _ref_probe(monkeypatch), _port_probe(monkeypatch)
    mesh = rround.client_mesh(num_devices=1)
    rpf = rround.make_fed_round_partial(ref_make(n, layers, 2), rcfg, mesh,
                                        wave_clients=width,
                                        cohort_clients=2 * width)
    jax.make_jaxpr(lambda *a: rpf(*a))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(cx), jnp.asarray(cy),
        jnp.asarray(cm), np.int32(width), jax.random.PRNGKey(0))
    pf = make_fed_round_partial(make_vqc_classifier(n, layers, 2,
                                                    device="cpu"),
                                cfg, width, 2 * width)
    pf(params_from_jax(params, device="cpu"), *_tensors((cx, cy, cm)),
       width, perms=torch.zeros((width, 1, 2), dtype=torch.int64))
    assert ("".join(rcalls), "".join(pcalls)) == (want, want)

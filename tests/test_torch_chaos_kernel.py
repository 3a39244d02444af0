"""Port vs reference: a non-finite client beside healthy ones in one
wave through the scan-body kernel's Launches B and C
(qfedx_tpu_torch/fed/round.py ``make_fed_round_partial`` under the fault
plan's ``nan``/``inf`` poison).

n = 12, L = 3, one wave of 32 clients × 2 samples, one local step on the
kernel route (Launches B and C counted; the plain sweep on the CPU),
under clip_mean: one client's features × NaN (or × Inf, where a zero
feature becomes NaN beside ±Inf). The wave's partial equals the
reference's (its Pallas route, interpreted) within ``PARTIAL_ATOL`` with
the client rejected, and equals the port's own wave with that client
dropped instead — the 31 healthy clients' sums, to the bit
(``ISOLATION_ATOL``): nothing in the folded slab, the grouped cotangent,
the per-client optimizer state or the quarantine mixes the client's
rows into the others'.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ref_streams as streams
from qfedx_tpu.fed import round as rround
from qfedx_tpu.fed.config import FedConfig as RFedConfig
from qfedx_tpu.fed.round import client_mesh
from qfedx_tpu.models.vqc import make_vqc_classifier as ref_make
from qfedx_tpu.ops import fuse as rfuse
from qfedx_tpu_torch.fed.config import FedConfig
from qfedx_tpu_torch.fed.round import RoundDraws, make_fed_round_partial
from qfedx_tpu_torch.models.vqc import make_vqc_classifier, params_from_jax
from qfedx_tpu_torch.ops import scan_body
from qfedx_tpu_torch.utils import trees
from qfedx_tpu_torch.utils.faults import FaultPlan

PARTIAL_ATOL = 1e-5  # a wave's partial (tests/test_torch_hier.py)
ISOLATION_ATOL = 0.0  # NaN client vs dropped client: the same sums


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on one CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def kernel_form(monkeypatch):
    """The reference's program shape at n = 12 with its Pallas route."""
    for pin in ("QFEDX_FUSE", "QFEDX_SCAN_LAYERS", "QFEDX_BATCHED"):
        monkeypatch.setenv(pin, "1")
    monkeypatch.setenv("QFEDX_PALLAS", "1")
    monkeypatch.setenv("QFEDX_GATE_FORM", "flip")
    monkeypatch.setenv("QFEDX_SLAB_LANES", "matmul")
    monkeypatch.setattr(rfuse, "_gather_ok", lambda: True)
    monkeypatch.setattr(rfuse, "_growmat_merge_ok", lambda: True)
    for pin in ("QFEDX_GUARDS", "QFEDX_FAULTS", "QFEDX_DTYPE"):
        monkeypatch.delenv(pin, raising=False)


def _data(clients, samples, n, seed):
    rng = np.random.default_rng(seed)
    cx = rng.uniform(0, 1, (clients, samples, n)).astype(np.float32)
    cy = (cx.mean(axis=2) > 0.5).astype(np.int32)
    cm = np.ones((clients, samples), dtype=np.float32)
    return cx, cy, cm


def _port_probe(mp):
    calls = []
    sweep = scan_body.scan_body

    def counted(packed, spec, xs, with_boundaries=False, adjoint=False):
        calls.append("C" if adjoint else "B" if with_boundaries else "A")
        return sweep(packed, spec, xs, with_boundaries, adjoint)

    mp.setattr(scan_body, "scan_body", counted)
    return calls


@pytest.mark.parametrize("kind", ["nan", "inf"])
def test_poisoned_client_in_a_kernel_wave(monkeypatch, kind):
    """n = 12, L = 3, one wave of 32 clients × 2 samples, one local step:
    one client's features × NaN (or × Inf) through Launches B and C."""
    n, layers, width, samples, bad = 12, 3, 32, 2, 13
    kw = dict(local_epochs=1, batch_size=samples, learning_rate=0.1,
              aggregator="clip_mean", clip_bound=0.05)
    rcfg, cfg = RFedConfig(**kw), FedConfig(**kw)
    params = jax.tree.map(lambda v: np.asarray(v) * 4.0, ref_make(
        n, layers, 2).init(jax.random.PRNGKey(0)))
    cx, cy, cm = _data(width, samples, n, seed=11)
    cx[bad, 0, 2] = 0.0  # under inf: 0·inf is NaN beside ±inf
    plan = FaultPlan(seed=0, rules=[
        {"site": "client.compute", "kind": kind, "clients": [bad]}])
    pois = plan.poison(0, np.arange(width))
    with np.errstate(invalid="ignore"):  # 0·inf
        bad_x = cx * pois[:, None, None]
    key = jax.random.PRNGKey(41)
    perms = streams.perms(key, width, 1, samples)
    draws = RoundDraws(0, 0, streams.round_streams(key, params, rcfg, width,
                                                   samples))
    rpf = rround.make_fed_round_partial(
        ref_make(n, layers, 2), rcfg, client_mesh(num_devices=1),
        wave_clients=width, cohort_clients=width)
    want = rpf(params, *rround.shard_client_data(
        client_mesh(num_devices=1), jnp.asarray(bad_x), jnp.asarray(cy),
        jnp.asarray(cm)), np.int32(0), key)
    calls = _port_probe(monkeypatch)
    pf = make_fed_round_partial(make_vqc_classifier(n, layers, 2,
                                                    device="cpu"),
                                cfg, width, width)
    tparams = params_from_jax(params, device="cpu")
    tdata = [torch.as_tensor(a) for a in (bad_x, cy, cm)]
    got = pf(tparams, *tdata, 0, perms=perms, draws=draws)
    assert calls == ["B", "C"]  # the kernel route, one local step
    survivors = np.ones(width, np.float32)
    survivors[bad] = 0.0
    dropped = pf(tparams, *[torch.as_tensor(a) for a in (cx, cy, cm)], 0,
                 perms=perms, draws=draws, survivors=survivors)
    for g, r, d in zip(trees.tree_leaves(got.update_sum),
                       jax.tree.leaves(want.update_sum),
                       trees.tree_leaves(dropped.update_sum)):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(r),
                                   atol=PARTIAL_ATOL, rtol=0)
        np.testing.assert_allclose(g.numpy(), d.numpy(),
                                   atol=ISOLATION_ATOL, rtol=0)
    for field in ("weight_sum", "loss_sum"):
        np.testing.assert_allclose(float(getattr(got, field)),
                                   float(getattr(want, field)),
                                   atol=PARTIAL_ATOL, rtol=0)
        assert float(getattr(got, field)) == float(getattr(dropped, field))
    for field in ("num_participants", "rejected_updates", "dropped_clients",
                  "clipped_clients"):
        assert float(getattr(got, field)) == float(getattr(want, field))
    assert float(got.rejected_updates) == 1.0
    assert float(dropped.dropped_clients) == 1.0
    assert float(got.num_participants) == float(dropped.num_participants)
    assert float(got.clipped_clients) == float(dropped.clipped_clients)

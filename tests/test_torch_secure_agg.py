"""Port vs reference: secure aggregation (qfedx_tpu_torch/fed/secure_agg.py
and its branch in fed/round.py).

The port's masks come from torch generators, the reference's from
jax.random, so the numbers differ by construction; what is held is what
the reference's own tests hold (tests/test_secure_agg.py):

- the pair graph and its signs: the reference's ``ring_mask`` and
  ``client_mask`` are run with their key derivation replaced by a
  one-hot of the edge (or pair) they name, which reads off every
  client's coefficient on every edge; the port's edge lists must give
  the same matrix, for random participation vectors;
- cancellation: per leaf within 1e-4 at 16 clients, 5e-4 at 256
  (the reference's bounds); cohorts of 0 and 1 give no mask;
  non-participants get zeros and participants a mask;
- the round: a masked round's θ equals the unmasked round's within
  1e-5 (ring and pairwise); a quarantined client's masks stay in the
  sum (otherwise the masks would not cancel); a dropped client leaves
  the pair graph; secure aggregation with a robust rule raises as the
  reference's does;
- a config-4-shaped CLI run (reupload, n = 10, L = 3, 8 clients,
  ``--secure-agg``, 2 rounds) against the reference trainer with its own
  masks, from the reference's init and shuffles: per-round loss and
  final θ within 1e-4.
"""

import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qfedx_tpu.fed import secure_agg as rsa
from qfedx_tpu.fed.config import FedConfig as RFedConfig
from qfedx_tpu.fed.round import (
    TRAIN_KEY_SALT,
    client_mesh,
    make_fed_round as ref_make_round,
)
from qfedx_tpu.models.vqc import make_vqc_classifier as ref_make
from qfedx_tpu.ops import fuse as rfuse
from qfedx_tpu.run import config as rconfig
from qfedx_tpu.run.trainer import train_federated as ref_train
from qfedx_tpu.utils import trees as rtrees
from qfedx_tpu_torch.fed import secure_agg as sa
from qfedx_tpu_torch.fed.config import FedConfig
from qfedx_tpu_torch.fed.round import make_fed_round
from qfedx_tpu_torch.models.vqc import make_vqc_classifier, params_from_jax
from qfedx_tpu_torch.run import checkpoint as pckpt
from qfedx_tpu_torch.run import cli as pcli
from qfedx_tpu_torch.run import config as pconfig
from qfedx_tpu_torch.run import trainer as ptrainer
from qfedx_tpu_torch.utils import trees

CANCEL_ATOL = 1e-4
CANCEL_ATOL_256 = 5e-4
ROUND_ATOL = 1e-5
CLI_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite runs
    several workers on one CPU, where torch's default pool per worker
    oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def tpu_form(monkeypatch):
    for pin in ("QFEDX_FUSE", "QFEDX_SCAN_LAYERS", "QFEDX_PALLAS",
                "QFEDX_BATCHED"):
        monkeypatch.setenv(pin, "1")
    monkeypatch.setenv("QFEDX_GATE_FORM", "flip")
    monkeypatch.setenv("QFEDX_SLAB_LANES", "matmul")
    monkeypatch.setattr(rfuse, "_gather_ok", lambda: True)
    monkeypatch.setattr(rfuse, "_growmat_merge_ok", lambda: True)


def _participation(num_clients, kind, seed=0):
    part = np.zeros(num_clients, np.float32)
    if kind == "all":
        part[:] = 1.0
    elif kind == "one":
        part[num_clients // 2] = 1.0
    elif kind == "two":
        part[0] = part[-1] = 1.0
    elif kind == "random":
        rng = np.random.default_rng(seed)
        part = (rng.random(num_clients) < 0.6).astype(np.float32)
    return part


def _template(num_clients):
    return {"w": torch.zeros(num_clients, 63, 2),
            "b": {"c": torch.zeros(num_clients, 5)}}


# --- the pair graph ------------------------------------------------------------


def _ref_coefficients(mode, num_clients, part, neighbors, scale):
    """(C, E) matrix: client i's coefficient on edge e in the reference's
    mask, with every edge key replaced by a one-hot of the edge."""
    hops = neighbors if mode == "ring" else 1
    size = num_clients * num_clients * hops

    def index(key):
        if mode == "ring":
            src, dst, d = key
            return (src * num_clients + dst) * hops + (d - 1)
        lo, hi = key
        return lo * num_clients + hi

    fake_trees = types.SimpleNamespace(
        tree_zeros_like=rtrees.tree_zeros_like,
        tree_random_normal=lambda key, tmpl: {
            "e": jax.nn.one_hot(index(key), size)},
    )
    tmpl = {"e": jnp.zeros(size)}
    p = jnp.asarray(part)
    saved = rsa.trees, rsa._edge_key, rsa.pair_key
    rsa.trees = fake_trees
    rsa._edge_key = lambda base, src, dst, d: (src, dst, d)
    rsa.pair_key = lambda base, i, j: (jnp.minimum(i, j), jnp.maximum(i, j))
    try:
        rows = []
        for cid in range(num_clients):
            if mode == "ring":
                m = rsa.ring_mask(None, cid, num_clients, tmpl, p, scale,
                                  neighbors)
            else:
                m = rsa.client_mask(None, cid, num_clients, tmpl, p, scale)
            rows.append(np.asarray(m["e"]))
    finally:
        rsa.trees, rsa._edge_key, rsa.pair_key = saved
    return np.stack(rows), index


def _port_coefficients(mode, num_clients, part, neighbors, scale, index):
    hops = neighbors if mode == "ring" else 1
    out = np.zeros((num_clients, num_clients * num_clients * hops),
                   np.float32)
    if mode == "ring":
        keys = [(src, dst, d) for src, dst, d, _ in
                sa.ring_edges(0, part, neighbors)]
    else:
        keys = [(lo, hi) for lo, hi, _ in sa.pair_edges(0, part)]
    for key in keys:
        out[key[0], index(key)] += scale
        out[key[1], index(key)] -= scale
    return out


@pytest.mark.parametrize("mode,neighbors", [("ring", 1), ("ring", 2),
                                            ("ring", 4), ("pairwise", 1)])
@pytest.mark.parametrize("kind", ["all", "one", "two", "random"])
def test_pair_graph_and_signs_match_reference(mode, neighbors, kind):
    num_clients, scale = 7, 2.0
    for seed in range(2 if kind == "random" else 1):
        part = _participation(num_clients, kind, seed=seed)
        want, index = _ref_coefficients(mode, num_clients, part, neighbors,
                                        scale)
        got = _port_coefficients(mode, num_clients, part, neighbors, scale,
                                 index)
        np.testing.assert_array_equal(got, want)


def test_edge_streams_are_deterministic_and_distinct():
    part = np.ones(5, np.float32)
    a = sa.ring_edges(11, part, 2)
    assert a == sa.ring_edges(11, part, 2)
    seeds = [e[-1] for e in a] + [e[-1] for e in sa.pair_edges(11, part)]
    assert len(set(seeds)) == len(seeds)
    assert sa.pair_seed(3, 1, 4) == sa.pair_seed(3, 4, 1)
    assert sa.edge_seed(3, 1, 4, 1) != sa.edge_seed(3, 4, 1, 1)
    assert sa.round_seed(5, 0, 1) != sa.round_seed(5, 1, 1)


# --- cancellation ----------------------------------------------------------------


@pytest.mark.parametrize("mode,neighbors", [("ring", 1), ("ring", 2),
                                            ("ring", 5), ("pairwise", 1)])
@pytest.mark.parametrize("kind", ["all", "none", "one", "two", "random"])
def test_masks_cancel(mode, neighbors, kind):
    num_clients = 16
    part = _participation(num_clients, kind)
    tmpl = _template(num_clients)
    masks = sa.cohort_masks(3, tmpl, part, 4.0, mode, neighbors)
    for leaf in trees.tree_leaves(masks):
        np.testing.assert_allclose(leaf.sum(0).numpy(), 0.0,
                                   atol=CANCEL_ATOL)
    norms = sum(leaf.abs().reshape(num_clients, -1).sum(1)
                for leaf in trees.tree_leaves(masks)).numpy()
    np.testing.assert_allclose(norms[part == 0], 0.0, atol=1e-6)
    if part.sum() >= 2:
        assert np.all(norms[part == 1] > 1.0)
    else:
        # A lone participant has no peer to hide behind: no mask at all.
        np.testing.assert_allclose(norms, 0.0, atol=0)
    # Each client's own mask (what it derives alone) is its row.
    one = _template(1)
    for cid in (0, num_clients // 2, num_clients - 1):
        if mode == "ring":
            mine = sa.ring_mask(3, cid, num_clients, one, part, 4.0,
                                neighbors)
        else:
            mine = sa.client_mask(3, cid, num_clients, one, part, 4.0)
        for a, b in zip(trees.tree_leaves(mine), trees.tree_leaves(masks)):
            np.testing.assert_allclose(a[0].numpy(), b[cid].numpy(),
                                       atol=1e-5)


def test_ring_masks_cancel_at_256_clients():
    num_clients = 256
    part = _participation(num_clients, "random", seed=7)
    masks = sa.cohort_masks(11, _template(num_clients), part, 3.0, "ring", 1)
    for leaf in trees.tree_leaves(masks):
        np.testing.assert_allclose(leaf.sum(0).numpy(), 0.0,
                                   atol=CANCEL_ATOL_256)


# --- the round -------------------------------------------------------------------

N, L, C, S, BATCH = 10, 3, 4, 4, 4


def _round_inputs(nan_client=None):
    rng = np.random.default_rng(0)
    cx = rng.uniform(0, 1, (C, S, N)).astype(np.float32)
    cy = rng.integers(0, 2, (C, S)).astype(np.int64)
    cm = np.ones((C, S), np.float32)
    if nan_client is not None:
        cx[nan_client] = np.nan
    perms = torch.as_tensor(np.stack([[rng.permutation(S)]
                                      for _ in range(C)]))
    return [torch.as_tensor(a) for a in (cx, cy, cm)], perms


def _round(cfg_kw, nan_client=None, survivors=None, sa_seed=None):
    model = make_vqc_classifier(N, L, 2, encoding="reupload", device="cpu")
    params = model.init(0)
    params = trees.tree_map(lambda v: v * 4.0, params)
    data, perms = _round_inputs(nan_client)
    rf = make_fed_round(model, FedConfig(local_epochs=1, batch_size=BATCH,
                                         learning_rate=0.1, **cfg_kw),
                        num_clients=C)
    return rf(params, *data, perms=perms, survivors=survivors,
              sa_seed=sa_seed)


def _same_round(got, want, atol=ROUND_ATOL):
    (gp, gs), (wp, ws) = got, want
    for a, b in zip(trees.tree_leaves(gp), trees.tree_leaves(wp)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=atol, rtol=0)
    assert abs(float(gs.mean_loss) - float(ws.mean_loss)) <= atol
    assert float(gs.num_participants) == float(ws.num_participants)


@pytest.mark.parametrize("mode,neighbors", [("ring", 1), ("ring", 2),
                                            ("pairwise", 1)])
def test_masked_round_equals_unmasked(mode, neighbors):
    plain = _round({})
    masked = _round(dict(secure_agg=True, secure_agg_mode=mode,
                         secure_agg_neighbors=neighbors), sa_seed=17)
    _same_round(masked, plain)
    # The masks are there: a round whose masks do not cancel is off.
    assert not torch.equal(masked[0]["ansatz"]["rx"], plain[0]["ansatz"]["rx"])


def test_quarantined_client_masks_stay_in_the_sum():
    """A client whose update is non-finite is zeroed and weighted 0, but
    its masks stay in the sum: the masked round equals the unmasked one
    with the same casualty. Without them the ring would leave its
    neighbours' masks uncancelled (θ off by O(mask / Σw))."""
    plain = _round({}, nan_client=1)
    masked = _round(dict(secure_agg=True), nan_client=1, sa_seed=5)
    assert float(masked[1].rejected_updates) == 1.0
    _same_round(masked, plain)


def test_dropped_client_leaves_the_pair_graph():
    survivors = np.array([1, 0, 1, 1], np.float32)
    plain = _round({}, survivors=survivors)
    masked = _round(dict(secure_agg=True, secure_agg_mode="pairwise"),
                    survivors=survivors, sa_seed=9)
    assert float(masked[1].dropped_clients) == 1.0
    _same_round(masked, plain)


@pytest.mark.parametrize("agg", ["trimmed_mean", "median"])
def test_secure_agg_with_a_robust_rule_raises(agg):
    kw = dict(secure_agg=True, aggregator=agg)
    with pytest.raises(ValueError, match="secure_agg"):
        ref_make_round(ref_make(N, L, 2), RFedConfig(**kw),
                       client_mesh(num_devices=1), num_clients=C)
    model = make_vqc_classifier(N, L, 2, encoding="reupload", device="cpu")
    with pytest.raises(ValueError, match="secure_agg"):
        make_fed_round(model, FedConfig(**kw), num_clients=C)


def test_round_needs_its_seed():
    with pytest.raises(ValueError, match="sa_seed"):
        _round(dict(secure_agg=True))


# --- a config-4-shaped CLI run ---------------------------------------------------

SEED = 3
CLI_ARGV = ["train", "--model", "vqc", "--qubits", "10", "--layers", "3",
            "--encoding", "reupload", "--dataset", "fashion_mnist",
            "--classes", "0,1", "--clients", "8", "--rounds", "2",
            "--local-epochs", "1", "--batch-size", "4", "--lr", "0.1",
            "--secure-agg", "--checkpoint-every", "1", "--seed", str(SEED)]


def _ref_perms(round_key, num_clients, s):
    train_key = jax.random.fold_in(round_key, TRAIN_KEY_SALT)
    return torch.as_tensor(np.asarray([[np.asarray(jax.random.permutation(
        jax.random.split(jax.random.split(jax.random.fold_in(
            train_key, cid), 1)[0])[0], s))] for cid in range(num_clients)]))


def test_config4_shaped_cli_run_matches_reference_trainer(monkeypatch,
                                                          tmp_path):
    """BASELINE.md config 4's shape (reupload, --secure-agg ring) at
    n = 10, 8 clients: the port's CLI run from the reference's init and
    shuffles against the reference's trainer with its own masks."""
    monkeypatch.setattr(pcli, "DataConfig", functools.partial(
        pconfig.DataConfig, synthetic_train=128, synthetic_test=64))
    argv = CLI_ARGV + ["--run-root", str(tmp_path), "--name", "c4"]
    cfg = pcli.config_from_args(pcli.build_parser().parse_args(argv))
    data = pconfig.build_data(cfg)
    num_clients, s = data["cx"].shape[:2]
    assert (num_clients, 4 * num_clients) == (8, 32)  # the kernel's fold

    monkeypatch.setenv("QFEDX_PALLAS", "0")  # the reference's lax.scan
    ref_model = ref_make(10, 3, 2, encoding="reupload")
    rows = []
    rcfg = RFedConfig(local_epochs=1, batch_size=4, learning_rate=0.1,
                      secure_agg=True)
    res = ref_train(ref_model, rcfg, data["cx"], data["cy"], data["cmask"],
                    *data["val"], num_rounds=2, seed=SEED,
                    mesh=client_mesh(num_devices=1), rounds_per_call=1,
                    on_round_end=lambda r, m: rows.append(dict(m)))
    init_key, base = jax.random.split(jax.random.PRNGKey(SEED))
    init = jax.tree.map(np.asarray, ref_model.init(init_key))
    perms = [_ref_perms(jax.random.fold_in(base, r), num_clients, s)
             for r in range(2)]
    monkeypatch.setenv("QFEDX_PALLAS", "1")

    monkeypatch.setattr(ptrainer, "train_federated", functools.partial(
        ptrainer.train_federated, params=params_from_jax(init, device="cpu"),
        perms_for_round=lambda r: perms[r]))
    pcli.main(argv, device="cpu")
    run = tmp_path / "c4"
    got = [json.loads(line) for line in
           (run / "metrics.jsonl").read_text().splitlines()]
    assert [r["round"] for r in got] == [1, 2]
    for g, w in zip(got, rows):
        assert abs(g["loss"] - w["loss"]) <= CLI_ATOL
    model = make_vqc_classifier(10, 3, 2, encoding="reupload", device="cpu")
    params, r = pckpt.Checkpointer(run / "checkpoints").restore_latest(
        model.init(0))
    assert r == 2
    for a, b in zip(trees.tree_leaves(params), jax.tree.leaves(res.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=CLI_ATOL,
                                   rtol=0)
    saved = rconfig.experiment_config_from_dict(
        json.loads((run / "config.json").read_text()))
    assert saved.fed.secure_agg and saved.model.encoding == "reupload"

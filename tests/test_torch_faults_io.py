"""The fault plan at the port's I/O seams, and the SIGTERM drain.

- ``run/checkpoint.Checkpointer``: a ``checkpoint.write`` rule with
  ``times: 1`` fails the first attempt of the async write and the retry
  recovers; ``times: 3`` exhausts the retry into ``CheckpointWriteError``
  carrying the ``FaultInjected`` — as the reference's writer does on the
  same pin (``tests/test_run_io.py:201``); the plan reaches the writer
  by ``QFEDX_FAULTS`` or by argument.
- ``serve/batcher.MicroBatcher``: ``serve.request`` ``nan`` and
  ``malformed`` reject exactly the planned request sequence numbers
  (counted in ``stats["rejected"]``), and every other request's logits
  equal a clean batcher's; ``serve/engine.ServeEngine``:
  ``serve.compute`` with ``times: 1`` retries to the clean logits, and a
  persistent one fails its batch's requests alone.
- SIGTERM: raised from ``on_round_end`` it stops the streamed trainer
  with a ``KeyboardInterrupt``, the last completed round is
  checkpointed, a resume reaches the uninterrupted run's θ, and the
  previous handler is back; a tracked run (``ExperimentRun``) unwinds
  on it too; raised mid-stream in ``serve`` it drains every admitted
  request. ``serve`` takes ``QFEDX_FAULTS``.
"""

import functools
import json
import signal

import numpy as np
import pytest
import torch

from qfedx_tpu.run import checkpoint as rckpt
from qfedx_tpu_torch.data.stream import ArrayRegistry
from qfedx_tpu_torch.fed.config import FedConfig
from qfedx_tpu_torch.models.vqc import make_vqc_classifier
from qfedx_tpu_torch.run import checkpoint as pckpt
from qfedx_tpu_torch.run import cli as pcli
from qfedx_tpu_torch.run import config as pconfig
from qfedx_tpu_torch.run.trainer import train_federated_streamed
from qfedx_tpu_torch.serve import (
    MicroBatcher,
    RequestError,
    ServeConfig,
    ServeEngine,
)
from qfedx_tpu_torch.utils import trees
from qfedx_tpu_torch.utils.faults import FaultInjected, FaultPlan
from qfedx_tpu_torch.utils.retry import RetryExhausted

N = 10  # the narrowest slab width: the serving route of the n = 12 slice


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on one CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def no_pins(monkeypatch):
    for pin in ("QFEDX_FAULTS", "QFEDX_STALE", "QFEDX_HIER", "QFEDX_GUARDS",
                "QFEDX_STREAM"):
        monkeypatch.delenv(pin, raising=False)


def _ckpt_plan(times):
    return {"seed": 0, "rules": [
        {"site": "checkpoint.write", "rounds": [1], "times": times}]}


def _params():
    return {"a": torch.arange(6, dtype=torch.float32).reshape(3, 2),
            "nested": {"b": torch.ones(4)}}


# --- checkpoint.write ---------------------------------------------------------


@pytest.mark.parametrize("how", ["pin", "argument"])
def test_checkpoint_write_transient_recovers(tmp_path, monkeypatch, how):
    spec = _ckpt_plan(1)
    plan = None
    if how == "pin":
        monkeypatch.setenv("QFEDX_FAULTS", json.dumps(spec))
    else:
        plan = FaultPlan.from_spec(spec)
    ck = pckpt.Checkpointer(tmp_path / "port", every=1, fault_plan=plan)
    ck.save_async(1, _params())
    ck.save_async(2, _params())  # round 2 is not in the plan
    ck.wait()
    assert sorted(ck._rounds()) == [1, 2]
    ck.verify(1)
    if how == "pin":  # the reference's writer on the same pin
        ref = rckpt.Checkpointer(tmp_path / "ref", every=1)
        ref.save_async(1, {"a": np.ones(3, np.float32)})
        ref.wait()
        assert ref.latest_round() == 1


@pytest.mark.parametrize("how", ["pin", "argument"])
def test_checkpoint_write_persistent_raises(tmp_path, monkeypatch, how):
    spec = _ckpt_plan(3)
    plan = None
    if how == "pin":
        monkeypatch.setenv("QFEDX_FAULTS", json.dumps(spec))
    else:
        plan = FaultPlan.from_spec(spec)
    ck = pckpt.Checkpointer(tmp_path / "port", every=1, fault_plan=plan)
    ck.save_async(1, _params())
    with pytest.raises(pckpt.CheckpointWriteError) as ei:
        ck.wait()
    assert isinstance(ei.value.original, FaultInjected)
    assert ei.value.round_idx == 1 and "3 attempt(s)" in str(ei.value)
    assert ck._rounds() == []
    if how == "pin":
        ref = rckpt.Checkpointer(tmp_path / "ref", every=1)
        ref.save_async(1, {"a": np.ones(3, np.float32)})
        with pytest.raises(rckpt.CheckpointWriteError) as rei:
            ref.wait()
        assert type(rei.value.original).__name__ == "FaultInjected"


# --- serving --------------------------------------------------------------------


def _engine(plan=None):
    model = make_vqc_classifier(N, 2, 2, init_scale=1.0, device="cpu")
    cfg = ServeConfig(buckets=(1, 4, 8), deadline_ms=20.0, max_queue=64)
    return ServeEngine(model, model.init(0), (N,), config=cfg, device="cpu",
                       fault_plan=plan)


def _requests(m, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (m, N)).astype(
        np.float32)


def _serve(engine, xs):
    """Submit every row; returns ({seq: logits}, rejected seqs, stats)."""
    got, rejected = {}, []
    with MicroBatcher(engine) as b:
        futs = {}
        for seq, x in enumerate(xs):
            try:
                futs[seq] = b.submit(x)
            except RequestError:
                rejected.append(seq)
        for seq, f in futs.items():
            got[seq] = f.result(timeout=60)["logits"]
    return got, rejected, b.stats


@pytest.mark.parametrize("rules", [
    [{"site": "serve.request", "kind": "nan", "rate": 0.2}],
    [{"site": "serve.request", "kind": "malformed", "rounds": [0, 5, 6]}],
    [{"site": "serve.request", "kind": "malformed", "rate": 0.15},
     {"site": "serve.request", "kind": "nan", "rate": 0.15}],
], ids=["nan", "malformed", "both"])
def test_serve_request_rejects_exactly_the_planned(rules):
    plan = FaultPlan(seed=3, rules=rules)
    xs = _requests(24)
    planned = {s: plan.request_mutation(s) for s in range(len(xs))}
    planned = {s: k for s, k in planned.items() if k is not None}
    assert 0 < len(planned) < len(xs)
    clean, none_rejected, _ = _serve(_engine(), xs)
    assert none_rejected == []
    got, rejected, stats = _serve(_engine(plan), xs)
    assert rejected == sorted(planned)
    assert stats["rejected"] == len(planned)
    assert stats["served"] == len(xs) - len(planned)
    assert sorted(got) == [s for s in range(len(xs)) if s not in planned]
    for seq, logits in got.items():
        np.testing.assert_array_equal(logits, clean[seq])


def test_serve_request_mutations_fail_validation():
    """The mutation flows through the batcher's own validation: ``nan``
    is non-finite, ``malformed`` has each dimension + 1."""
    for kind, match in (("nan", "NaN"), ("malformed", r"\(11,\)")):
        plan = FaultPlan(rules=[{"site": "serve.request", "kind": kind,
                                 "rounds": [0]}])
        with MicroBatcher(_engine(plan)) as b:
            with pytest.raises(RequestError, match=match):
                b.submit(_requests(1)[0])
            b.submit(_requests(1)[0]).result(timeout=60)  # seq 1 is clean


def test_serve_compute_transient_retries_to_clean_logits():
    xs = _requests(3)
    clean = _engine().infer(xs, seq=1)
    engine = _engine(FaultPlan(rules=[
        {"site": "serve.compute", "rounds": [1], "times": 1}]))
    calls = []
    forward = engine._forward
    engine._forward = lambda xb: (calls.append(1), forward(xb))[1]
    np.testing.assert_array_equal(engine.infer(xs, seq=1), clean)
    assert len(calls) == 1  # the injected failure fired before the forward
    np.testing.assert_array_equal(engine.infer(xs, seq=2), clean)


def test_serve_compute_persistent_fails_its_batch_alone():
    engine = _engine(FaultPlan(rules=[
        {"site": "serve.compute", "rounds": [1]}]))
    with pytest.raises(RetryExhausted) as ei:
        engine.infer(_requests(2), seq=1)
    assert isinstance(ei.value.last, FaultInjected)
    with MicroBatcher(engine) as b:
        first = b.submit(_requests(1)[0])  # batch 1: fails
        with pytest.raises(RetryExhausted):
            first.result(timeout=60)
        b.submit(_requests(1)[0]).result(timeout=60)  # batch 2 serves
    assert b.stats["batches"] == 1 and b.stats["served"] == 1


# --- SIGTERM ----------------------------------------------------------------------


def _streamed(tmp_path, hook=None, rounds=3):
    rng = np.random.default_rng(0)
    cx = rng.uniform(0, 1, (8, 4, 3)).astype(np.float32)
    cy = (cx.mean(axis=2) > 0.5).astype(np.int32)
    cm = np.ones((8, 4), np.float32)
    cfg = FedConfig(local_epochs=1, batch_size=2, learning_rate=0.1)
    return train_federated_streamed(
        make_vqc_classifier(3, 1, 2, device="cpu"), cfg,
        ArrayRegistry(cx, cy, cm), cx[:, 0], cy[:, 0], cohort_size=8,
        wave_size=4, num_rounds=rounds, seed=1, eval_every=rounds,
        device="cpu", on_round_end=hook,
        checkpointer=pckpt.Checkpointer(tmp_path, every=100))


def test_sigterm_stops_the_streamed_trainer_and_checkpoints(tmp_path):
    straight = _streamed(tmp_path / "straight")
    before = signal.getsignal(signal.SIGTERM)

    def term(r, m):
        assert signal.getsignal(signal.SIGTERM) is not before
        if r == 1:
            signal.raise_signal(signal.SIGTERM)

    with pytest.raises(KeyboardInterrupt, match="SIGTERM"):
        _streamed(tmp_path / "ck", hook=term)
    assert signal.getsignal(signal.SIGTERM) is before
    ck = pckpt.Checkpointer(tmp_path / "ck", every=100)
    assert ck._rounds() == [1]  # the last completed round, saved at once
    ck.verify(1)
    resumed = _streamed(tmp_path / "ck")
    for a, b in zip(trees.tree_leaves(straight.params),
                    trees.tree_leaves(resumed.params)):
        assert torch.equal(a, b)
    assert signal.getsignal(signal.SIGTERM) is before


def test_tracked_run_translates_sigterm(tmp_path):
    """``ExperimentRun`` (the train CLI's run directory) turns a TERM
    into ``KeyboardInterrupt`` while it is open and restores the previous
    handler when it closes, as the reference's does."""
    from qfedx_tpu_torch.run.metrics import ExperimentRun

    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(KeyboardInterrupt, match="SIGTERM"):
        with ExperimentRun(tmp_path, name="run") as run:
            run.on_round_end(0, {"round": 1, "loss": 0.5, "time_s": 0.1})
            signal.raise_signal(signal.SIGTERM)
    assert signal.getsignal(signal.SIGTERM) is before
    rows = (tmp_path / "run" / "metrics.jsonl").read_text().splitlines()
    assert len(rows) == 1  # the row written before the TERM is kept


@pytest.fixture()
def run_dir(tmp_path, monkeypatch):
    """A tracked run of the n = 10 VQC, checkpointed (the CLI, small)."""
    monkeypatch.setattr(pcli, "DataConfig", functools.partial(
        pconfig.DataConfig, synthetic_train=64, synthetic_test=32))
    pcli.main(["train", "--model", "vqc", "--qubits", str(N), "--layers",
               "1", "--classes", "0,1", "--clients", "2", "--rounds", "1",
               "--checkpoint-every", "1", "--run-root", str(tmp_path),
               "--name", "run"], device="cpu")
    return tmp_path / "run"


def _request_file(path, m):
    lines = [json.dumps({"id": i, "features": x.tolist()})
             for i, x in enumerate(_requests(m, seed=5))]
    path.write_text("\n".join(lines) + "\n")


def test_serve_drains_on_sigterm_and_takes_the_pin(run_dir, tmp_path,
                                                   monkeypatch):
    _request_file(tmp_path / "in.jsonl", 12)
    before = signal.getsignal(signal.SIGTERM)
    submit = MicroBatcher.submit
    admitted = []

    def submit_then_term(self, features):
        if len(admitted) == 5:  # TERM arrives before the 6th request
            signal.raise_signal(signal.SIGTERM)
        fut = submit(self, features)
        admitted.append(fut)
        return fut

    monkeypatch.setattr(MicroBatcher, "submit", submit_then_term)
    out = tmp_path / "out.jsonl"
    summary = pcli.main(["serve", "--run-dir", str(run_dir), "--input",
                         str(tmp_path / "in.jsonl"), "--output", str(out),
                         "--buckets", "1,8", "--max-queue", "64"],
                        device="cpu")
    resp = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["id"] for r in resp] == [0, 1, 2, 3, 4]  # every admitted one
    assert all("logits" in r for r in resp)
    assert summary["served"] == 5 and summary["responses"] == 5
    assert signal.getsignal(signal.SIGTERM) is before
    monkeypatch.setattr(MicroBatcher, "submit", submit)

    # QFEDX_FAULTS reaches serve: the planned requests answer 400.
    spec = {"seed": 1, "rules": [
        {"site": "serve.request", "kind": "nan", "rounds": [2, 7]},
        {"site": "serve.compute", "rounds": [1], "times": 1}]}
    monkeypatch.setenv("QFEDX_FAULTS", json.dumps(spec))
    summary = pcli.main(["serve", "--run-dir", str(run_dir), "--input",
                         str(tmp_path / "in.jsonl"), "--output", str(out),
                         "--buckets", "1,8"], device="cpu")
    resp = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["id"] for r in resp] == list(range(12))
    assert [i for i, r in enumerate(resp) if r.get("code") == 400] == [2, 7]
    assert summary["rejected"] == 2 and summary["served"] == 10

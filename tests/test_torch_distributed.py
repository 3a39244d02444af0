"""The port's round across two processes (gloo) ≡ the same round in one
process over two slots.

One pair of gloo processes per module (``tests/_torch_distributed_
worker.py``) runs every mode in turn — the reference's six
(tests/test_distributed.py): the flat round, the hierarchical waves
under ring masks, a dropout decided by the ``distributed.peer`` fault
site, a clip_mean-defended attacker on process 1, trace shards, and the
staleness-discounted apply; a trimmed-mean round, whose combine
gathers the clients' deltas across the processes; and the trainer with
no mesh given, whose default mesh must span both processes. Each
process owns one CPU slot, so every partial sum meets its peer's in
``torch.distributed.all_reduce``; each mode's θ and stats must equal
``run_mode`` over a one-process mesh of two CPU slots within 1e-6 (the
trainer's, on every rank, the one-process trainer's on its default
one-slot mesh), and the trace shards must merge into one lane per
process.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import _torch_distributed_worker as worker
from conftest import free_port

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "_torch_distributed_worker.py")


@pytest.fixture(scope="module")
def two_process_run(tmp_path_factory):
    """Spawn the worker pair once; every mode's result lands in one
    directory."""
    out = tmp_path_factory.mktemp("dist")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("QFEDX_") and k != "XLA_FLAGS"}
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, _WORKER, f"localhost:{port}", "2", str(pid),
         str(out)], env=env, cwd=_REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    return out


def _in_process(mode, monkeypatch):
    import torch

    from qfedx_tpu_torch.fed.round import client_mesh

    for pin in ("QFEDX_STALE", "QFEDX_TRACE"):
        monkeypatch.delenv(pin, raising=False)
    if mode == "stale":
        monkeypatch.setenv("QFEDX_STALE", "1")
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return worker.run_mode(mode, client_mesh(devices=["cpu"] * 2))
    finally:
        torch.set_num_threads(before)


@pytest.mark.parametrize("mode", [m for m in worker.MODES
                                  if m not in ("trace", "trainer")])
def test_two_process_mode_matches_one_process(mode, two_process_run,
                                              monkeypatch):
    got = np.load(two_process_run / f"{mode}.npz")
    want = _in_process(mode, monkeypatch)
    assert sorted(got.files) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                   err_msg=k)
    if mode == "dropout":
        assert float(want["dropped_clients"]) == 1.0
        assert float(want["num_participants"]) == 3.0
    if mode == "byzantine":
        assert float(want["clipped_clients"]) >= 1.0
    if mode == "trimmed":
        assert float(want["trimmed_fraction"]) > 0.0


def test_two_process_trace_shards_merge_into_two_lanes(two_process_run,
                                                       monkeypatch):
    """Each process wrote its registry as ``trace.<rank>.json``; the
    merge has one lane per process, each with the round's host phase
    pair, intervals nested or disjoint per thread; θ equals the
    in-process round's."""
    from qfedx_tpu_torch import obs

    shard_dir = two_process_run / "trace"
    assert [p.name for p in obs.find_shards(shard_dir)] == [
        "trace.0.json", "trace.1.json"]
    merged = obs.merge_trace_shards(shard_dir,
                                    out_path=shard_dir / "trace.json")
    assert json.loads((shard_dir / "trace.json").read_text()) == merged
    xs = [e for e in merged["traceEvents"] if e.get("ph") == "X"]
    assert {e["pid"] for e in xs} == {0, 1}
    for pid in (0, 1):
        lane = [e for e in xs if e["pid"] == pid]
        assert {"round.dispatch", "round.fetch"} <= {e["name"]
                                                     for e in lane}
        by_tid: dict = {}
        for e in lane:
            by_tid.setdefault(e["tid"], []).append(e)
        for evs in by_tid.values():
            evs = sorted(evs, key=lambda e: (e["ts"], -e["dur"]))
            for a, b in zip(evs, evs[1:]):
                assert (b["ts"] + b["dur"] <= a["ts"] + a["dur"] + 1e-3
                        or b["ts"] >= a["ts"] + a["dur"] - 1e-3)
    got = np.load(two_process_run / "trace.npz")
    want = _in_process("trace", monkeypatch)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0)


@pytest.mark.parametrize("rank", [0, 1])
def test_two_process_trainer_default_mesh_matches_one_process(
        rank, two_process_run, monkeypatch):
    """``train_federated`` with no mesh under the process group: every
    rank's θ, losses and accuracies equal the one-process run's (its
    default mesh one CPU slot) within 1e-6."""
    got = np.load(two_process_run / f"trainer.{rank}.npz")
    want = _in_process("trainer", monkeypatch)
    assert sorted(got.files) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=0,
                                   err_msg=k)
    assert len(want["losses"]) == 2

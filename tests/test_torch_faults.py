"""Port vs reference: the fault plan (qfedx_tpu_torch/utils/faults.py).

The port's ``FaultPlan`` is a copy of the reference's, so every accessor
must equal the reference's array for array (``np.array_equal``, NaN
positions included) for each plan below — every site and kind, ``rate``
and ``clients`` rules, ``rounds``/``waves`` restrictions, ``times``
bounds and overlapping rules — at several seeds, rounds and cohorts:
survivors, poison, casualty and byzantine counts, multipliers, noise,
label flips, the attack, slow seconds, wave delays, request mutations,
and ``check``'s raise or pass per attempt (with the same coordinates on
the raised ``FaultInjected``). Spec validation raises the same exception
type with the same message; the ``QFEDX_FAULTS`` grammar (off, inline
JSON, a file re-read on every call, a typo) resolves alike; the
taxonomy is equal; ``utils/host``'s SIGTERM translation installs and
restores the previous handler.
"""

import json
import signal
import threading

import numpy as np
import pytest

from qfedx_tpu.utils import faults as rfaults
from qfedx_tpu_torch.utils import faults as pfaults
from qfedx_tpu_torch.utils import host

PLANS = {
    "crash": [
        {"site": "client.compute", "kind": "drop", "rate": 0.2},
        {"site": "client.compute", "kind": "nan", "rate": 0.1},
        {"site": "client.compute", "kind": "inf", "clients": [3, 40, 77]},
        {"site": "client.compute", "kind": "drop", "rate": 0.15,
         "rounds": [1, 3]},
    ],
    "byzantine": [
        {"site": "client.byzantine", "kind": "scale:100", "rate": 0.1},
        {"site": "client.byzantine", "kind": "scale:-3.5", "clients": [5]},
        {"site": "client.byzantine", "kind": "sign_flip", "rate": 0.2},
        {"site": "client.byzantine", "kind": "noise", "clients": [5, 9]},
        {"site": "client.byzantine", "kind": "noise:7", "rate": 0.1},
        {"site": "client.byzantine", "kind": "label_flip", "rate": 0.25,
         "rounds": [0, 2]},
    ],
    "straggler": [
        {"site": "client.slow", "kind": "slow", "rate": 0.05},
        {"site": "client.slow", "kind": "slow:0.25", "clients": [2, 11]},
        {"site": "wave.delay", "kind": "delay:0.4", "rate": 0.3},
        {"site": "wave.delay", "kind": "delay:1.5", "waves": [1],
         "rounds": [2]},
    ],
    "errors": [
        {"site": "registry.fetch", "rate": 0.5, "times": 1},
        {"site": "registry.fetch", "rounds": [1], "waves": [0, 2]},
        {"site": "ingest.h2d", "rate": 0.3, "times": 2},
        {"site": "checkpoint.write", "rounds": [2, 4], "times": 1},
        {"site": "distributed.peer", "rate": 0.25},
        {"site": "serve.compute", "rate": 0.2, "times": 1},
    ],
    "serving": [
        {"site": "serve.request", "kind": "nan", "rate": 0.1},
        {"site": "serve.request", "kind": "malformed", "rate": 0.1},
        {"site": "serve.request", "kind": "malformed", "rounds": [3, 7]},
        {"site": "serve.compute", "rounds": [5], "times": 1},
    ],
    "mixed": [
        {"site": "client.compute", "kind": "drop", "clients": [3]},
        {"site": "client.compute", "kind": "nan", "clients": [5]},
        {"site": "client.byzantine", "kind": "scale:1000", "clients": [6]},
        {"site": "client.byzantine", "kind": "label_flip", "clients": [2]},
        {"site": "registry.fetch", "rounds": [1], "waves": [0], "times": 1},
        {"site": "client.slow", "kind": "slow:0.4", "clients": [6]},
        {"site": "client.compute", "kind": "nan", "rate": 0.05},
        {"site": "serve.request", "kind": "nan", "rate": 0.3},
    ],
}
SEEDS = (0, 7, 123456789)
ROUNDS = range(5)
WAVE = 8
ERROR_SITES = ("registry.fetch", "ingest.h2d", "checkpoint.write",
               "distributed.peer", "serve.compute")


def _cohorts():
    rng = np.random.default_rng(3)
    return [np.arange(16),
            np.sort(rng.choice(1 << 20, 64, replace=False)),
            np.arange(96, dtype=np.int64) * 7919 + 5]


def _same(a, b):
    if isinstance(a, dict):
        assert a == b
    elif a is None or b is None:
        assert a is None and b is None
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def _check_outcome(plan, site, r, w, k):
    try:
        plan.check(site, r, wave=w, attempt=k)
    except Exception as exc:  # noqa: BLE001 — compared across packages
        return (type(exc).__name__, getattr(exc, "site", None),
                getattr(exc, "round_idx", None), getattr(exc, "wave", None),
                getattr(exc, "attempt", None), str(exc))
    return None


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(PLANS))
def test_accessors_equal_reference(name, seed):
    spec = {"seed": seed, "rules": PLANS[name]}
    port = pfaults.FaultPlan.from_spec(spec)
    ref = rfaults.FaultPlan.from_spec(spec)
    fired = 0
    for ids in _cohorts():
        for r in ROUNDS:
            for acc in ("survivors", "poison", "casualty_counts",
                        "byzantine_multipliers", "byzantine_noise",
                        "label_flips", "byzantine_counts",
                        "byzantine_attack", "slow_seconds"):
                got = getattr(port, acc)(r, ids)
                _same(got, getattr(ref, acc)(r, ids))
            _same(port.wave_delays(r, ids, WAVE),
                  ref.wave_delays(r, ids, WAVE))
            for w in range(len(ids) // WAVE):
                assert port.wave_delay_s(r, w) == ref.wave_delay_s(r, w)
            fired += int((port.survivors(r, ids) == 0).sum()
                         + (port.poison(r, ids) != 1).sum()
                         + (port.byzantine_multipliers(r, ids) != 1).sum()
                         + (port.byzantine_noise(r, ids) > 0).sum()
                         + port.label_flips(r, ids).sum()
                         + (port.wave_delays(r, ids, WAVE) > 0).sum())
    for seq in range(64):
        got = port.request_mutation(seq)
        assert got == ref.request_mutation(seq)
        fired += got is not None
    for site in ERROR_SITES:
        for r in ROUNDS:
            for w in range(4):
                for k in range(3):
                    got = _check_outcome(port, site, r, w, k)
                    assert got == _check_outcome(ref, site, r, w, k)
                    fired += got is not None
    assert fired > 0  # every plan fires somewhere in this grid


def test_from_json_text_and_file(tmp_path):
    spec = {"seed": 4, "rules": PLANS["mixed"]}
    path = tmp_path / "plan.json"
    path.write_text(json.dumps(spec))
    ids = np.arange(16)
    for src in (json.dumps(spec), str(path), path):
        port = pfaults.FaultPlan.from_json(src)
        ref = rfaults.FaultPlan.from_json(src)
        _same(port.poison(0, ids), ref.poison(0, ids))
        _same(port.byzantine_attack(1, ids), ref.byzantine_attack(1, ids))


BAD_SPECS = {
    "site": {"rules": [{"site": "nonsense"}]},
    "client-kind": {"rules": [{"site": "client.compute", "kind": "error",
                               "rate": 0.1}]},
    "client-neither": {"rules": [{"site": "client.compute", "kind": "drop"}]},
    "client-both": {"rules": [{"site": "client.compute", "kind": "drop",
                               "rate": 0.1, "clients": [1]}]},
    "rate-high": {"rules": [{"site": "client.compute", "kind": "drop",
                             "rate": 1.5}]},
    "rate-negative": {"rules": [{"site": "registry.fetch", "rate": -0.1}]},
    "rule-key": {"rules": [{"site": "registry.fetch", "typo": 1}]},
    "plan-key": {"seeds": 1},
    "error-kind": {"rules": [{"site": "ingest.h2d", "kind": "nan"}]},
    "scale-bare": {"rules": [{"site": "client.byzantine", "kind": "scale",
                              "clients": [1]}]},
    "scale-zero": {"rules": [{"site": "client.byzantine", "kind": "scale:0",
                              "clients": [1]}]},
    "scale-text": {"rules": [{"site": "client.byzantine", "kind": "scale:x",
                              "clients": [1]}]},
    "sign-param": {"rules": [{"site": "client.byzantine",
                              "kind": "sign_flip:2", "clients": [1]}]},
    "byz-base": {"rules": [{"site": "client.byzantine", "kind": "krum",
                            "clients": [1]}]},
    "noise-sigma": {"rules": [{"site": "client.byzantine", "kind": "noise:0",
                               "clients": [1]}]},
    "slow-kind": {"rules": [{"site": "client.slow", "kind": "fast",
                             "clients": [1]}]},
    "slow-zero": {"rules": [{"site": "client.slow", "kind": "slow:0",
                             "clients": [1]}]},
    "slow-waves": {"rules": [{"site": "client.slow", "kind": "slow:1",
                              "clients": [3], "waves": [1]}]},
    "slow-times": {"rules": [{"site": "client.slow", "kind": "slow:1",
                              "clients": [3], "times": 1}]},
    "delay-bare": {"rules": [{"site": "wave.delay", "kind": "delay"}]},
    "delay-zero": {"rules": [{"site": "wave.delay", "kind": "delay:0"}]},
    "delay-clients": {"rules": [{"site": "wave.delay", "kind": "delay:1",
                                 "clients": [3]}]},
    "delay-times": {"rules": [{"site": "wave.delay", "kind": "delay:1",
                               "times": 1}]},
    "request-kind": {"rules": [{"site": "serve.request", "kind": "drop"}]},
    "request-clients": {"rules": [{"site": "serve.request", "kind": "nan",
                                   "clients": [1]}]},
    "request-waves": {"rules": [{"site": "serve.request", "kind": "nan",
                                 "waves": [0]}]},
    "request-times": {"rules": [{"site": "serve.request", "kind": "nan",
                                 "times": 1}]},
    "times-zero": {"rules": [{"site": "registry.fetch", "times": 0}]},
}


def _raised(fn):
    try:
        fn()
    except Exception as exc:  # noqa: BLE001 — compared across packages
        return type(exc).__name__, str(exc)
    return None


@pytest.mark.parametrize("case", sorted(BAD_SPECS))
def test_spec_validation_matches_reference(case):
    spec = BAD_SPECS[case]
    got = _raised(lambda: pfaults.FaultPlan.from_spec(spec))
    assert got is not None and got[0] == "ValueError"
    assert got == _raised(lambda: rfaults.FaultPlan.from_spec(spec))


@pytest.mark.parametrize("site", ["client.compute", "wave.delay",
                                  "serve.request", "client.slow", "bogus"])
def test_check_refuses_non_error_sites(site):
    got = _raised(lambda: pfaults.FaultPlan().check(site, 0))
    assert got == _raised(lambda: rfaults.FaultPlan().check(site, 0))
    assert got[0] == "ValueError" and "unknown error site" in got[1]


def _resolve_both():
    return [_raised(mod.active_plan) or (
        None if mod.active_plan() is None
        else (mod.active_plan().seed, len(mod.active_plan().rules)))
        for mod in (pfaults, rfaults)]


def test_faults_pin_grammar(monkeypatch, tmp_path):
    monkeypatch.delenv("QFEDX_FAULTS", raising=False)
    assert _resolve_both() == [None, None]
    for off in ("", "0", "off", "OFF"):
        monkeypatch.setenv("QFEDX_FAULTS", off)
        assert _resolve_both() == [None, None]
    inline = json.dumps({"seed": 2, "rules": PLANS["crash"]})
    monkeypatch.setenv("QFEDX_FAULTS", inline)
    assert _resolve_both() == [(2, 4), (2, 4)]
    assert pfaults.active_plan() is pfaults.active_plan()  # cached by text
    path = tmp_path / "plan.json"
    path.write_text(inline)
    monkeypatch.setenv("QFEDX_FAULTS", str(path))
    assert _resolve_both() == [(2, 4), (2, 4)]
    # A file is re-read on every call: an edit behind the same path shows.
    path.write_text(json.dumps({"seed": 5, "rules": PLANS["errors"]}))
    assert _resolve_both() == [(5, 6), (5, 6)]
    # An explicit plan beats the pin.
    override = pfaults.FaultPlan(seed=9)
    assert pfaults.resolve_plan(override) is override
    assert pfaults.resolve_plan(None).seed == 5
    # A typo is loud: "of" is a path that does not exist, a broken
    # literal does not parse, a bad rule does not validate.
    for typo in ("of", "{not json", json.dumps({"rules": [{"site": "x"}]})):
        monkeypatch.setenv("QFEDX_FAULTS", typo)
        got = _resolve_both()
        assert got[0] == got[1] and isinstance(got[0][0], str), got


def test_doc_taxonomy_and_tables_equal():
    assert pfaults.doc_taxonomy() == rfaults.doc_taxonomy()
    for name in ("SITES", "CLIENT_KINDS", "BYZANTINE_KINDS", "SLOW_KINDS",
                 "SERVE_REQUEST_KINDS", "_PER_CLIENT_SITES", "_ERROR_SITES"):
        assert getattr(pfaults, name) == getattr(rfaults, name), name
    ids = np.arange(32, dtype=np.uint64)
    for site in pfaults.SITES:
        _same(pfaults._uniform(11, site, 3, 2, ids),
              rfaults._uniform(11, site, 3, 2, ids))
    err = pfaults.FaultInjected("ingest.h2d", 1, 2, 3)
    assert (err.site, err.round_idx, err.wave, err.attempt) == (
        "ingest.h2d", 1, 2, 3)
    assert str(err) == str(rfaults.FaultInjected("ingest.h2d", 1, 2, 3))


def test_sigterm_translation_installs_and_restores():
    before = signal.getsignal(signal.SIGTERM)
    token = host.install_sigterm_interrupt()
    assert token is not None
    try:
        with pytest.raises(KeyboardInterrupt, match="SIGTERM"):
            signal.raise_signal(signal.SIGTERM)
    finally:
        host.restore_sigterm(token)
    assert signal.getsignal(signal.SIGTERM) is before
    host.restore_sigterm(None)  # the no-op token
    # Off the main thread nothing is installed.
    out = []
    t = threading.Thread(target=lambda: out.append(
        host.install_sigterm_interrupt()))
    t.start()
    t.join()
    assert out == [None]
    # A handler installed outside Python (None) comes back as SIG_DFL.
    token = host.install_sigterm_interrupt()
    try:
        host.restore_sigterm((None,))
        assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL
    finally:
        host.restore_sigterm(token)
    assert signal.getsignal(signal.SIGTERM) is before

"""Port vs reference: the observability core on the same inputs.

- ``Histogram``: bucket counts, quantiles, merge and the window delta on
  seeded value streams with underflow, overflow and NaN;
- a registry filled the same way in both packages (spans with meta and
  nesting, counters, gauges, histograms): ``phase_rollup``,
  ``phase_totals``, ``snapshot``, ``chrome_trace_events`` and
  ``render_prometheus`` (apart from the build-info line) are equal;
  spans opened under ``trace_context`` nest and carry meta the same way;
- ``health_payload`` with health sources (one raising), the flight ring,
  its byte bound and its dump, ``merge_trace_shards`` on the same shard
  files, each watch rule's firing and clearing and ``rule_taxonomy``;
- every pin's grammar and its loud typo;
- the registry loses no update under concurrent writers, and the
  /metrics server binds, answers and stops.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import qfedx_tpu.obs as robs
from qfedx_tpu.obs import export as rexport
from qfedx_tpu.obs import flight as rflight
from qfedx_tpu.obs import histo as rhisto
from qfedx_tpu.obs import merge as rmerge
from qfedx_tpu.obs import profile as rprofile
from qfedx_tpu.obs import server as rserver
from qfedx_tpu.obs import trace as rtrace
from qfedx_tpu.obs import watch as rwatch
from qfedx_tpu.utils import pins as rpins
import qfedx_tpu_torch.obs as pobs
from qfedx_tpu_torch.obs import export as pexport
from qfedx_tpu_torch.obs import flight as pflight
from qfedx_tpu_torch.obs import histo as phisto
from qfedx_tpu_torch.obs import merge as pmerge
from qfedx_tpu_torch.obs import profile as pprofile
from qfedx_tpu_torch.obs import server as pserver
from qfedx_tpu_torch.obs import trace as ptrace
from qfedx_tpu_torch.obs import watch as pwatch
from qfedx_tpu_torch.utils import pins as ppins

PKGS = {
    "ref": dict(obs=robs, trace=rtrace, export=rexport, histo=rhisto,
                flight=rflight, server=rserver, watch=rwatch, merge=rmerge),
    "port": dict(obs=pobs, trace=ptrace, export=pexport, histo=phisto,
                 flight=pflight, server=pserver, watch=pwatch, merge=pmerge),
}

_OBS_PINS = ("QFEDX_TRACE", "QFEDX_TRACE_XLA", "QFEDX_FLIGHT",
             "QFEDX_WATCH", "QFEDX_METRICS_PORT", "QFEDX_PROFILE",
             "QFEDX_TUNE", "QFEDX_SERVE_SLO_MS", "QFEDX_WATCH_SHED",
             "QFEDX_WATCH_QUEUE", "QFEDX_WATCH_STALL_S",
             "QFEDX_WATCH_LOSS_MAX", "QFEDX_WATCH_EPS")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on one CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _reset_all():
    for p in PKGS.values():
        p["watch"].reset()
        p["server"].stop_server()
        p["obs"].reset()
        p["flight"].reset()
        with p["server"]._lock:
            p["server"]._health_sources.clear()
        p["server"]._last_status = "ok"


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    """Every obs pin unset and both packages' process state empty, before
    and after each test."""
    for pin in _OBS_PINS:
        monkeypatch.delenv(pin, raising=False)
    _reset_all()
    yield
    _reset_all()


# --- histograms ---------------------------------------------------------------


def _stream(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    vals = 10.0 ** rng.uniform(-8.0, 8.0, n)  # under- and overflow both
    vals[::97] = np.nan
    vals[1::89] = 0.0
    return vals


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_equals_reference(seed):
    assert (phisto.LO, phisto.BUCKETS_PER_DECADE, phisto.DECADES) == (
        rhisto.LO, rhisto.BUCKETS_PER_DECADE, rhisto.DECADES)
    for i in range(phisto.NUM_BUCKETS + 1):
        assert phisto.bucket_edge(i) == rhisto.bucket_edge(i)
    vals = _stream(seed, 3000)
    hs = {k: (p["histo"].Histogram(), p["histo"].Histogram())
          for k, p in PKGS.items()}
    deltas = {k: [] for k in PKGS}
    for i, v in enumerate(vals):
        for k, (a, b) in hs.items():
            (a if i % 3 else b).record(v)
            if i % 500 == 499:
                deltas[k].append(a.snapshot_delta())
    for k, (a, b) in hs.items():
        deltas[k].append(a.snapshot_delta())
    p, r = hs["port"][0], hs["ref"][0]
    assert p._counts == r._counts and p.count == r.count
    # NaN lands in the underflow bucket and makes the sums NaN.
    assert json.dumps(deltas["port"]) == json.dumps(deltas["ref"])
    qs = (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0)
    assert [p.percentile(q) for q in qs] == [r.percentile(q) for q in qs]
    assert p.nonzero_buckets() == r.nonzero_buckets()
    for v in (0.0, 1e-9, 3.3e-3, 2.0, 5e7):
        assert phisto.Histogram.bucket_bounds(v) == (
            rhisto.Histogram.bucket_bounds(v))
    merged = {k: a.merge(b) for k, (a, b) in hs.items()}
    assert merged["port"]._counts == merged["ref"]._counts
    assert json.dumps(merged["port"].snapshot()) == json.dumps(
        merged["ref"].snapshot())


# --- the registry and its exporters -------------------------------------------

# (name, t0, t1, depth, parent index, thread, meta, compile_s)
_SPANS = [
    ("round.dispatch", 0.010, 0.250, 0, None, 0, {"round": 1, "chunk": 2},
     0.125),
    ("fed.trace.local_update", 0.020, 0.200, 1, 0, 0, {"path": "folded"},
     0.0),
    ("round.fetch", 0.260, 0.300, 0, None, 0, {"round": 1}, 0.0),
    ("checkpoint.async_write", 0.270, 0.310, 0, None, 1, {"round": 1}, 0.0),
    ("round.dispatch", 0.400, 0.450, 0, None, 0, {"round": 3, "chunk": 2},
     0.0),
    ("serve.compute", 0.500, 0.5003, 0, None, 0,
     {"batch": 3, "reqs": "0,1,2", "obj": (1, 2)}, 0.0),
]


def _fill(p):
    """The same registry content in package ``p``: spans with injected
    times, counters, gauges and histograms."""
    reg = p["trace"].registry()
    made = []
    for name, t0, t1, depth, parent, thread, meta, comp in _SPANS:
        sp = p["trace"].Span(name, dict(meta))
        sp.t0, sp.t1 = reg.origin + t0, reg.origin + t1
        sp.depth = depth
        sp.parent = None if parent is None else made[parent]
        sp.tid = 1000 + thread
        sp.tname = ("MainThread", "qfedx-ckpt-writer")[thread]
        sp.compile_s = comp
        made.append(sp)
        reg.add_span(sp)
    for name, inc in (("fed.rejected_updates", 2), ("fuse.passes", 1),
                      ("fed.rejected_updates", 3), ("serve.batches", 4)):
        p["trace"].counter(name, inc)
    p["trace"].gauge("fed.loss", 0.6931)
    p["trace"].gauge("ingest.queue_depth", 2)
    for v in (1.5, 2.5, 40.0, 0.02):
        p["trace"].histogram("serve.latency_ms", v)
    reg.set_span_device("round.dispatch", 0.1, 0.4)


def test_registry_exports_equal_reference(monkeypatch):
    monkeypatch.setenv("QFEDX_TRACE", "1")
    for p in PKGS.values():
        _fill(p)
    got = {k: p["export"] for k, p in PKGS.items()}
    assert got["port"].phase_rollup() == got["ref"].phase_rollup()
    assert got["port"].phase_totals() == got["ref"].phase_totals()
    assert got["port"].snapshot() == got["ref"].snapshot()
    ev = {k: e.chrome_trace_events() for k, e in got.items()}
    # The process lane names its package; everything else is equal.
    assert ev["port"][0]["args"] == {"name": "qfedx_tpu_torch"}
    ev["port"][0]["args"] = ev["ref"][0]["args"]
    assert ev["port"] == ev["ref"]
    spans = [s for s in PKGS["port"]["trace"].registry().spans]
    assert got["port"].phase_rollup(spans) == got["ref"].phase_rollup(
        [s for s in PKGS["ref"]["trace"].registry().spans])

    def prom(srv):
        return [ln for ln in srv.render_prometheus().splitlines()
                if "qfedx_build_info" not in ln]

    assert prom(pserver) == prom(rserver)
    labels = pserver.build_info_labels()
    assert labels["torch"] == torch.__version__
    assert labels["device"] == "cpu"


def test_spans_nest_and_carry_context_like_reference(monkeypatch):
    monkeypatch.setenv("QFEDX_TRACE", "1")
    out = {}
    for k, p in PKGS.items():
        o = p["obs"]
        with o.span("outer", a=1) as sp:
            sp.set(b=2)
            with o.trace_context(reqs="4,5", a=9):
                with o.span("inner", a=3):
                    with o.trace_context(reqs="6"):
                        with o.span("leaf"):
                            o.counter("c")
            with o.span("after"):
                pass
        with o.trace_context(x=1):
            try:
                with o.span("crash"):
                    with o.span("child"):
                        raise RuntimeError("boom")
            except RuntimeError:
                pass
        reg = p["trace"].registry()
        out[k] = [(s.name, s.depth, None if s.parent is None
                   else s.parent.name, s.meta) for s in reg.spans]
        assert not reg.stack() and not reg.context()
    assert out["port"] == out["ref"]


def test_disabled_path_is_shared_null_span(monkeypatch):
    for value in (None, "0", "off"):
        if value is None:
            monkeypatch.delenv("QFEDX_TRACE", raising=False)
        else:
            monkeypatch.setenv("QFEDX_TRACE", value)
        with pobs.span("x") as a, pobs.span("y") as b:
            assert a is b is ptrace._NULL_SPAN
        pobs.counter("c")
        pobs.histogram("h", 1.0)
        assert pobs.record_device_memory() is None
        assert ptrace.registry().spans == []
        assert ptrace.registry().counters == {}


def test_compile_time_attributed_to_the_open_span(monkeypatch):
    monkeypatch.setenv("QFEDX_TRACE", "1")
    ptrace.attribute_compile("kernel_build", 0.5)
    with pobs.span("round.dispatch") as sp:
        with pobs.span("engine.trace"):
            ptrace.attribute_compile("kernel_build", 2.0)
        ptrace.attribute_compile("kernel_build", 1.0)
    reg = ptrace.registry()
    assert sp.compile_s == 1.0
    assert [s.compile_s for s in reg.spans] == [2.0, 1.0]
    assert reg.counters == {"compile.kernel_build_s": 3.5,
                            "compile.unattributed_s": 0.5}
    assert pobs.phase_rollup()["round.dispatch"]["compile_s"] == 1.0


def test_registry_hammer_concurrent_writers_lose_nothing(monkeypatch):
    """Uploader, batcher, watchdog and server threads bump the same
    instruments; the registry loses no increment, observation or span."""
    monkeypatch.setenv("QFEDX_TRACE", "1")
    threads_n, per_thread = 8, 1500

    def hammer(tid):
        for i in range(per_thread):
            pobs.counter("hammer.count")
            pobs.counter("hammer.weighted", 2.0)
            pobs.histogram("hammer.histo", 1.0 + (i % 7))
            pobs.gauge(f"hammer.gauge_{tid}", float(i))
        with pobs.span("hammer.span"):
            pass

    threads = [threading.Thread(target=hammer, args=(t,))
               for t in range(threads_n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    reg = pobs.registry()
    assert reg.counters["hammer.count"] == threads_n * per_thread
    assert reg.counters["hammer.weighted"] == 2.0 * threads_n * per_thread
    assert reg.histos["hammer.histo"].count == threads_n * per_thread
    assert sum(1 for s in reg.spans if s.name == "hammer.span") == threads_n
    for t in range(threads_n):
        assert reg.gauges[f"hammer.gauge_{t}"] == float(per_thread - 1)


# --- /healthz, the server -----------------------------------------------------


def test_health_payload_equals_reference(monkeypatch):
    for k, p in PKGS.items():
        srv = p["server"]
        srv.set_health_source("trainer", lambda: {
            "last_completed_round": 3, "last_flush_age_s": 0.5})
        srv.set_health_source("serve", lambda: {"queue_depth": 2,
                                                "max_queue": 8})
    got = {k: p["server"].health_payload() for k, p in PKGS.items()}
    assert got["port"] == got["ref"] and got["port"]["status"] == "ok"

    def sick():
        raise RuntimeError("probe died")

    for p in PKGS.values():
        p["server"].set_health_source("broken", sick)
    monkeypatch.setenv("QFEDX_FLIGHT", "16")
    got = {k: p["server"].health_payload() for k, p in PKGS.items()}
    assert got["port"] == got["ref"]
    assert got["port"]["status"] == "degraded"
    assert got["port"]["components"]["broken"] == {
        "error": "RuntimeError: probe died"}
    strip = [{k: v for k, v in e.items() if k != "t"}
             for e in pflight.events()]
    assert strip == [{k: v for k, v in e.items() if k != "t"}
                     for e in rflight.events()]
    fn = lambda: {}  # noqa: E731
    pserver.set_health_source("serve", fn)
    pserver.clear_health_source("serve", only_if=lambda: {})
    assert "serve" in pserver.health_components()
    pserver.clear_health_source("serve", only_if=fn)
    assert "serve" not in pserver.health_components()


def test_metrics_server_serves_and_stops(monkeypatch):
    srv = pserver.start_server(0)
    try:
        assert pserver.start_server(0) is srv  # one server per process
        assert ptrace.metrics_enabled()  # live gate without QFEDX_TRACE
        pobs.counter("serve.batches", 3)
        base = f"http://127.0.0.1:{srv.port}"
        body = urllib.request.urlopen(base + "/metrics", timeout=10).read()
        assert "qfedx_serve_batches 3.0" in body.decode()
        health = json.loads(urllib.request.urlopen(
            base + "/healthz", timeout=10).read())
        assert health["status"] == "ok" and "uptime_s" in health
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(base + "/nope", timeout=10)
        assert err.value.code == 404
        # A second process's endpoint on a taken port degrades, never
        # raises.
        monkeypatch.setenv("QFEDX_METRICS_PORT", str(srv.port))
        with pserver._lock:
            saved, pserver._server = pserver._server, None
        try:
            with pytest.warns(RuntimeWarning, match="not started"):
                assert pserver.maybe_start() is None
        finally:
            with pserver._lock:
                pserver._server = saved
    finally:
        pserver.stop_server()
    assert pserver.active_server() is None
    assert not ptrace.metrics_enabled()


# --- the flight recorder ------------------------------------------------------


def test_flight_ring_bound_and_dump_equal_reference(monkeypatch, tmp_path):
    monkeypatch.setenv("QFEDX_FLIGHT", "12")
    docs = {}
    for k, p in PKGS.items():
        fl = p["flight"]
        for i in range(40):
            fl.record("span", f"s{i}", ms=i * 0.123456789, note="x" * 400)
            p["trace"].counter("c", i)
            p["trace"].gauge("g", i / 3)
        fl.on_health("degraded", "ok")
        assert len(fl.events()) == 12 and fl.dropped() == 40 * 3 + 1 - 12
        path = fl.dump(tmp_path / k / "flight.json", reason="alert." + "r" * 300)
        raw = path.read_text()
        assert len(raw) <= fl.byte_bound()
        doc = json.loads(raw)
        for ev in doc["events"]:
            ev.pop("t")
        doc.pop("ts"), doc.pop("pid")
        docs[k] = doc
        info = fl.last_dump()
        assert info["bytes"] == len(raw) and info["events"] == len(
            doc["events"])
    assert docs["port"] == docs["ref"]
    # The byte bound sheds the oldest events (one clock for both, so the
    # two dumps have the same bytes).
    monkeypatch.setattr(rflight.time, "time", lambda: 1700000000.125)
    monkeypatch.setenv("QFEDX_FLIGHT", "1")
    for k, p in PKGS.items():
        fl = p["flight"]
        fl.reset()
        for i in range(300):
            fl.record("span", "n" * 150, **{f: f * 150 for f in "abcdef"})
        doc = json.loads(fl.dump(tmp_path / f"{k}2.json").read_text())
        docs[k] = (doc["shed_for_bound"], len(doc["events"]),
                   doc["capacity"], doc["dropped"])
    assert docs["port"] == docs["ref"] and docs["port"][0] > 0
    monkeypatch.setenv("QFEDX_FLIGHT", "off")
    assert pflight.dump(tmp_path / "off.json") is None
    assert pflight.maybe_dump() is None


# --- shards and the merge -----------------------------------------------------


def test_merge_trace_shards_equals_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("QFEDX_TRACE", "1")
    shards = tmp_path / "shards"
    for idx, origin in ((1, 1000.25), (0, 1000.0), (3, 999.5)):
        _reset_all()
        for p in PKGS.values():
            _fill(p)
        pmerge.write_trace_shard(shards, process_index=idx)
        obj = json.loads(pmerge.shard_path(shards, idx).read_text())
        obj["qfedx_shard"]["origin_unix"] = origin
        pmerge.shard_path(shards, idx).write_text(json.dumps(obj))
    assert [p.name for p in pmerge.find_shards(shards)] == [
        p.name for p in rmerge.find_shards(shards)]
    got = pmerge.merge_trace_shards(shards, tmp_path / "p.json")
    want = rmerge.merge_trace_shards(shards, tmp_path / "r.json")
    assert got == want
    assert json.loads((tmp_path / "p.json").read_text()) == want
    lane = {"traceEvents": []}
    dev = [{"name": "k", "ts": 1.0, "dur": 2.0, "lane": 0},
           {"name": "m", "ts": 4.0, "dur": 1.5, "lane": 1}]
    assert pmerge.add_device_lane(dict(lane), dev, 10.0) == (
        rmerge.add_device_lane({"traceEvents": []}, dev, 10.0))
    assert pmerge._process_index() == 0
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        pmerge.merge_trace_shards(tmp_path / "empty")


# --- the watchdog -------------------------------------------------------------


def _watch_round(p, state: str) -> None:
    """Drive package ``p``'s registry and health sources into ``state``:
    quiet, firing (every rule over its threshold) or cleared."""
    tr = p["trace"]
    srv = p["server"]
    if state == "quiet":
        for _ in range(25):
            tr.histogram("serve.latency_ms", 1.0)
        tr.counter("serve.requests_shed", 1)
        tr.gauge("fed.loss", 0.5)
        tr.gauge("fed.epsilon", 1.0)
        srv.set_health_source("serve", lambda: {"queue_depth": 1,
                                                "max_queue": 10})
        srv.set_health_source("trainer", lambda: {"last_flush_age_s": 1.0})
    elif state == "firing":
        for _ in range(200):
            tr.histogram("serve.latency_ms", 900.0)
        tr.counter("serve.requests_shed", 4)
        tr.counter("serve.requests_rejected", 2)
        tr.gauge("fed.loss", float("nan"))
        tr.gauge("fed.epsilon", 9.0)
        srv.set_health_source("serve", lambda: {"queue_depth": 10,
                                                "max_queue": 10})
        srv.set_health_source("trainer", lambda: {"last_flush_age_s": 500.0})
    else:
        p["obs"].reset()
        tr.gauge("fed.loss", 0.25)
        srv.set_health_source("serve", lambda: {"queue_depth": 0,
                                                "max_queue": 10})
        srv.set_health_source("trainer", lambda: {"last_flush_age_s": 0.1})


def test_watch_rules_fire_and_clear_like_reference(monkeypatch):
    monkeypatch.setenv("QFEDX_WATCH", "on")
    monkeypatch.setenv("QFEDX_SERVE_SLO_MS", "50")
    monkeypatch.setenv("QFEDX_WATCH_SHED", "3")
    monkeypatch.setenv("QFEDX_WATCH_EPS", "8")
    monkeypatch.setenv("QFEDX_WATCH_LOSS_MAX", "10")
    assert pwatch.RULE_IDS == rwatch.RULE_IDS
    assert pwatch.rule_taxonomy() == rwatch.rule_taxonomy()
    assert pwatch.P95_MIN_COUNT == rwatch.P95_MIN_COUNT == 20
    seen = {}
    for k, p in PKGS.items():
        events = []
        p["watch"].set_event_sink(events.append)
        log = []
        for state in ("quiet", "firing", "firing", "cleared"):
            _watch_round(p, state)
            active = p["watch"].evaluate_once()
            log.append([{f: a[f] for f in ("rule", "value", "threshold",
                                           "detail")} for a in active])
            alerts = p["server"].health_payload()["alerts"]
            for a in alerts["active"]:
                a.pop("since")
            log.append(alerts)
            log.append(p["server"].health_payload()["status"])
        gauges = {n: v for n, v in p["trace"].registry().gauges.items()
                  if n.startswith("alert.")}
        seen[k] = (log, events, p["watch"].fired_totals(), gauges)
    for a, b in zip(seen["port"][0], seen["ref"][0]):
        assert json.dumps(a, sort_keys=True, default=str) == json.dumps(
            b, sort_keys=True, default=str)
    # The loss rule fires on NaN, so compare through JSON.
    assert json.dumps(seen["port"][1:]) == json.dumps(seen["ref"][1:])
    fired = {e["rule"] for e in seen["port"][1] if e["state"] == "firing"}
    cleared = {e["rule"] for e in seen["port"][1] if e["state"] == "cleared"}
    assert fired == cleared == set(pwatch.RULE_IDS)
    monkeypatch.setenv("QFEDX_WATCH", "off")
    assert pwatch.evaluate_once() == [] and not pwatch.maybe_start()


def test_watch_ticker_starts_once_and_stops(monkeypatch):
    monkeypatch.setenv("QFEDX_WATCH", "30")
    assert pwatch.maybe_start() and pwatch.maybe_start()
    assert ptrace.metrics_enabled()
    alive = [t for t in threading.enumerate() if t.name == "qfedx-watchdog"]
    assert len(alive) == 1
    pwatch.stop()
    assert not alive[0].is_alive()


# --- pins ---------------------------------------------------------------------


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except ValueError as exc:
        return ("err", str(exc))


@pytest.mark.parametrize("value", [
    None, "0", "off", "OFF", "1", "on", "On", "yes", "2", "0.5", "-1",
    "65535", "65536", "8080", "", " 1", "~/prof", "./p", "/tmp/p", "abc",
])
def test_pin_grammar_equals_reference(monkeypatch, value):
    name = "QFEDX_OBS_PROBE"
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)
    for fn, args in (("bool_pin", (name, False)), ("port_pin", (name, 0)),
                     ("depth_pin", (name, 0, 256)),
                     ("interval_pin", (name, 1.0)),
                     ("str_pin", (name,))):
        assert _outcome(getattr(ppins, fn), *args) == _outcome(
            getattr(rpins, fn), *args), fn
    assert ppins.pin_is_set(name) == rpins.pin_is_set(name)
    for pin, mods in (
        ("QFEDX_TRACE", (ptrace.enabled, rtrace.enabled)),
        ("QFEDX_TRACE_XLA", (ptrace.xla_annotations_enabled,
                             rtrace.xla_annotations_enabled)),
        ("QFEDX_FLIGHT", (pflight.capacity, rflight.capacity)),
        ("QFEDX_WATCH", (pwatch.interval_s, rwatch.interval_s)),
        ("QFEDX_METRICS_PORT", (pserver.metrics_port, rserver.metrics_port)),
        ("QFEDX_PROFILE", (pprofile.profile_dir, rprofile.profile_dir)),
    ):
        if value is None:
            monkeypatch.delenv(pin, raising=False)
        else:
            monkeypatch.setenv(pin, value)
        assert _outcome(mods[0]) == _outcome(mods[1]), pin
        monkeypatch.delenv(pin, raising=False)


def test_set_and_clear_pin(monkeypatch):
    monkeypatch.delenv("QFEDX_OBS_PROBE", raising=False)
    ppins.set_pin("QFEDX_OBS_PROBE", "1")
    assert ppins.pin_is_set("QFEDX_OBS_PROBE")
    assert ppins.bool_pin("QFEDX_OBS_PROBE", False)
    ppins.clear_pin("QFEDX_OBS_PROBE")
    ppins.clear_pin("QFEDX_OBS_PROBE")
    assert not ppins.pin_is_set("QFEDX_OBS_PROBE")


def test_obs_all_mirrors_reference():
    ref = set(robs.__all__) - {"count_state_ops", "lowered_state_ops",
                               "module_counts"}
    assert set(pobs.__all__) == ref | {"census"}
    for name in pobs.__all__:
        assert getattr(pobs, name) is not None

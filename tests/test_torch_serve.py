"""Port vs reference: the serving engine and micro-batcher.

- ``ServeEngine`` (buckets 1/8/32) on the port answers the reference's
  ``ServeEngine`` within 2e-5 on the same requests and weights (at n=10;
  the n=12 L=3 slice's logits are held in tests/test_torch_vqc.py);
- padding is invisible: real rows are bit-identical to the unpadded
  forward;
- ``MicroBatcher``: bucket-full flush before the deadline, ``Overloaded``
  past ``max_queue``, ``RequestError`` on NaN, drain answers everything;
- a device-less engine raises when CUDA is absent.
"""

import threading

import jax
import numpy as np
import pytest
import torch

from qfedx_tpu.models.vqc import make_vqc_classifier as ref_make
from qfedx_tpu.ops import fuse as rfuse
from qfedx_tpu.serve import ServeConfig as RefConfig
from qfedx_tpu.serve import ServeEngine as RefEngine
from qfedx_tpu_torch.models.vqc import make_vqc_classifier, params_from_jax
from qfedx_tpu_torch.serve import (
    MicroBatcher,
    Overloaded,
    RequestError,
    ServeConfig,
    ServeEngine,
    ShuttingDown,
    cached_routes,
    persistent_forward,
)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite runs
    several workers on one CPU, where torch's default pool per worker
    oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


ATOL = 2e-5
N = 10  # batcher tests: the narrowest slab width keeps them quick


@pytest.fixture
def tpu_form(monkeypatch):
    for pin in ("QFEDX_FUSE", "QFEDX_SCAN_LAYERS", "QFEDX_PALLAS",
                "QFEDX_BATCHED"):
        monkeypatch.setenv(pin, "1")
    monkeypatch.setenv("QFEDX_GATE_FORM", "flip")
    monkeypatch.setenv("QFEDX_SLAB_LANES", "matmul")
    monkeypatch.setattr(rfuse, "_gather_ok", lambda: True)
    monkeypatch.setattr(rfuse, "_growmat_merge_ok", lambda: True)


def _rows(m, n=N, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (m, n)).astype(
        np.float32
    )


def _engine(buckets=(1, 2, 4), deadline_ms=150.0, max_queue=8, n=N):
    model = make_vqc_classifier(n, 2, 2, init_scale=1.0, device="cpu")
    cfg = ServeConfig(buckets=buckets, deadline_ms=deadline_ms,
                      max_queue=max_queue)
    return ServeEngine(model, model.init(0), (n,), config=cfg, device="cpu")


def test_engine_matches_reference_engine(tpu_form):
    n, layers = N, 2
    ref_model = ref_make(n, layers, 2)
    params = jax.tree.map(
        lambda a: np.asarray(a) * 10.0,
        ref_model.init(jax.random.PRNGKey(3)),
    )
    ref = RefEngine(ref_model, params, (n,),
                    config=RefConfig(buckets=(1, 8, 32)))
    ref.warmup()
    model = make_vqc_classifier(n, layers, 2, device="cpu")
    eng = ServeEngine(model, params_from_jax(params, device="cpu"), (n,),
                      config=ServeConfig(buckets=(1, 8, 32)), device="cpu")
    warm = eng.warmup()
    assert sorted(warm["buckets"]) == [1, 8, 32]
    assert warm["route_resolved"]["pallas"] is True
    assert warm["kernel_builds"] == 0  # CPU tensors never build the kernel
    for m in (1, 5, 32):
        x = _rows(m, n, seed=m)
        got = eng.infer(x)
        np.testing.assert_allclose(got, ref.infer(x), atol=ATOL, rtol=0)
        post = eng.postprocess(got)
        assert post["probs"].shape == (m, 2)
        np.testing.assert_allclose(post["probs"].sum(-1), 1.0, rtol=1e-6)


def test_padding_is_invisible():
    eng = _engine(buckets=(1, 8))
    x = _rows(5, seed=1)
    padded = eng.infer(x)  # 5 real rows + 3 zero rows in bucket 8
    with torch.no_grad():
        direct = eng.model.apply(eng.params, x).numpy()
    assert padded.shape == (5, 2)
    np.testing.assert_array_equal(padded, direct)


def test_config_validation_and_pins(monkeypatch):
    with pytest.raises(ValueError, match="ascending"):
        ServeConfig(buckets=(4, 2))
    with pytest.raises(ValueError, match="max_queue"):
        ServeConfig(max_queue=0)
    monkeypatch.setenv("QFEDX_SERVE_BUCKETS", "2,16")
    monkeypatch.setenv("QFEDX_SERVE_QUEUE", "9")
    cfg = ServeConfig.resolve()
    assert cfg.buckets == (2, 16) and cfg.max_queue == 9
    assert ServeConfig.resolve(buckets=(4,)).buckets == (4,)
    monkeypatch.setenv("QFEDX_SERVE_BUCKETS", "fast")
    with pytest.raises(ValueError, match="QFEDX_SERVE_BUCKETS"):
        ServeConfig.resolve()


def test_bucket_full_flush_beats_deadline():
    eng = _engine(buckets=(1, 4), deadline_ms=10_000.0)
    with MicroBatcher(eng) as mb:
        futs = [mb.submit(r) for r in _rows(4)]
        out = [f.result(timeout=30) for f in futs]
    assert mb.stats["full_flushes"] == 1
    assert mb.stats["deadline_flushes"] == 0
    assert mb.stats["served"] == 4
    direct = eng.infer(_rows(4))
    np.testing.assert_array_equal(np.stack([o["logits"] for o in out]),
                                  direct)


def test_deadline_flush_serves_a_partial_bucket():
    eng = _engine(buckets=(1, 4), deadline_ms=20.0)
    with MicroBatcher(eng) as mb:
        fut = mb.submit(_rows(1)[0])
        res = fut.result(timeout=30)
    assert mb.stats["deadline_flushes"] == 1
    assert res["pred"] in (0, 1)


def test_overloaded_past_max_queue():
    eng = _engine(max_queue=3)
    mb = MicroBatcher(eng)  # not started: nothing drains the queue
    for r in _rows(3):
        mb.submit(r)
    with pytest.raises(Overloaded):
        mb.submit(_rows(1)[0])
    assert mb.stats["shed"] == 1
    mb.close(drain=False)


def test_request_errors_are_per_request():
    eng = _engine()
    with MicroBatcher(eng) as mb:
        bad = np.full((N,), np.nan, dtype=np.float32)
        with pytest.raises(RequestError, match="NaN"):
            mb.submit(bad)
        with pytest.raises(RequestError, match="shape"):
            mb.submit(np.zeros(N + 1, dtype=np.float32))
        good = mb.submit(_rows(1)[0]).result(timeout=30)
    assert np.all(np.isfinite(good["logits"]))
    assert mb.stats["rejected"] == 2 and mb.stats["served"] == 1


def test_drain_answers_everything():
    eng = _engine(buckets=(1, 4), deadline_ms=60_000.0, max_queue=16)
    mb = MicroBatcher(eng).start()
    futs = [mb.submit(r) for r in _rows(6)]
    mb.close(drain=True, timeout=60)
    assert all(f.done() for f in futs)
    assert [f.result()["pred"] in (0, 1) for f in futs] == [True] * 6
    with pytest.raises(ShuttingDown):
        mb.submit(_rows(1)[0])


def test_close_without_drain_fails_pending():
    eng = _engine(buckets=(1, 4), deadline_ms=60_000.0)
    mb = MicroBatcher(eng)
    futs = [mb.submit(r) for r in _rows(2)]
    mb.start()
    mb.close(drain=False, timeout=60)
    for f in futs:
        with pytest.raises(ShuttingDown):
            f.result(timeout=1)


def test_forward_facade_keys_on_routing_pins(monkeypatch):
    model = make_vqc_classifier(N, 2, 2, device="cpu")
    params = model.init(0)
    fwd = persistent_forward(model.apply)
    assert persistent_forward(model.apply) is fwd
    monkeypatch.setenv("QFEDX_PALLAS", "1")
    a = fwd(params, _rows(2))
    assert cached_routes(model.apply) == 1
    monkeypatch.setenv("QFEDX_PALLAS", "0")
    b = fwd(params, _rows(2))
    assert cached_routes(model.apply) == 2
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=0)


def test_concurrent_submitters():
    eng = _engine(buckets=(1, 4), deadline_ms=5.0, max_queue=64)
    results = []
    with MicroBatcher(eng) as mb:
        def client(seed):
            for r in _rows(4, seed=seed):
                results.append(mb.submit(r).result(timeout=30))

        threads = [threading.Thread(target=client, args=(s,)) for s in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    assert len(results) == 12 and mb.stats["served"] == 12


def test_device_less_engine_raises_without_cuda(monkeypatch):
    model = make_vqc_classifier(N, 2, 2, device="cpu")
    params = model.init(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, params, (N,))


def test_retry_policy():
    from qfedx_tpu.utils.retry import jitter_factor as ref_jitter
    from qfedx_tpu_torch.utils.retry import (
        RetryExhausted,
        jitter_factor,
        retry_with_deadline,
    )

    assert jitter_factor("serve/3", 1) == ref_jitter("serve/3", 1)
    sleeps, calls = [], []

    def flaky(k):
        calls.append(k)
        if k < 2:
            raise OSError("transient")
        return "ok"

    assert retry_with_deadline(flaky, attempts=3, base_delay_s=0.01,
                               sleep=sleeps.append) == "ok"
    assert calls == [0, 1, 2] and sleeps == [0.01, 0.02]
    with pytest.raises(RetryExhausted) as info:
        retry_with_deadline(lambda k: 1 / 0, attempts=2, sleep=lambda s: None)
    assert isinstance(info.value.last, ZeroDivisionError)

"""The port's replicated HTTP surface, mirrored from the JAX package's
``tests/test_replication.py`` — ``TestRetryPolicy``, ``TestCircuitBreaker``,
``TestReplicationConfig`` and ``TestReplicatedHTTP`` (its ``replicated``
fixture built from port engines) — and held against that package over the
wire.

Across packages (``TestAcrossPackagesHTTP``): a ``repro`` server and a
``repro_torch`` server get the same docs, tenants and metadata over HTTP
and answer one request script — equal statuses (every 4xx / 5xx case of
the error taxonomy among them), equal error-payload keys and
``Retry-After`` / ``degraded`` / ``cache`` headers, equal search ids with
scores within ``rtol=1e-5, atol=1e-4`` (the engine-parity tolerance of
``tests/test_torch_engine.py``: XLA and torch sum the float32 products in
another order), equal key sets of ``/v1/stats`` and ``/healthz?deep=1`` and
equal metric families on ``/metrics``.  Then routers of one package front
replicas of the other on one state directory: read-your-writes through
``min_seq`` and failover behave as within one package.

Port engines run on ``device="cpu"``; ``repro`` runs as its own tests run
it, on the CPU.  Every request carries a timeout, so a broken path fails
the test instead of hanging the suite.
"""

import http.client
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side
torch.set_num_threads(1)

from repro_torch.engine import (
    EngineDriver,
    PrimaryReplication,
    ReplicaApplier,
    ReplicationConfig,
    RetrievalEngine,
)
from repro_torch.serve import (
    CircuitBreaker,
    ReplicaRouter,
    RetryPolicy,
    http_call,
    serve_in_thread,
)

D = 16
RNG = np.random.default_rng(11)
RTOL, ATOL = 1e-5, 1e-4
WAIT = 30.0
KW = dict(d_start=8, k0=8, final_k=4, buckets=(1, 2), capacity=256,
          block_n=64)


def fresh_engine(capacity=256):
    return RetrievalEngine(D, d_start=8, k0=8, final_k=4, buckets=(1, 2),
                           capacity=capacity, block_n=64, device="cpu")


def make_primary(state_dir, n_docs=6):
    eng = fresh_engine()
    eng.enable_durability(state_dir)
    if n_docs:
        eng.add_docs(RNG.normal(size=(n_docs, D)).astype(np.float32))
    return eng


def wait_until(pred, timeout=WAIT, msg="condition"):
    deadline = time.perf_counter() + timeout
    while not pred():
        if time.perf_counter() >= deadline:
            raise TimeoutError(f"timed out waiting: {msg}")
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# failure-handling primitives shared by router and CLI client
# ---------------------------------------------------------------------------
class TestRetryPolicy:
    def test_retryable_statuses(self):
        rp = RetryPolicy()
        assert all(rp.retryable(s) for s in (0, 503, 504))
        assert not any(rp.retryable(s)
                       for s in (200, 400, 403, 404, 429, 500))

    def test_run_retries_until_final(self):
        rp = RetryPolicy(max_attempts=4, jitter=0.0)
        calls = []

        def fn(attempt):
            calls.append(attempt)
            return (503, {}) if attempt < 2 else (200, {"ok": True})

        status, payload = rp.run(fn, sleep=lambda s: None)
        assert status == 200 and payload["ok"]
        assert calls == [0, 1, 2]

    def test_run_never_retries_4xx(self):
        rp = RetryPolicy(max_attempts=5)
        calls = []

        def fn(attempt):
            calls.append(attempt)
            return 429, {}

        status, _ = rp.run(fn, sleep=lambda s: None)
        assert status == 429 and calls == [0]

    def test_backoff_grows_and_caps(self):
        rp = RetryPolicy(backoff_s=0.1, backoff_max_s=0.4, jitter=0.0)
        assert rp.backoff(0) == pytest.approx(0.1)
        assert rp.backoff(1) == pytest.approx(0.2)
        assert rp.backoff(5) == pytest.approx(0.4)


class TestCircuitBreaker:
    def test_open_half_open_close_cycle(self):
        now = [0.0]
        br = CircuitBreaker(threshold=2, open_s=1.0, open_max_s=4.0,
                            clock=lambda: now[0])
        assert br.allow()
        br.record_failure()
        assert br.allow()                       # one failure: still closed
        br.record_failure()
        assert br.state == "open" and not br.allow()
        now[0] = 1.01                           # backoff elapsed
        assert br.allow()                       # non-consuming check
        br.on_attempt()                         # the trial is claimed here
        assert br.state == "half_open"
        assert not br.allow()                   # single trial in flight
        br.record_success()
        assert br.state == "closed" and br.allow()

    def test_reopen_doubles_backoff_capped(self):
        now = [0.0]
        br = CircuitBreaker(threshold=1, open_s=1.0, open_max_s=2.0,
                            clock=lambda: now[0])
        br.record_failure()                     # trip 1: 1s
        now[0] = 1.01
        br.allow(), br.on_attempt()
        br.record_failure()                     # trip 2: 2s
        now[0] = 2.0
        assert not br.allow()
        now[0] = 3.02
        br.allow(), br.on_attempt()
        br.record_failure()                     # trip 3: capped at 2s
        assert br.summary()["n_trips"] == 3
        now[0] = 5.05
        assert br.allow()


class TestReplicationConfig:
    def test_defaults_and_round_trip(self):
        from repro_torch.engine import EngineConfig

        cfg = EngineConfig(d_emb=D, d_start=8, replication=ReplicationConfig(
            role="follower", poll_s=0.02, ready_lag_max=3))
        again = EngineConfig.from_dict(cfg.to_dict())
        assert again.replication == cfg.replication
        assert ReplicationConfig().role == "single"

    def test_validation(self):
        with pytest.raises(ValueError):
            ReplicationConfig(role="leader")
        with pytest.raises(ValueError):
            ReplicationConfig(poll_s=0.0)
        with pytest.raises(ValueError):
            ReplicationConfig(ready_lag_max=-1)
        with pytest.raises(ValueError):
            ReplicationConfig.from_dict({"role": "single", "bogus": 1})


# ---------------------------------------------------------------------------
# the replicated HTTP surface: primary + read-only follower + router
# ---------------------------------------------------------------------------
@pytest.fixture()
def replicated(tmp_path):
    state = str(tmp_path / "state")
    prim = make_primary(state, n_docs=0)
    foll = fresh_engine()
    applier = ReplicaApplier(foll, state, poll_s=0.01)
    applier.bootstrap()
    applier.start()
    with EngineDriver(prim, max_wait_ms=1.0) as pdrv, \
            EngineDriver(foll, max_wait_ms=1.0) as fdrv:
        ph = serve_in_thread(prim, pdrv, require_tenant=False,
                             replication=PrimaryReplication(prim))
        fh = serve_in_thread(foll, fdrv, require_tenant=False,
                             replication=applier, read_only=True)
        try:
            yield ph, fh, prim, foll, applier
        finally:
            fh.stop()
            ph.stop()
            applier.stop()
            prim.wal.close()


def router_spreads_and_fails_over(router_cls, ph, fh):
    """The router test of ``TestReplicatedHTTP``, with the router class of
    either package: read-your-writes on both replicas, then failover."""
    vecs = RNG.normal(size=(4, D)).astype(np.float32)
    router = router_cls([ph.url, fh.url], probe_interval_s=0.05,
                        failure_threshold=2, breaker_open_s=0.1).start()
    try:
        assert router.wait_ready(2, timeout=WAIT)
        status, added, _ = router.mutate("/v1/docs",
                                         {"vectors": vecs.tolist()})
        assert status == 200, added
        served_by = set()
        for i in range(8):
            s, payload, by = router.search({
                "query": vecs[i % 4].tolist(), "k": 1,
                "min_seq": added["seq"], "deadline_ms": 10_000})
            assert s == 200, payload
            assert payload["ids"][0] == added["ids"][i % 4]
            served_by.add(by)
        assert len(served_by) == 2              # both replicas took reads

        fh.stop()                               # kill the follower
        for i in range(6):
            s, _, by = router.search({
                "query": vecs[i % 4].tolist(), "k": 1,
                "deadline_ms": 10_000})
            assert s == 200                     # zero client-visible errors
            assert by == ph.url
        f_ep = next(ep for ep in router.replicas if ep.url == fh.url)
        wait_until(lambda: not f_ep.alive, msg="probe notices the kill")
    finally:
        router.stop()


class TestReplicatedHTTP:
    def test_min_seq_read_your_writes_and_read_only(self, replicated):
        ph, fh, prim, foll, applier = replicated
        vecs = RNG.normal(size=(4, D)).astype(np.float32)
        status, added = http_call(ph.url, "/v1/docs",
                                  {"vectors": vecs.tolist()}, timeout=WAIT)
        assert status == 200 and added["seq"] is not None
        status, got = http_call(fh.url, "/v1/search", {
            "query": vecs[2].tolist(), "k": 1, "min_seq": added["seq"],
            "deadline_ms": 10_000}, timeout=WAIT)
        assert status == 200
        assert got["ids"][0] == added["ids"][2]

        # followers refuse mutations outright
        status, payload = http_call(fh.url, "/v1/docs",
                                    {"vectors": vecs[:1].tolist()},
                                    timeout=WAIT)
        assert status == 403
        status, payload = http_call(fh.url, "/v1/docs/delete",
                                    {"ids": [0]}, timeout=WAIT)
        assert status == 403

    def test_health_reports_replication(self, replicated):
        ph, fh, *_ = replicated
        _, h = http_call(fh.url, "/healthz", timeout=WAIT)
        assert h["role"] == "follower" and h["ready"]
        _, deep = http_call(fh.url, "/healthz?deep=1", timeout=WAIT)
        assert deep["deep"]["replication"]["bootstrapped"]
        _, h = http_call(ph.url, "/healthz", timeout=WAIT)
        assert h["role"] == "primary"

    def test_readiness_503_until_bootstrapped(self, tmp_path):
        state = str(tmp_path / "state")
        prim = make_primary(state, n_docs=2)
        prim.wal.close()
        foll = fresh_engine()
        applier = ReplicaApplier(foll, state)   # NOT bootstrapped
        with EngineDriver(foll, max_wait_ms=1.0) as drv:
            handle = serve_in_thread(foll, drv, require_tenant=False,
                                     replication=applier, read_only=True)
            try:
                status, _ = http_call(handle.url, "/healthz", timeout=WAIT)
                assert status == 200            # alive
                status, _ = http_call(handle.url, "/healthz?ready=1",
                                      timeout=WAIT)
                assert status == 503            # but not ready
                applier.bootstrap()
                applier.catch_up()
                status, _ = http_call(handle.url, "/healthz?ready=1",
                                      timeout=WAIT)
                assert status == 200
            finally:
                handle.stop()

    def test_router_spreads_and_fails_over(self, replicated):
        ph, fh, *_ = replicated
        router_spreads_and_fails_over(ReplicaRouter, ph, fh)

    def test_retry_skips_the_replica_that_failed(self, replicated):
        """A search's retry goes to a replica the call has not tried, even
        when other clients' calls move the round-robin between its
        attempts (the router's rotation alone would hand it the dead
        follower three times; found at 8 client threads on the card)."""
        ph, fh, *_ = replicated
        fh.stop()
        router = ReplicaRouter([fh.url, ph.url], failure_threshold=10)
        for ep in router.replicas:             # no probe has seen the kill
            ep.alive = ep.ready = True
        real = router._attempt

        def attempt(*args, **kwargs):
            out = real(*args, **kwargs)
            with router._lock:                 # another client's call
                router._rr += 1
            return out

        router._attempt = attempt
        try:
            for _ in range(4):
                s, payload, by = router.search(
                    {"query": [0.0] * D, "k": 1, "deadline_ms": 10_000})
                assert s == 200 and by == ph.url, payload
        finally:
            router.stop()

    def test_router_hedge_delay_knobs(self):
        router = ReplicaRouter(["http://127.0.0.1:1"], hedge_ms=25.0)
        assert router._hedge_delay_s() == pytest.approx(0.025)
        adaptive = ReplicaRouter(["http://127.0.0.1:1"], hedge_ms=0.0)
        assert adaptive._hedge_delay_s() is None     # needs p95 samples
        for ms in [10.0] * 20:
            adaptive._latencies.append(ms)
        assert adaptive._hedge_delay_s() == pytest.approx(0.010, abs=5e-3)
        off = ReplicaRouter(["http://127.0.0.1:1"], hedge_ms=None)
        assert off._hedge_delay_s() is None


# ---------------------------------------------------------------------------
# across packages, over the wire
# ---------------------------------------------------------------------------
def raw(url, method, path, body=None, *, data=None, length=None):
    """One request through http.client: (status, payload, headers).  ``data``
    sends raw bytes instead of a JSON body; ``length`` sends only a header
    announcing a body of that many bytes (the server must refuse it
    unread)."""
    host, port = url.removeprefix("http://").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=WAIT)
    try:
        if length is not None:
            conn.putrequest(method, path)
            conn.putheader("Content-Length", str(length))
            conn.endheaders()
        else:
            if data is None and body is not None:
                data = json.dumps(body).encode()
            conn.request(method, path, data,
                         {"Content-Type": "application/json"} if data
                         else {})
        resp = conn.getresponse()
        text = resp.read()
        headers = {k.lower(): v for k, v in resp.getheaders()}
        if headers.get("content-type", "").startswith("application/json"):
            payload = json.loads(text)
        else:
            payload = text.decode()
        return resp.status, payload, headers
    finally:
        conn.close()


def key_tree(obj):
    """The nested key sets of a JSON object (values dropped)."""
    if isinstance(obj, dict):
        return {k: key_tree(v) for k, v in obj.items()}
    return None


def metric_families(text):
    return {line.split()[2] for line in text.splitlines()
            if line.startswith("# TYPE ")}


MAX_BODY = 64 << 10
QUOTA = dict(max_inflight=64, overrides={"capped": {"max_docs": 3},
                                         "throttled": {"max_inflight": 1}})
HEADERS = ("retry-after", "degraded", "cache", "content-type")


class _Side:
    """One package's engine + driver + server over a durable state dir."""

    def __init__(self, package, state_dir):
        import repro.engine as JE
        import repro.serve as JS
        import repro_torch.engine as TE
        import repro_torch.serve as TS

        E, S = (JE, JS) if package == "repro" else (TE, TS)
        kw = dict(d_start=8, k0=16, final_k=4, buckets=(1, 2, 4),
                  capacity=64, block_n=64,
                  adaptive=E.AdaptiveConfig(enabled=True, levels=2,
                                            min_d_start=4),
                  cache=E.CacheConfig(enabled=True, capacity=32))
        if package != "repro":
            kw["device"] = "cpu"
        self.engine = E.RetrievalEngine(32, **kw)
        self.engine.enable_durability(state_dir)
        self.driver = E.EngineDriver(self.engine, max_wait_ms=1.0).start()
        self.quotas = S.TenantQuotas(**QUOTA)
        self.handle = S.serve_in_thread(self.engine, self.driver,
                                        quotas=self.quotas,
                                        max_body=MAX_BODY)
        self.url = self.handle.url

    def close(self):
        self.handle.stop()
        self.driver.stop()
        self.engine.wal.close()


def request_script(rng):
    """(name, method, path, body) in the order both servers get them; a
    body is JSON, raw bytes, or an int (a Content-Length past the limit);
    seeded, so both get the same bytes."""
    d = 32
    a = rng.normal(size=(12, d)).astype(np.float32)
    b = rng.normal(size=(12, d)).astype(np.float32)
    meta = [{"shard": j % 2, "lang": "en" if j % 3 else "de"}
            for j in range(12)]
    q = a[[0, 3, 7]] + 0.1 * rng.normal(size=(3, d)).astype(np.float32)
    steps = [
        ("health", "GET", "/healthz", None),
        ("add_a", "POST", "/v1/docs", {"vectors": a.tolist(), "tenant": "a",
                                       "metadata": meta}),
        ("add_b", "POST", "/v1/docs", {"vectors": b.tolist(), "tenant": "b"}),
        ("add_capped", "POST", "/v1/docs",
         {"vectors": b[:3].tolist(), "tenant": "capped"}),
        ("add_over_cap_429", "POST", "/v1/docs",
         {"vectors": b[:1].tolist(), "tenant": "capped"}),
        ("add_throttled", "POST", "/v1/docs",
         {"vectors": b[3:5].tolist(), "tenant": "throttled"}),
        ("add_no_tenant_400", "POST", "/v1/docs", {"vectors": [[0.0] * d]}),
        ("add_bad_meta_400", "POST", "/v1/docs",
         {"vectors": [[0.0] * d], "tenant": "a", "metadata": {"x": [1]}}),
        ("add_bad_shape_400", "POST", "/v1/docs",
         {"vectors": [[[0.0] * d]], "tenant": "a"}),
        ("add_wrong_dim_400", "POST", "/v1/docs",
         {"vectors": [[0.0] * (d + 1)], "tenant": "a"}),
        ("add_too_large_413", "POST", "/v1/docs", MAX_BODY + 1),
    ]
    for i in range(3):
        steps.append((f"search_a{i}", "POST", "/v1/search",
                      {"query": q[i].tolist(), "tenant": "a", "k": 3}))
    steps += [
        ("search_a0_again", "POST", "/v1/search",     # a query-cache hit
         {"query": q[0].tolist(), "tenant": "a", "k": 3}),
        ("search_b_default_k", "POST", "/v1/search",
         {"query": q[1].tolist(), "tenant": "b"}),
        ("search_filter", "POST", "/v1/search",
         {"query": q[2].tolist(), "tenant": "a", "k": 4,
          "filter": {"shard": {"$eq": 1}, "lang": {"$in": ["en"]}}}),
        ("search_bad_filter_400", "POST", "/v1/search",
         {"query": q[0].tolist(), "tenant": "a",
          "filter": {"x": {"$regex": "a.*"}}}),
        ("search_big_k_400", "POST", "/v1/search",
         {"query": q[0].tolist(), "tenant": "a", "k": 99}),
        ("search_zero_k_400", "POST", "/v1/search",
         {"query": q[0].tolist(), "tenant": "a", "k": 0}),
        ("search_wrong_dim_400", "POST", "/v1/search",
         {"query": [0.0] * (d + 1), "tenant": "a"}),
        ("search_no_tenant_400", "POST", "/v1/search", {"query": [0.0] * d}),
        ("search_no_query_400", "POST", "/v1/search", {"tenant": "a"}),
        ("search_bad_tenant_400", "POST", "/v1/search",
         {"query": [0.0] * d, "tenant": 7}),
        ("search_malformed_400", "POST", "/v1/search", b"{oops"),
        ("search_non_object_400", "POST", "/v1/search", [1, 2, 3]),
        ("search_deadline_504", "POST", "/v1/search",
         {"query": q[1].tolist(), "tenant": "a", "deadline_ms": 1e-4}),
        ("search_min_seq_503", "POST", "/v1/search",
         {"query": q[1].tolist(), "tenant": "a", "min_seq": 0}),
        ("search_unknown_tenant", "POST", "/v1/search",
         {"query": q[1].tolist(), "tenant": "nobody"}),
        ("get_on_post_405", "GET", "/v1/search", None),
        ("unknown_path_404", "GET", "/v2/nope", None),
        ("delete_own", "POST", "/v1/docs/delete", {"ids": [0, 3],
                                                   "tenant": "a"}),
        ("delete_cross_tenant_403", "POST", "/v1/docs/delete",
         {"ids": [12], "tenant": "a"}),
        ("delete_out_of_range_400", "POST", "/v1/docs/delete",
         {"ids": [10 ** 9], "tenant": "a"}),
        ("delete_no_ids_400", "POST", "/v1/docs/delete", {"tenant": "a"}),
        ("search_after_delete", "POST", "/v1/search",
         {"query": q[1].tolist(), "tenant": "a", "k": 4}),
        ("stats", "GET", "/v1/stats", None),
        ("traces", "GET", "/v1/traces", None),
    ]
    return steps


def run_step(side, step):
    name, method, path, body = step
    if isinstance(body, int):
        return raw(side.url, method, path, length=body)
    if isinstance(body, bytes):
        return raw(side.url, method, path, data=body)
    return raw(side.url, method, path, body)


def assert_same_response(name, got, want):
    (gs, gp, gh), (ws, wp, wh) = got, want
    assert gs == ws, (name, gs, gp, ws, wp)
    for h in HEADERS:
        assert gh.get(h) == wh.get(h), (name, h, gh.get(h), wh.get(h))
    if not isinstance(wp, dict):
        return
    assert set(gp) == set(wp), (name, sorted(gp), sorted(wp))
    if gs != 200:
        for key in ("tenant", "limit", "isolated"):
            assert gp.get(key) == wp.get(key), (name, key)
    if "scores" in wp:
        assert gp["ids"] == wp["ids"], (name, gp["ids"], wp["ids"])
        np.testing.assert_allclose(gp["scores"], wp["scores"],
                                   rtol=RTOL, atol=ATOL, err_msg=name)
        assert key_tree(gp["spans"]) == key_tree(wp["spans"])
        for key in ("cached", "degraded_level"):
            assert gp[key] == wp[key], (name, key)
    elif "ids" in wp or "n_deleted" in wp:
        for key in ("ids", "n_added", "n_deleted", "seq"):
            assert gp.get(key) == wp.get(key), (name, key)


@pytest.fixture()
def two_servers(tmp_path):
    sides = {}
    try:
        for package in ("repro", "repro_torch"):
            sides[package] = _Side(package, str(tmp_path / package))
        yield sides["repro_torch"], sides["repro"]
    finally:
        for side in sides.values():
            side.close()


class TestAcrossPackagesHTTP:
    def test_same_requests_same_responses(self, two_servers):
        port, ref = two_servers
        steps = request_script(np.random.default_rng(5))
        seen = set()
        for step in steps:
            got, want = run_step(port, step), run_step(ref, step)
            assert_same_response(step[0], got, want)
            seen.add(got[0])
        # the in-flight cap: one slot held from outside, the next search
        # of that tenant is refused up front on both
        for side in (port, ref):
            side.quotas.acquire("throttled")
        body = {"query": [0.1] * 32, "tenant": "throttled"}
        try:
            got = raw(port.url, "POST", "/v1/search", body)
            want = raw(ref.url, "POST", "/v1/search", body)
        finally:
            for side in (port, ref):
                side.quotas.release("throttled")
        assert_same_response("search_inflight_429", got, want)
        seen.add(got[0])

        _, p_stats, _ = raw(port.url, "GET", "/v1/stats")
        _, r_stats, _ = raw(ref.url, "GET", "/v1/stats")
        assert key_tree(p_stats) == key_tree(r_stats)
        assert p_stats["tenants"] == r_stats["tenants"]
        assert p_stats["store"] == r_stats["store"]
        assert p_stats["config"] == r_stats["config"]
        _, p_deep, _ = raw(port.url, "GET", "/healthz?deep=1")
        _, r_deep, _ = raw(ref.url, "GET", "/healthz?deep=1")
        assert key_tree(p_deep) == key_tree(r_deep)
        assert p_deep["deep"]["wal"]["last_seq"] \
            == r_deep["deep"]["wal"]["last_seq"]
        _, p_text, _ = raw(port.url, "GET", "/metrics")
        _, r_text, _ = raw(ref.url, "GET", "/metrics")
        assert metric_families(p_text) == metric_families(r_text)
        assert {"repro_http_requests_total", "repro_http_request_ms",
                "repro_quota_rejections_total"} <= metric_families(p_text)

        # a stopped driver: 503 on both, no slot leaked
        for side in (port, ref):
            side.driver.stop(drain=True)
        body = {"query": [0.1] * 32, "tenant": "a"}
        got = raw(port.url, "POST", "/v1/search", body)
        want = raw(ref.url, "POST", "/v1/search", body)
        assert_same_response("search_driver_stopped_503", got, want)
        _, h_port, _ = raw(port.url, "GET", "/healthz")
        _, h_ref, _ = raw(ref.url, "GET", "/healthz")
        assert h_port == h_ref
        seen.add(got[0])
        assert port.quotas.inflight("a") == 0
        assert {200, 400, 403, 404, 405, 413, 429, 503, 504} <= seen

    def test_port_router_over_repro_primary_and_port_follower(self,
                                                              tmp_path):
        import repro.engine as JE
        import repro.serve as JS

        state = str(tmp_path / "state")
        prim = JE.RetrievalEngine(D, **KW)
        prim.enable_durability(state)
        foll = fresh_engine()
        applier = ReplicaApplier(foll, state, poll_s=0.01)
        applier.bootstrap()
        applier.start()
        with JE.EngineDriver(prim, max_wait_ms=1.0) as pdrv, \
                EngineDriver(foll, max_wait_ms=1.0) as fdrv:
            ph = JS.serve_in_thread(prim, pdrv, require_tenant=False,
                                    replication=JE.PrimaryReplication(prim))
            fh = serve_in_thread(foll, fdrv, require_tenant=False,
                                 replication=applier, read_only=True)
            try:
                status, _ = http_call(fh.url, "/v1/docs",
                                      {"vectors": [[0.0] * D]}, timeout=WAIT)
                assert status == 403
                _, h = http_call(ph.url, "/healthz", timeout=WAIT)
                assert h["role"] == "primary"
                router_spreads_and_fails_over(ReplicaRouter, ph, fh)
                assert applier.applied_seq == prim.wal.last_seq
            finally:
                fh.stop()
                ph.stop()
                applier.stop()
                prim.wal.close()

    def test_repro_router_over_port_replicas(self, replicated):
        import repro.serve as JS

        ph, fh, prim, foll, applier = replicated
        router_spreads_and_fails_over(JS.ReplicaRouter, ph, fh)
        assert applier.applied_seq == prim.wal.last_seq

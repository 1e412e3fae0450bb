"""The port's HTTP serving front-end over a live socket, mirrored from the
JAX package's ``tests/test_serve.py`` class for class — routing, status
mapping, tenancy enforcement, metadata filters, quotas, deadlines and the
stats surface — plus ``tests/test_faults.py::TestDeepHealth``, and the
launcher's server, client and router modes run as subprocesses.

Engines run on ``device="cpu"`` (the plain search path); the server code
is the same on the card.  Every request carries a timeout, so a broken
path fails the test instead of hanging the suite.
"""

import http.client
import json
import os
import pathlib
import queue
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# one intra-op thread: the suite runs several workers side by side
torch.set_num_threads(1)

from repro_torch.engine import EngineDriver, RetrievalEngine, Supervisor
from repro_torch.serve import QuotaExceeded, TenantQuotas, serve_in_thread

D = 32
RNG = np.random.default_rng(21)


def request(url, path, body=None, method=None):
    """One JSON round trip; returns (status, payload)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url + path, data=data,
        method=method or ("POST" if body is not None else "GET"))
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def served():
    """One engine + driver + HTTP server shared by the module; tests keep
    to their own tenant namespaces so they don't interfere."""
    eng = RetrievalEngine(D, d_start=8, k0=16, final_k=4, buckets=(1, 2, 4),
                          capacity=64, block_n=64, device="cpu")
    quotas = TenantQuotas(
        max_inflight=64,
        overrides={"throttled": {"max_inflight": 1},
                   "capped": {"max_docs": 3}})
    with EngineDriver(eng, max_wait_ms=1.0) as driver:
        handle = serve_in_thread(eng, driver, quotas=quotas)
        try:
            yield handle.url, eng, quotas
        finally:
            handle.stop()


def seed(url, tenant, n=12, metadata=None):
    vecs = RNG.normal(size=(n, D)).astype(np.float32)
    status, payload = request(url, "/v1/docs", {
        "vectors": vecs.tolist(), "tenant": tenant, "metadata": metadata})
    assert status == 200, payload
    return vecs, payload["ids"]


class TestRouting:
    def test_health(self, served):
        url, _, _ = served
        status, payload = request(url, "/healthz")
        assert status == 200 and payload["status"] == "ok"

    def test_unknown_path_404(self, served):
        url, _, _ = served
        status, _ = request(url, "/v2/nope")
        assert status == 404

    def test_wrong_method_405(self, served):
        url, _, _ = served
        status, _ = request(url, "/v1/search")          # GET on a POST route
        assert status == 405

    def test_malformed_json_400(self, served):
        url, _, _ = served
        req = urllib.request.Request(url + "/v1/search", data=b"{oops",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=10)
        assert e.value.code == 400

    def test_non_object_body_400(self, served):
        url, _, _ = served
        status, _ = request(url, "/v1/search", body=[1, 2, 3])
        assert status == 400

    def test_keep_alive_two_requests_one_connection(self, served):
        url, _, _ = served
        host, port = url.removeprefix("http://").split(":")
        conn = http.client.HTTPConnection(host, int(port), timeout=30)
        try:
            for _ in range(2):
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                assert resp.status == 200
                resp.read()
        finally:
            conn.close()


class TestSearch:
    def test_self_retrieval_with_per_request_k(self, served):
        url, _, _ = served
        vecs, ids = seed(url, "srch")
        status, payload = request(url, "/v1/search", {
            "query": vecs[3].tolist(), "tenant": "srch", "k": 2})
        assert status == 200, payload
        assert payload["ids"][0] == ids[3]
        assert len(payload["ids"]) <= 2
        assert len(payload["scores"]) == len(payload["ids"])

    def test_tenant_required_400(self, served):
        url, _, _ = served
        status, payload = request(url, "/v1/search", {
            "query": [0.0] * D})
        assert status == 400 and "tenant" in payload["error"]

    def test_tenant_isolation_over_http(self, served):
        url, _, _ = served
        vecs_a, ids_a = seed(url, "iso-a")
        _, ids_b = seed(url, "iso-b")
        status, payload = request(url, "/v1/search", {
            "query": vecs_a[0].tolist(), "tenant": "iso-b"})
        assert status == 200
        assert not set(payload["ids"]) & set(ids_a)
        assert set(payload["ids"]) <= set(ids_b)

    def test_metadata_filter(self, served):
        url, eng, _ = served
        meta = [{"shard": j % 2} for j in range(12)]
        vecs, ids = seed(url, "filt", metadata=meta)
        status, payload = request(url, "/v1/search", {
            "query": vecs[0].tolist(), "tenant": "filt",
            "filter": {"shard": {"$eq": 1}}})
        assert status == 200 and payload["ids"]
        for i in payload["ids"]:
            assert eng.store.metadata_of(i) == {"shard": 1}

    def test_bad_filter_400(self, served):
        url, _, _ = served
        seed(url, "badf", n=2)
        status, payload = request(url, "/v1/search", {
            "query": [0.0] * D, "tenant": "badf",
            "filter": {"x": {"$regex": "a.*"}}})
        assert status == 400 and "$regex" in payload["error"]

    def test_oversized_k_400(self, served):
        url, _, _ = served
        seed(url, "bigk", n=2)
        status, _ = request(url, "/v1/search", {
            "query": [0.0] * D, "tenant": "bigk", "k": 99})
        assert status == 400

    def test_wrong_dim_400(self, served):
        url, _, _ = served
        status, _ = request(url, "/v1/search", {
            "query": [0.0] * (D + 1), "tenant": "dim"})
        assert status == 400

    def test_expired_deadline_504(self, served):
        url, _, _ = served
        vecs, _ = seed(url, "dead", n=2)
        status, payload = request(url, "/v1/search", {
            "query": vecs[0].tolist(), "tenant": "dead",
            "deadline_ms": 1e-4})
        assert status == 504, payload


class TestDocs:
    def test_add_returns_ids(self, served):
        url, eng, _ = served
        _, ids = seed(url, "add", n=3)
        assert len(ids) == 3
        assert all(eng.store.tenant_of(i) == "add" for i in ids)

    def test_add_without_tenant_400(self, served):
        url, _, _ = served
        status, _ = request(url, "/v1/docs", {"vectors": [[0.0] * D]})
        assert status == 400

    def test_bad_metadata_400(self, served):
        url, _, _ = served
        status, _ = request(url, "/v1/docs", {
            "vectors": [[0.0] * D], "tenant": "badm",
            "metadata": {"blob": [1, 2]}})        # list value: not a scalar
        assert status == 400

    def test_delete_own_docs(self, served):
        url, _, _ = served
        vecs, ids = seed(url, "del", n=4)
        status, payload = request(url, "/v1/docs/delete", {
            "ids": ids[:2], "tenant": "del"})
        assert status == 200 and payload["n_deleted"] == 2
        status, payload = request(url, "/v1/search", {
            "query": vecs[0].tolist(), "tenant": "del"})
        assert status == 200
        assert not set(payload["ids"]) & set(ids[:2])

    def test_cross_tenant_delete_403(self, served):
        url, _, _ = served
        _, ids = seed(url, "owner", n=2)
        status, payload = request(url, "/v1/docs/delete", {
            "ids": [ids[0]], "tenant": "thief"})
        assert status == 403, payload

    def test_out_of_range_delete_400(self, served):
        url, _, _ = served
        status, _ = request(url, "/v1/docs/delete", {
            "ids": [10 ** 9], "tenant": "del"})
        assert status == 400


class TestQuotas:
    def test_doc_cap_429(self, served):
        url, _, _ = served
        seed(url, "capped", n=3)                  # cap is exactly 3
        status, payload = request(url, "/v1/docs", {
            "vectors": [[0.0] * D], "tenant": "capped"})
        assert status == 429 and payload["limit"] == "docs"

    def test_inflight_cap_429_and_release(self, served):
        url, _, quotas = served
        vecs, _ = seed(url, "throttled", n=2)
        # hold the single slot from outside: the next HTTP search must be
        # rejected up front, not queued behind it
        quotas.acquire("throttled")
        try:
            status, payload = request(url, "/v1/search", {
                "query": vecs[0].tolist(), "tenant": "throttled"})
            assert status == 429 and payload["limit"] == "inflight"
        finally:
            quotas.release("throttled")
        status, _ = request(url, "/v1/search", {
            "query": vecs[0].tolist(), "tenant": "throttled"})
        assert status == 200                      # slot freed -> serves again

    def test_quota_object_contract(self):
        q = TenantQuotas(max_inflight=1)
        q.acquire("t")
        with pytest.raises(QuotaExceeded):
            q.acquire("t")
        q.release("t")
        q.acquire("t")                            # released slot reusable
        q.release("t")
        with pytest.raises(RuntimeError):
            q.release("t")                        # unbalanced release
        q.acquire(None)                           # tenantless: never limited
        q.check_docs("t", current=0, adding=10)   # max_docs=None: unlimited
        with pytest.raises(QuotaExceeded):
            TenantQuotas(max_docs=5).check_docs("t", current=4, adding=2)


class TestStats:
    def test_stats_surface(self, served):
        url, _, _ = served
        vecs, _ = seed(url, "stats", n=2)
        request(url, "/v1/search", {"query": vecs[0].tolist(),
                                    "tenant": "stats"})
        status, payload = request(url, "/v1/stats")
        assert status == 200
        assert payload["engine"]["n_completed"] >= 1
        assert payload["driver"]["n_submitted"] >= 1
        assert payload["tenants"]["stats"] == 2
        assert payload["quotas"]["max_inflight"] == 64
        assert payload["config"]["d_emb"] == D
        assert payload["config"]["backend"]["backend"] == "flat"
        assert payload["store"]["n_active"] >= 2


class TestConcurrency:
    def test_mixed_tenant_concurrent_searches(self, served):
        """Many tenants racing over one socket pool: every response is 200
        and scoped to its own namespace (mask-key batching under load)."""
        url, eng, _ = served
        tenants = [f"conc-{i}" for i in range(3)]
        seeded = {t: seed(url, t, n=6) for t in tenants}
        errors = []

        def worker(t):
            vecs, ids = seeded[t]
            try:
                for j in range(6):
                    status, payload = request(url, "/v1/search", {
                        "query": vecs[j % 6].tolist(), "tenant": t})
                    assert status == 200, payload
                    assert set(payload["ids"]) <= set(ids), (t, payload)
            except Exception as e:                # surfaced after join
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(t,), daemon=True)
                   for t in tenants for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive(), "worker hung"
        assert not errors, errors[:3]


class TestLifecycle:
    def test_stop_is_idempotent_and_socket_closes(self):
        eng = RetrievalEngine(D, d_start=8, k0=16, buckets=(1,),
                              capacity=16, block_n=32,
                              device="cpu")
        with EngineDriver(eng, max_wait_ms=0.0) as driver:
            handle = serve_in_thread(eng, driver)
            url = handle.url
            status, _ = request(url, "/healthz")
            assert status == 200
            handle.stop()
            handle.stop()                         # second stop: no-op
            with pytest.raises((ConnectionError, urllib.error.URLError)):
                urllib.request.urlopen(url + "/healthz", timeout=2)


class TestQuotaLifecycle:
    """Regression: no path between ``quotas.acquire`` and future delivery
    may leak an in-flight slot — invalid requests, rejected submits, and
    stopped drivers all release exactly once."""

    def test_invalid_request_hammer_never_leaks_inflight(self, served):
        url, _, quotas = served
        vecs, _ = seed(url, "leak", n=4)
        good = vecs[0].tolist()
        bad_bodies = [
            {"tenant": "leak"},                               # missing query
            {"query": [0.0] * (D + 1), "tenant": "leak"},     # bad dim
            {"query": good, "tenant": "leak", "k": 0},        # bad k
            {"query": good, "tenant": "leak", "k": 999},      # k too large
            {"query": good, "tenant": "leak",
             "filter": {"tag": {"$bogus": 1}}},               # bad filter op
            {"query": "not-a-vector", "tenant": "leak"},      # unparseable
            {"query": [[1.0], [2.0, 3.0]], "tenant": "leak"}, # ragged
        ]
        for _ in range(5):
            for body in bad_bodies:
                status, payload = request(url, "/v1/search", body)
                assert status != 200, (body, payload)
                assert quotas.inflight("leak") == 0, body
        assert quotas.inflight("leak") == 0
        # the namespace still serves fine afterwards, and returns its slot
        status, _ = request(url, "/v1/search",
                            {"query": good, "tenant": "leak"})
        assert status == 200
        assert quotas.inflight("leak") == 0

    def test_stopped_driver_rejects_without_leaking(self):
        eng = RetrievalEngine(D, d_start=8, k0=16, buckets=(1,),
                              capacity=16, block_n=32,
                              device="cpu")
        quotas = TenantQuotas(max_inflight=4)
        driver = EngineDriver(eng, max_wait_ms=0.0).start()
        handle = serve_in_thread(eng, driver, quotas=quotas)
        try:
            vecs, _ = seed(handle.url, "dead", n=2)
            driver.stop(drain=True)               # submit now raises
            for _ in range(4):
                status, _ = request(handle.url, "/v1/search", {
                    "query": vecs[0].tolist(), "tenant": "dead"})
                assert status == 503
            assert quotas.inflight("dead") == 0
        finally:
            handle.stop()
            driver.stop()


def raw_search(url, body):
    """Search via http.client so response headers are observable."""
    host, port = url.removeprefix("http://").split(":")
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("POST", "/v1/search", json.dumps(body).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        payload = json.loads(resp.read())
        headers = {k.lower(): v for k, v in resp.getheaders()}
        return resp.status, payload, headers
    finally:
        conn.close()


@pytest.fixture(scope="module")
def served_adaptive():
    """Server with the adaptive policy and query cache enabled."""
    from repro_torch.engine import AdaptiveConfig, CacheConfig
    eng = RetrievalEngine(
        D, d_start=8, k0=16, final_k=4, buckets=(1, 2, 4),
        capacity=64, block_n=64,
        adaptive=AdaptiveConfig(enabled=True, levels=2, min_d_start=4),
        cache=CacheConfig(enabled=True, capacity=32), device="cpu")
    with EngineDriver(eng, max_wait_ms=1.0) as driver:
        handle = serve_in_thread(eng, driver)
        try:
            yield handle.url, eng, driver
        finally:
            handle.stop()


class TestAdaptiveSurface:
    def test_degraded_and_cache_headers(self, served_adaptive):
        url, _, _ = served_adaptive
        vecs, _ = seed(url, "hdr", n=6)
        body = {"query": vecs[2].tolist(), "tenant": "hdr"}
        status, payload, headers = raw_search(url, body)
        assert status == 200, payload
        assert headers["degraded"] == "0"
        assert headers["cache"] == "miss"
        assert payload["cached"] is False and payload["degraded_level"] == 0
        status, payload, headers = raw_search(url, body)
        assert status == 200
        assert headers["cache"] == "hit"
        assert payload["cached"] is True

    def test_stats_expose_adaptive_cache_and_mask_cache(self, served_adaptive):
        url, _, _ = served_adaptive
        status, payload = request(url, "/v1/stats")
        assert status == 200
        assert payload["adaptive"]["enabled"] is True
        assert payload["adaptive"]["level"] == 0
        assert payload["cache"]["enabled"] is True
        assert payload["cache"]["capacity"] == 32
        assert set(payload["mask_cache"]) == {"hits", "misses", "entries",
                                              "epoch"}

    def test_plain_server_reports_sections_disabled(self, served):
        url, _, _ = served
        status, payload = request(url, "/v1/stats")
        assert status == 200
        assert payload["adaptive"] == {"enabled": False}
        assert payload["cache"] == {"enabled": False}
        assert "mask_cache" in payload


# ---------------------------------------------------------------------------
# deep health over HTTP (mirrors tests/test_faults.py::TestDeepHealth)
# ---------------------------------------------------------------------------
class TestDeepHealth:
    def test_deep_healthz_reports_ft_state(self, tmp_path):
        eng = RetrievalEngine(16, d_start=4, k0=8, buckets=(1, 2, 4),
                              capacity=64, block_n=32, device="cpu")
        eng.enable_durability(str(tmp_path))
        eng.add_docs(RNG.normal(size=(8, 16)).astype(np.float32))
        driver = EngineDriver(eng, max_wait_ms=1.0)
        driver.start(supervised=True)
        sup = Supervisor(driver).start()
        try:
            with serve_in_thread(eng, driver,
                                 require_tenant=False) as handle:
                with urllib.request.urlopen(
                        handle.url + "/healthz?deep=1", timeout=30) as r:
                    payload = json.loads(r.read())
                with urllib.request.urlopen(
                        handle.url + "/healthz", timeout=30) as r:
                    shallow = json.loads(r.read())
        finally:
            sup.stop()
            driver.stop()
            eng.wal.close()
        assert "deep" not in shallow
        deep = payload["deep"]
        assert deep["driver"]["state"] == "running"
        assert deep["driver"]["heartbeat_age_s"] >= 0.0
        assert deep["supervisor"]["attached"]
        assert deep["wal"]["last_seq"] == 0       # the one add above
        assert deep["last_recovery"] is None
        assert deep["n_quarantined"] == 0


# ---------------------------------------------------------------------------
# the launcher's network modes, as subprocesses on the CPU
# ---------------------------------------------------------------------------
SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
LAUNCH = [sys.executable, "-u", "-m", "repro_torch.launch.serve"]
CLI_TIMEOUT = 60


def _launcher_env():
    return dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")


def _launch(args):
    """Start the launcher with ``args``: (process, queue of its output
    lines, filled by a reader thread so no read can block the test)."""
    proc = subprocess.Popen(LAUNCH + args, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            env=_launcher_env())
    lines = queue.Queue()
    threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout],
                     daemon=True).start()
    return proc, lines


def _url_from(lines, prefix, seen):
    """The URL on the first output line that starts with ``prefix``."""
    while True:
        line = lines.get(timeout=CLI_TIMEOUT)
        seen.append(line)
        if line.startswith(prefix):
            return line.split()[3]


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=CLI_TIMEOUT)


class TestLauncher:
    def test_server_client_and_sigterm(self):
        server, lines = _launch(
            ["--serve-http", "--device", "cpu", "--port", "0",
             "--allow-anonymous", "--d-emb", "32", "--docs", "0"])
        seen = []
        try:
            url = _url_from(lines, "[http]   serving on ", seen)
            client = subprocess.run(
                LAUNCH + ["--connect", url, "--docs", "64", "--requests",
                          "32", "--clients", "4", "--device", "cpu",
                          "--d-emb", "32"],
                capture_output=True, text=True, timeout=CLI_TIMEOUT,
                env=_launcher_env())
            assert client.returncode == 0, client.stdout + client.stderr
            assert "[seed]   64 docs under 'bench'" in client.stdout
            assert "ok=32/32" in client.stdout, client.stdout
            server.send_signal(signal.SIGTERM)
            assert server.wait(timeout=CLI_TIMEOUT) == 0, seen
            while "[http]   shutting down\n" not in seen:
                seen.append(lines.get(timeout=CLI_TIMEOUT))
        finally:
            _stop(server)

    @pytest.mark.parametrize("role, message", [
        ("follower", "--role=follower needs --state-dir (the WAL-shipped "
                     "replication channel is the shared state dir)"),
        ("router", "--role=router needs --replicas URL[,URL...]"),
    ])
    def test_role_without_its_flag_exits(self, role, message):
        out = subprocess.run(
            LAUNCH + ["--serve-http", "--device", "cpu", "--role", role,
                      "--port", "0"],
            capture_output=True, text=True, timeout=CLI_TIMEOUT,
            env=_launcher_env())
        assert out.returncode == 1
        assert out.stderr.strip().splitlines()[-1] == message

    def test_router_mode_over_a_replica(self):
        eng = RetrievalEngine(D, d_start=8, k0=16, buckets=(1,),
                              capacity=16, block_n=32, device="cpu")
        with EngineDriver(eng, max_wait_ms=0.0) as driver:
            handle = serve_in_thread(eng, driver, require_tenant=False)
            router, lines = _launch(
                ["--serve-http", "--role", "router", "--port", "0",
                 "--replicas", handle.url, "--device", "cpu"])
            try:
                url = _url_from(lines, "[router] serving on ", [])
                vecs = RNG.normal(size=(3, D)).astype(np.float32)
                status, added = request(url, "/v1/docs",
                                        {"vectors": vecs.tolist()})
                assert status == 200 and added["n_added"] == 3
                status, got = request(url, "/v1/search",
                                      {"query": vecs[1].tolist(), "k": 1})
                assert status == 200 and got["ids"] == [added["ids"][1]]
                assert got["served_by"] == handle.url
                router.send_signal(signal.SIGTERM)
                assert router.wait(timeout=CLI_TIMEOUT) == 0
            finally:
                _stop(router)
                handle.stop()

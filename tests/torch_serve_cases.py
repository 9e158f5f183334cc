"""Shared cases of the serve, router and catalog parity tests
(tests/test_torch_serve.py, test_torch_router.py, test_torch_catalog.py):
both packages' modules side by side, a fixture that builds services,
listeners and routers of either package and closes them all at the end,
an HTTP client with bounded timeouts, and the comparison of two packages'
answers.

Tolerance: HTTP status codes, envelope keys, verdicts, integers and
strings are equal exactly; floats within nds_tpu/validate.py compare's
relative epsilon (EPS)."""

import functools
import json
import math
import threading
import urllib.error
import urllib.request
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pytest

from nds_tpu import faults as JF
from nds_tpu.analysis import budget as JB
from nds_tpu.engine.session import Session as JaxSession
from nds_tpu.lakehouse import catalog as JC
from nds_tpu.lakehouse import leases as JL
from nds_tpu.lakehouse import table as JT
from nds_tpu.obs import httpserv as JHS
from nds_tpu.obs import metrics as JM
from nds_tpu.obs import reader as JR
from nds_tpu.obs import trace as JTR
from nds_tpu.serve import router as JRT
from nds_tpu.serve import service as JSV
from nds_tpu_torch import faults as TF
from nds_tpu_torch.analysis import budget as TB
from nds_tpu_torch.engine.session import Session as TorchSession
from nds_tpu_torch.lakehouse import catalog as TC
from nds_tpu_torch.lakehouse import leases as TL
from nds_tpu_torch.lakehouse import table as TT
from nds_tpu_torch.obs import httpserv as THS
from nds_tpu_torch.obs import metrics as TM
from nds_tpu_torch.obs import reader as TR
from nds_tpu_torch.obs import trace as TTR
from nds_tpu_torch.serve import router as TRT
from nds_tpu_torch.serve import service as TSV

EPS = 1e-5  # nds_tpu/validate.py compare's relative epsilon

#: every client call's timeout, seconds
TIMEOUT_S = 30

JAX = SimpleNamespace(
    name="jax", faults=JF, B=JB, Session=JaxSession, C=JC, L=JL, T=JT,
    HS=JHS, M=JM, R=JR, TR=JTR, RT=JRT, SV=JSV, cli="nds_tpu.cli",
)
TORCH = SimpleNamespace(
    name="torch", faults=TF, B=TB,
    # the port's sessions run on the CPU here
    Session=functools.partial(TorchSession, device="cpu"),
    C=TC, L=TL, T=TT, HS=THS, M=TM, R=TR, TR=TTR, RT=TRT, SV=TSV,
    cli="nds_tpu_torch.cli",
)
#: the reference first, then the port
PKGS = (JAX, TORCH)

QUERY = "select k, count(*) c, sum(v) s from fact group by k order by k"
#: a float aggregate: its answers compare within EPS
FQUERY = ("select k, sum(f) sf, avg(f) af, min(f) mf from fact "
          "group by k order by k")
POINT = "select k, v from fact where v = 3 limit 1"


def fact_table(rows=64, seed=0):
    """k = row % 8, v = row, and f a seeded float column."""
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(np.arange(rows) % 8, type=pa.int64()),
        "v": pa.array(np.arange(rows), type=pa.int64()),
        "f": pa.array(np.round(rng.random(rows) * 100, 3),
                      type=pa.float64()),
    })


def mini_lake(P, tmp_path, rows=64, name="fact"):
    """A lakehouse table of fact_table rows, one per package."""
    path = str(tmp_path / P.name / name)
    P.T.LakehouseTable.create(path, fact_table(rows))
    return path


def wait_hang_fired(P, timeout=10.0):
    """Wait until every installed `hang:` fault rule has fired: a request
    held at `serve:exec` has been planned and has pinned its snapshot.
    A fixed sleep cannot promise that on a loaded host."""
    import time

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        reg = P.faults._registry
        if reg is not None and all(
                r.remaining <= 0 for r in reg.rules if r.kind == "hang"):
            return
        time.sleep(0.01)
    raise AssertionError(f"{P.name}: no hang fault fired in {timeout}s")


def reset(P):
    P.faults.reset()
    P.M.reset_shared()
    P.C.reset_clients()


def post(port, payload, tenant="default", path="/query", timeout=TIMEOUT_S,
         headers=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json",
                 "X-NDS-Tenant": tenant, **(headers or {})},
        method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode()), dict(r.headers)
    except urllib.error.HTTPError as e:
        try:
            body = json.loads(e.read().decode())
        except ValueError:
            body = {}
        return e.code, body, dict(e.headers)


def get(port, path, timeout=TIMEOUT_S):
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=timeout
        ) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def same_value(a, b):
    if isinstance(a, float) or isinstance(b, float):
        if a is None or b is None:
            return a is b
        if math.isnan(a) and math.isnan(b):
            return True
        return math.isclose(a, b, rel_tol=EPS)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(
            same_value(x, y) for x, y in zip(a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(
            same_value(a[k], b[k]) for k in a)
    return a == b


#: envelope fields whose values both packages must give alike (request
#: ids, elapsed times, retry-after jitter and replica addresses differ)
COMPARED = (
    "status", "verdict", "columns", "rows", "row_count", "total_rows",
    "truncated", "offset", "admitted_degraded", "retries", "query", "kind",
    "statement", "rows_affected", "version", "failure_kind", "tenant",
    "peak_bytes", "budget_bytes", "draining", "drained", "in_flight",
    "deduped", "state", "total", "completed", "failed", "reloaded",
    "leases_dropped", "leases_deferred", "undrained", "sessions", "rolled",
    "ok", "degraded", "published",
)


def assert_same_answer(ref, got, where=""):
    """Two (status, body, headers) answers of the two packages agree: the
    status code, the envelope's keys, and the COMPARED fields."""
    (s1, b1, h1), (s2, b2, h2) = ref, got
    assert s1 == s2, (where, s1, s2, b1, b2)
    assert sorted(b1) == sorted(b2), (where, sorted(b1), sorted(b2))
    for k in COMPARED:
        if k in b1:
            assert same_value(b1[k], b2[k]), (where, k, b1[k], b2[k])
    assert ("Retry-After" in h1) == ("Retry-After" in h2), where


def assert_same_answers(out):
    """out: {package name: [answer, ...]} for both packages."""
    ref, got = out["jax"], out["torch"]
    assert len(ref) == len(got)
    for i, (a, b) in enumerate(zip(ref, got)):
        assert_same_answer(a, b, where=i)


class Env:
    """Services, listeners and routers of either package, closed by the
    `env` fixture's finalizer: routers first (their prober stops), then
    services, then listeners (stopped in parallel)."""

    def __init__(self):
        self.services, self.servers, self.routers = [], [], []

    def _service(self, P, conf, templates, lake_path, job_dir, rows):
        """A QueryService over one session whose table `fact` is a
        lakehouse table at `lake_path`, else `rows` of fact_table."""
        session = P.Session(conf={"engine.metrics_port": 0, **(conf or {})})
        if lake_path is not None:
            session.register_lakehouse("fact", lake_path)
        else:
            session.register_arrow("fact", fact_table(rows))
        service = P.SV.QueryService(
            session, templates=templates, job_dir=job_dir)
        self.services.append(service)
        return service

    def service(self, P, conf=None, templates=None, lake_path=None,
                job_dir=None, rows=64):
        """A QueryService on the process-wide listener: (service, port,
        session)."""
        service = self._service(P, conf, templates, lake_path, job_dir,
                                rows)
        server = P.M.active_server()
        assert server is not None, "ephemeral listener failed to bind"
        server.attach_app(service)
        return service, server.port, service.session

    def replica(self, P, conf=None, lake_path=None, templates=None,
                rows=64):
        """A QueryService on a listener of its own (the process-wide one
        hosts one app): (service, port, server)."""
        service = self._service(P, conf, templates, lake_path, None, rows)
        srv = self.listener(P, service)
        return service, srv.port, srv

    def listener(self, P, app):
        srv = P.HS.MetricsServer(P.M.shared_sink(), 0, host="127.0.0.1")
        srv.attach_app(app)
        srv.start()
        self.servers.append(srv)
        return srv

    def router(self, P, ports, conf=None, mesh_port=None, trace_dir=None):
        rconf = {**RCONF, "engine.metrics_port": 0, **(conf or {})}
        if trace_dir:
            rconf["engine.trace_dir"] = str(trace_dir)
        tracer = P.TR.tracer_from_conf(rconf, app_id="nds-route")
        router = P.RT.QueryRouter(
            [f"127.0.0.1:{p}" for p in ports], conf=rconf, tracer=tracer,
            mesh_replica=f"127.0.0.1:{mesh_port}" if mesh_port else None,
        )
        self.routers.append(router)
        srv = self.listener(P, router)
        return router, srv.port

    def close(self):
        for r in self.routers:
            r.close()
        for s in self.services:
            try:
                s.close()
            except Exception:
                pass
        stops = [threading.Thread(target=_stop, args=(srv,), daemon=True)
                 for srv in self.servers]
        for t in stops:
            t.start()
        for t in stops:
            t.join(10)


def _stop(srv):
    try:
        srv.stop()
    except Exception:
        pass


#: fast, prober-less router settings for in-process fleets
RCONF = {
    "engine.route_health_interval_s": 0,
    "engine.route_backoff_base_s": 0.005,
    "engine.route_backoff_cap_s": 0.02,
}


@pytest.fixture
def env():
    for P in PKGS:
        reset(P)
    e = Env()
    yield e
    e.close()
    for P in PKGS:
        reset(P)

"""The port's tcp lakehouse catalog (nds_tpu_torch/lakehouse/catalog.py
`CatalogCoordinator` and `HttpCatalog`, cli/catalog.py) against the JAX
package's, through the coordinator and HTTP cases of tests/test_catalog.py:
the commit / lease / fence round trip over the wire, writer epochs released
for fencing, the publish deadline of a slow coordinator, WAL recovery,
idempotent txids, a crash between intent and publish, an unreachable
coordinator, the two-process writer oracle, the catalog's events, metrics
and /statusz section, and the recover-only CLI build.

Each case runs through both packages (each package's coordinator behind a
real listener of its own, each package's tables), over the same seeded
data, and the port's outcomes are held to the reference's; the two-process
oracle also runs a writer of each package through one port coordinator.
The fs backend's cases run in tests/test_torch_lakehouse.py.

Tolerance: exact. Rows, versions, responses and counters are integers."""

import argparse
import json
import os
import posixpath
import subprocess
import sys
import time

import pyarrow as pa
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from torch_join_cases import strict_budget  # noqa: E402,F401
from torch_serve_cases import JAX, PKGS, TORCH, reset  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ENV_KEYS = (
    "NDS_LAKE_CATALOG", "NDS_LAKE_COMMIT_BACKOFF", "NDS_LAKE_WRITER_TTL_S",
    "NDS_LAKE_CATALOG_POLL_S", "NDS_LAKE_CATALOG_TIMEOUT_S",
    "NDS_LAKE_LEASE_TTL_S", "NDS_HEARTBEAT_INTERVAL_MS",
    "NDS_LAKE_COMMIT_RETRIES",
)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in _ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("NDS_LAKE_COMMIT_BACKOFF", "0")
    for P in PKGS:
        reset(P)
    yield
    for P in PKGS:
        reset(P)


@pytest.fixture
def coordinators():
    """start(P, tracer=None) -> (coordinator, server, url): P's coordinator
    behind a real ephemeral listener; every listener stops at the end."""
    servers = []

    def start(P, tracer=None):
        server = P.HS.MetricsServer(P.M.MetricsSink(), 0, host="127.0.0.1")
        coord = P.C.CatalogCoordinator(tracer=tracer)
        server.attach_app(coord)
        server.start()
        servers.append(server)
        return coord, server, f"http://127.0.0.1:{server.port}"

    yield start
    for s in servers:
        try:
            s.stop()
        except Exception:
            pass


def _ints(*vals):
    return pa.table({"a": pa.array(list(vals), type=pa.int64())})


def _vals(P, path):
    return sorted(x["a"] for x in
                  P.T.LakehouseTable(path).dataset().to_table().to_pylist())


def _versions(P, path):
    return [v for v, _, _ in P.T.LakehouseTable(path).versions()]


def _table(P, tmp_path, *vals):
    path = str(tmp_path / P.name / "t")
    P.T.LakehouseTable.create(path, _ints(*vals))
    return path


def _use(P, monkeypatch, url, **env):
    monkeypatch.setenv("NDS_LAKE_CATALOG", url)
    for k, v in env.items():
        monkeypatch.setenv(k, str(v))
    P.C.reset_clients()


def _per_pkg(fn):
    """{package name: fn(P)}, each package starting with no catalog
    configured (its tables are created outside any coordinator)."""
    out = {}
    for P in PKGS:
        os.environ.pop("NDS_LAKE_CATALOG", None)
        P.C.reset_clients()
        out[P.name] = fn(P)
    return out


# ---------------------------------------------------------------------------
# tcp backend: coordinator
# ---------------------------------------------------------------------------


def test_coordinator_commit_lease_fence_roundtrip(tmp_path, coordinators,
                                                  monkeypatch):
    def run(P):
        path = _table(P, tmp_path, 1)
        _, _, url = coordinators(P)
        _use(P, monkeypatch, url)
        t = P.T.LakehouseTable(path)
        assert t.catalog.backend == "tcp"
        t.append(_ints(2))
        t.append(_ints(3))
        assert _vals(P, path) == [1, 2, 3]
        assert _versions(P, path) == [1, 2, 3]
        with open(os.path.join(path, "_manifests", "v000003.json")) as fh:
            assert json.load(fh).get("txid")
        snap = t.snapshot()
        lease = t.acquire_reader_lease(snap, 60)
        assert len(t._held_files()) == len(snap.rel_files)
        t.replace(_ints(9))
        held = t.vacuum(retain_last=1)["files_removed"]
        assert held == 0
        P.L.LEASES.release(lease)  # forwards to the coordinator's half
        removed = t.vacuum(retain_last=1)["files_removed"]
        assert removed >= 1
        assert _vals(P, path) == [9]
        return _versions(P, path), held, removed

    out = _per_pkg(run)
    assert out["jax"] == out["torch"]


def test_coordinator_releases_writer_epochs_for_fencing(tmp_path,
                                                        coordinators,
                                                        monkeypatch):
    def run(P):
        path = _table(P, tmp_path, 1)
        _, _, url = coordinators(P)
        _use(P, monkeypatch, url)
        t = P.T.LakehouseTable(path)
        t.append(_ints(2))  # registers an epoch, publishes, releases it
        last_epoch = t.catalog.read_fence(t)
        fence = t.catalog.bump_fence(t)
        assert fence >= 1 and fence > last_epoch
        P.T.LakehouseTable(path).append(_ints(3))
        assert _vals(P, path) == [1, 2, 3]
        return last_epoch, fence, _versions(P, path)

    out = _per_pkg(run)
    assert out["jax"] == out["torch"]


def test_slow_coordinator_refuses_publish_past_client_deadline(
        tmp_path, coordinators, monkeypatch):
    """A coordinator slow past the client's timeout + poll budget must not
    publish later: the client classified the commit failed-retryable, and
    its re-run would land the rows twice."""
    def run(P):
        path = _table(P, tmp_path, 1)
        coord, _, url = coordinators(P)
        _use(P, monkeypatch, url, NDS_LAKE_CATALOG_TIMEOUT_S=0.4,
             NDS_LAKE_CATALOG_POLL_S=0.2)
        t = P.T.LakehouseTable(path)
        orig_commit = coord._fs.commit
        stalled = {"n": 0}

        def slow_commit(*a, **kw):
            stalled["n"] += 1
            time.sleep(1.5)
            return orig_commit(*a, **kw)

        coord._fs.commit = slow_commit
        try:
            with pytest.raises(P.C.CatalogUnreachableError):
                t.append(_ints(2))
        finally:
            coord._fs.commit = orig_commit
        time.sleep(1.8)  # the stalled commit ends: its publish is refused
        assert stalled["n"] == 1
        assert _versions(P, path) == [1]
        P.T.LakehouseTable(path).append(_ints(2))
        assert _vals(P, path) == [1, 2]
        return _versions(P, path)

    out = _per_pkg(run)
    assert out["jax"] == out["torch"] == [1, 2]


def test_coordinator_wal_recovery_rolls_back_unpublished(tmp_path,
                                                         coordinators):
    def run(P):
        path = _table(P, tmp_path, 1)
        coord, _, _ = coordinators(P)
        ref = coord._ref(path)
        coord._fs._write_json(ref, "wal/txdone.json",
                              {"version": 1, "txid": "txdone"})
        coord._fs._write_json(ref, "wal/txlost.json",
                              {"version": 7, "txid": "txlost"})
        coord._fs._write_json(ref, "wal/.torn", {"x": 1})  # debris
        rep = coord.recover(path)
        assert rep["pruned"] == 1 and rep["rolled_back"] == 1
        assert coord._fs._ls(ref, "wal") == []
        assert _versions(P, path) == [1]
        return rep

    out = _per_pkg(run)
    assert out["jax"] == out["torch"]


def test_coordinator_idempotent_txid_replay(tmp_path, coordinators):
    def run(P):
        path = _table(P, tmp_path, 1)
        _, _, url = coordinators(P)
        client = P.C.HttpCatalog(url)
        manifest = {
            "version": 2, "timestamp_ms": 1, "operation": "append",
            "files": [], "num_rows": 0, "schema_hex": None,
        }
        body = {"root": path, "manifest": manifest, "epoch": None,
                "txid": "tx-same"}
        r1 = client._post("/catalog/commit", body)
        r2 = client._post("/catalog/commit", body)
        assert r1 == r2 == {"published": True, "version": 2}
        assert _versions(P, path) == [1, 2]
        # a malformed body is a 400 the client raises as CatalogError
        with pytest.raises(P.C.CatalogError, match="400"):
            client._post("/catalog/lease", {"root": path, "op": "nope"})
        return r1, r2

    out = _per_pkg(run)
    assert out["jax"] == out["torch"]


def test_coordinator_crash_mid_commit_exactly_once(tmp_path, coordinators,
                                                   monkeypatch):
    """The coordinator dies between the WAL intent and the publish (crash
    at catalog:commit fires on the coordinator: the client only fires io
    and hang there). The client classifies the loss retryable, recovery
    rolls the intent back, and the retry lands its rows exactly once."""
    def run(P):
        path = _table(P, tmp_path, 1)
        coord, _, url = coordinators(P)
        _use(P, monkeypatch, url, NDS_LAKE_CATALOG_TIMEOUT_S=2,
             NDS_LAKE_CATALOG_POLL_S=0.2)
        t = P.T.LakehouseTable(path)
        P.faults.install("crash:catalog:commit")
        with pytest.raises(P.C.CatalogUnreachableError) as ei:
            t.append(_ints(2))
        assert P.faults.classify(ei.value) == P.faults.IO_TRANSIENT
        P.faults.reset()
        ref = coord._ref(path)
        assert len(coord._fs._ls(ref, "wal")) == 1
        assert _versions(P, path) == [1]
        rep = coord.recover(path)
        assert rep["rolled_back"] == 1
        P.T.LakehouseTable(path).append(_ints(2))
        assert _vals(P, path) == [1, 2]
        for v in _versions(P, path):  # no torn manifest anywhere
            P.T.LakehouseTable(path).snapshot(v)
        return rep, _versions(P, path)

    out = _per_pkg(run)
    assert out["jax"] == out["torch"]


def test_unreachable_coordinator_degrades_gracefully(tmp_path, monkeypatch):
    """Writes fail classified-retryable, pinned reads keep serving, lease
    registration degrades to process-local, vacuum fails conservative."""
    def run(P):
        path = _table(P, tmp_path, 1, 2)
        _use(P, monkeypatch, "http://127.0.0.1:9",
             NDS_LAKE_CATALOG_TIMEOUT_S=0.3, NDS_LAKE_CATALOG_POLL_S=0.1)
        t = P.T.LakehouseTable(path)
        with pytest.raises(P.C.CatalogUnreachableError) as ei:
            t.append(_ints(3))
        assert P.faults.classify(ei.value) == P.faults.IO_TRANSIENT
        assert t.num_rows() == 2
        lease = t.acquire_reader_lease(t.snapshot(), 60)
        assert P.L.LEASES.held_versions(t.root) == {1}
        with pytest.raises(P.C.CatalogUnreachableError):
            t.vacuum(retain_last=1)
        P.L.LEASES.release(lease)
        return t.num_rows(), _versions(P, path)

    out = _per_pkg(run)
    assert out["jax"] == out["torch"]


def test_injected_unreachable_fault_site(tmp_path, coordinators,
                                         monkeypatch):
    """`catalog:unreachable` fails a client call as a dead coordinator
    would, without touching the wire; the next call goes through."""
    def run(P):
        path = _table(P, tmp_path, 1)
        _, _, url = coordinators(P)
        _use(P, monkeypatch, url, NDS_LAKE_CATALOG_POLL_S=0.1)
        P.faults.install("io:catalog:unreachable:1")
        with pytest.raises(P.C.CatalogUnreachableError, match="injected"):
            P.T.LakehouseTable(path).append(_ints(2))
        P.faults.reset()
        P.T.LakehouseTable(path).append(_ints(2))
        return _vals(P, path), _versions(P, path)

    out = _per_pkg(run)
    assert out["jax"] == out["torch"] == ([1, 2], [1, 2])


# ---------------------------------------------------------------------------
# the two-process writer conflict oracle
# ---------------------------------------------------------------------------

_WRITER_SCRIPT = """
import sys
sys.path.insert(0, {repo!r})
import pyarrow as pa
from {pkg}.lakehouse.table import LakehouseTable
t = LakehouseTable({path!r})
base = int(sys.argv[1])
for i in range({commits}):
    t.append(pa.table({{"a": pa.array([base + i])}}))
"""


def _run_writers(pkgs, path, commits, extra_env):
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "NDS_LAKE_COMMIT_RETRIES": "64",
           "NDS_LAKE_COMMIT_BACKOFF": "0.005", **extra_env}
    procs = []
    for w, pkg in enumerate(pkgs):
        script = _WRITER_SCRIPT.format(repo=REPO, path=path, pkg=pkg,
                                       commits=commits)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", script, str(1000 * (w + 1))],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()[-2000:]


@pytest.mark.parametrize("mode", ["off", "fs", "tcp", "tcp_both_packages"])
def test_two_process_writer_conflict_oracle(tmp_path, coordinators, mode):
    """Two writer processes race appends: every commit claims exactly one
    version, both row sets land exactly once, and no loser's staged file
    leaks. The port's writers run every mode; `tcp_both_packages` races a
    JAX writer against a port writer through the port's coordinator."""
    path = _table(TORCH, tmp_path, 0)
    extra = {"NDS_LAKE_CATALOG": ""}
    pkgs = ["nds_tpu_torch", "nds_tpu_torch"]
    if mode == "fs":
        extra = {"NDS_LAKE_CATALOG": "fs"}
    elif mode.startswith("tcp"):
        _, _, url = coordinators(TORCH)
        extra = {"NDS_LAKE_CATALOG": url}
        if mode == "tcp_both_packages":
            pkgs = ["nds_tpu", "nds_tpu_torch"]
    commits = 3
    _run_writers(pkgs, path, commits, extra)
    expected = [0] + [1000 * (w + 1) + i for w in range(2)
                      for i in range(commits)]
    for P in PKGS:  # each package reads the history the same way
        assert _vals(P, path) == sorted(expected)
        assert _versions(P, path) == list(range(1, 2 * commits + 2))
    head = {posixpath.basename(f)
            for f in TORCH.T.LakehouseTable(path).current_files()}
    on_disk = {n for n in os.listdir(os.path.join(path, "data"))
               if TORCH.T._STAGED_RE.match(n)}
    assert on_disk == head


# ---------------------------------------------------------------------------
# observability: events, metrics, /statusz
# ---------------------------------------------------------------------------


def test_catalog_events_metrics_and_statusz(tmp_path, monkeypatch):
    def run(P):
        sink = P.M.MetricsSink()
        tracer = P.TR.Tracer(sink=sink)
        monkeypatch.setenv("NDS_LAKE_CATALOG", "fs")
        P.C.reset_clients()
        with P.TR.bind(tracer):
            path = _table(P, tmp_path, 1)
            lt2 = P.T.LakehouseTable(path)
            lt2.append(_ints(2))
            snap = lt2.snapshot()
            lease = lt2.catalog.lease_acquire(lt2, snap.version,
                                              snap.rel_files, 60)
            lease.release()
            lt2.vacuum(retain_last=1)
        kinds = [e["kind"] for e in tracer.events]
        assert "catalog_commit" in kinds and "catalog_lease" in kinds
        assert P.R.validate_events(tracer.events) == []
        for e in tracer.events:
            if e["kind"] in ("catalog_commit", "catalog_lease"):
                for field in P.TR.EVENT_SCHEMA[e["kind"]]:
                    assert field in e, (e["kind"], field)
        reg = sink.registry
        assert reg.counter_value("nds_catalog_commit_total", backend="fs",
                                 outcome="ok") >= 2
        assert sum(reg.counter_series(
            "nds_catalog_lease_total").values()) >= 3
        st = sink.status_snapshot()["catalog"]
        assert st["backend"] == "fs" and st["commits"] >= 2
        assert st["fence"] is not None and st["last_version"] >= 2
        return (sorted(set(kinds)),
                reg.counter_series("nds_catalog_lease_total"),
                reg.counter_series("nds_catalog_commit_total"),
                {k: v for k, v in st.items() if not k.endswith(("ms", "ts"))})

    out = _per_pkg(run)
    assert out["jax"] == out["torch"]


def test_tcp_catalog_events_carry_txids(tmp_path, coordinators,
                                        monkeypatch):
    """Over the tcp backend the client's catalog_commit events carry the
    txid, and the coordinator's own tracer sees the fs half's events."""
    def run(P):
        path = _table(P, tmp_path, 1)
        coord_tracer = P.TR.Tracer(sink=P.M.MetricsSink())
        _, _, url = coordinators(P, tracer=coord_tracer)
        _use(P, monkeypatch, url)
        tracer = P.TR.Tracer(sink=P.M.MetricsSink())
        with P.TR.bind(tracer):
            P.T.LakehouseTable(path).append(_ints(2))
        client = [e for e in tracer.events if e["kind"] == "catalog_commit"]
        assert client and all(e["backend"] == "tcp" and e["txid"]
                              for e in client)
        served = [e for e in coord_tracer.events
                  if e["kind"] == "catalog_commit"]
        assert served and served[0]["txid"] == client[0]["txid"]
        return ([(e["outcome"], e["version"]) for e in client],
                [(e["backend"], e["outcome"]) for e in served])

    out = _per_pkg(run)
    assert out["jax"] == out["torch"]


def test_cli_recover_only_build(tmp_path):
    def run(P):
        build = __import__(f"{P.cli}.catalog",
                           fromlist=["build_coordinator"]).build_coordinator
        wh = tmp_path / P.name / "wh"
        wh.mkdir(parents=True)
        P.T.LakehouseTable.create(str(wh / "t1"), _ints(1))
        P.T.LakehouseTable.create(str(wh / "t2"), _ints(2))
        args = argparse.Namespace(warehouse_path=str(wh), port=0,
                                  property_file=None, recover_only=True)
        _coordinator, _server, recovered = build(args)
        assert {r["table"] for r in recovered} == {"t1", "t2"}
        assert all(r["rolled_back"] == 0 for r in recovered)
        P.M.reset_shared()
        return sorted(recovered, key=lambda r: r["table"])

    out = _per_pkg(run)
    assert out["jax"] == out["torch"]


def test_cli_catalog_serves_on_its_listener(tmp_path, monkeypatch):
    """The port's coordinator process as the CLI builds it: the listener
    answers /catalog/* and /healthz, and a table commits through it."""
    from nds_tpu_torch.cli.catalog import build_coordinator

    wh = tmp_path / "wh"
    wh.mkdir()
    path = str(wh / "t")
    TORCH.T.LakehouseTable.create(path, _ints(1))
    monkeypatch.setenv("NDS_METRICS_HOST", "127.0.0.1")
    args = argparse.Namespace(warehouse_path=str(wh), port=0,
                              property_file=None, recover_only=False)
    coordinator, server, recovered = build_coordinator(args)
    try:
        assert [r["table"] for r in recovered] == ["t"]
        url = f"http://127.0.0.1:{server.port}"
        _use(TORCH, monkeypatch, url)
        TORCH.T.LakehouseTable(path).append(_ints(2))
        assert _vals(TORCH, path) == [1, 2]
        import urllib.request

        with urllib.request.urlopen(f"{url}/catalog/state",
                                    timeout=30) as r:
            assert json.loads(r.read())["tables"] == [path]
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            assert r.status == 200
    finally:
        TORCH.M.reset_shared()

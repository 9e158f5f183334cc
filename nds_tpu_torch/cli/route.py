"""`nds-tpu-torch-submit route`: the fleet router over N serve replicas
(the port of nds_tpu/cli/route.py).

    python -m nds_tpu_torch.cli.route host:port [host:port ...]
        [--port 8081] [--mesh_replica host:port] [--property_file F]

One process, one HTTP listener (shared with /metrics, /statusz,
/healthz — obs/httpserv.py), zero engine state: the router holds replica
addresses, health, verdict cache and retry budgets, nothing else.

    POST /query         routed by budget verdict; 429 `reject` answered
                        at the edge, failover + Retry-After jitter on
                        replica death/shed. X-NDS-Tenant keys the
                        fleet-wide quota.
    GET  /fleet         live replica health + degraded capabilities
    POST /fleet/reload  rolling drain + reload across the replicas
    POST /drain         drain the router itself (healthz flips 503)

SIGTERM/SIGINT drains before exit. Knobs: the `engine.route_*` family
(README). `--mesh_replica` routes spill / blocked / over verdicts to that
replica's URL; the port's replicas run on one card each (mesh execution
is ROADMAP.md queue 1 item 13).
"""

from __future__ import annotations

import argparse
import os
import signal
import threading

from ..check import check_version
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..power import load_properties
from ..serve.router import QueryRouter
from ..serve.service import resolve_serve_port


def build_router(args):
    """Router + listener from CLI args; returns (router, server). Split
    from main() so tests drive the real construction path without a
    subprocess."""
    conf = {"app.name": "NDS - Route"}
    if args.property_file:
        conf.update(load_properties(args.property_file))
    if args.port is not None:
        conf["engine.serve_port"] = args.port
    port = resolve_serve_port(conf)
    if port is None:
        raise SystemExit(
            "route: no port configured (pass --port, set engine.serve_port "
            "in the property file, or NDS_SERVE_PORT; 0 binds ephemeral)"
        )
    # ONE listener: the router rides the process-wide metrics endpoint,
    # same seam as a replica — /query, /fleet, /metrics, /statusz,
    # /healthz all answer from this port
    conf["engine.metrics_port"] = port
    tracer = obs_trace.tracer_from_conf(conf, app_id="nds-route")
    router = QueryRouter(
        args.replica, conf=conf, tracer=tracer,
        mesh_replica=args.mesh_replica,
    )
    server = obs_metrics.active_server()
    if server is None:
        raise SystemExit(
            f"route: could not bind port {port} (already in use?): a "
            f"router without a listener is useless"
        )
    # /statusz's fleet section is the router's live view (replica
    # health, degraded capabilities, fleet tenant in-flight)
    obs_metrics.shared_sink().set_fleet_provider(router.fleet_snapshot)
    server.attach_app(router)
    return router, server


def main(argv=None):
    check_version()
    parser = argparse.ArgumentParser(
        description="fault-tolerant query router over N serve replicas"
    )
    parser.add_argument(
        "replica", nargs="+",
        help="replica address host:port (repeat for the fleet)",
    )
    parser.add_argument(
        "--port", type=int, default=None,
        help="HTTP port (0 = ephemeral; default: engine.serve_port / "
        "NDS_SERVE_PORT)",
    )
    parser.add_argument(
        "--mesh_replica",
        help="replica address to pin spill/blocked-verdict queries to "
        "(the mesh-backed host with the device capacity they need)",
    )
    parser.add_argument(
        "--property_file", help="property file for engine.route_* knobs"
    )
    args = parser.parse_args(argv)
    router, server = build_router(args)
    stop = threading.Event()

    def _on_signal(signum, frame):
        print(f"route: signal {signum}; draining", flush=True)
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    print(
        f"route: fronting {len(router.replicas)} replicas on "
        f"{server.host}:{server.port} "
        f"({router.max_attempts} attempts/request, "
        f"tenant cap {router.tenant_cap or 'off'}, pid {os.getpid()})",
        flush=True,
    )
    stop.wait()
    router.handle_drain()
    router.close()
    print("route: drained; bye", flush=True)


if __name__ == "__main__":
    main()

"""`nds-tpu-torch-submit catalog`: the fleet-catalog coordinator process
(the port of nds_tpu/cli/catalog.py).

    python -m nds_tpu_torch.cli.catalog <warehouse_path> --port 7331
        [--property_file F] [--recover_only]

One coordinator per warehouse. Startup runs WAL recovery over every
lakehouse table under the warehouse root (published intents pruned,
unpublished intents rolled back — they were never acknowledged), then
serves the catalog routes on the ONE process-wide listener
(obs/httpserv.py, via `attach_app` — the same port carries /metrics,
/statusz with its `catalog` section, and /healthz for the fleet's load
checks):

    POST /catalog/commit   fence-checked, WAL-journaled, serialized
                           manifest publish (the single-writer commit log)
    POST /catalog/lease    reader-lease acquire/renew/release/held/sweep
    POST /catalog/fence    writer registration (epoch tokens), fence
                           read/bump
    GET  /catalog/state    tables this coordinator has touched

Clients point `engine.lake_catalog` / NDS_LAKE_CATALOG at
`http://host:port`. Kill -TERM exits cleanly; a crash at any point is
recovered by the next start's WAL pass (`--recover_only` runs that pass
alone). The coordinator is host code only: it needs no card.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading

from ..check import check_version
from ..lakehouse.catalog import CatalogCoordinator
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..power import load_properties


def build_coordinator(args):
    """Coordinator + listener from CLI args; returns (coordinator,
    server, recovery report). Split from main() so tests drive the real
    construction path."""
    conf = {"app.name": "NDS - Catalog"}
    if args.property_file:
        conf.update(load_properties(args.property_file))
    if args.port is not None:
        conf["engine.serve_port"] = args.port
    port = conf.get("engine.serve_port")
    if port is None:
        port = os.environ.get("NDS_SERVE_PORT")
    if port is None:
        raise SystemExit(
            "catalog: no port configured (pass --port or NDS_SERVE_PORT; "
            "0 binds ephemeral)"
        )
    # ONE listener: the catalog rides the process-wide metrics endpoint,
    # so /catalog/*, /metrics, /statusz and /healthz share a port
    conf["engine.metrics_port"] = int(port)
    tracer = obs_trace.tracer_from_conf(conf)
    coordinator = CatalogCoordinator(tracer=tracer)
    recovered = coordinator.recover_warehouse(args.warehouse_path)
    server = obs_metrics.active_server()
    if server is None and not args.recover_only:
        raise SystemExit(
            f"catalog: could not bind port {port} (already in use?): a "
            f"coordinator without a listener arbitrates nothing"
        )
    if server is not None:
        server.attach_app(coordinator)
    return coordinator, server, recovered


def main(argv=None):
    check_version()
    parser = argparse.ArgumentParser(
        description="fleet-catalog coordinator: single-writer commit log, "
        "cross-host leases, vacuum fencing for one lakehouse warehouse"
    )
    parser.add_argument(
        "warehouse_path", help="warehouse root holding lakehouse tables"
    )
    parser.add_argument(
        "--port", type=int, default=None,
        help="HTTP port (0 = ephemeral; default: engine.serve_port / "
        "NDS_SERVE_PORT)",
    )
    parser.add_argument(
        "--property_file", help="property file for engine configuration"
    )
    parser.add_argument(
        "--recover_only", action="store_true",
        help="run WAL recovery over the warehouse and exit (no listener)",
    )
    args = parser.parse_args(argv)
    coordinator, server, recovered = build_coordinator(args)
    for rep in recovered:
        if rep["pruned"] or rep["rolled_back"]:
            print(
                f"catalog: recovered {rep['table']}: {rep['pruned']} "
                f"pruned, {rep['rolled_back']} rolled back", flush=True,
            )
    if args.recover_only:
        print(f"catalog: recovery done over {len(recovered)} table(s)",
              flush=True)
        return
    stop = threading.Event()

    def _on_signal(signum, frame):
        print(f"catalog: signal {signum}; bye", flush=True)
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    print(
        f"catalog: coordinating {args.warehouse_path} on "
        f"{server.host}:{server.port} (pid {os.getpid()})", flush=True,
    )
    stop.wait()


if __name__ == "__main__":
    main()

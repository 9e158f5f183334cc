"""`nds-tpu-torch-submit serve`: the long-lived multi-tenant query service
(the port of nds_tpu/cli/serve.py).

    python -m nds_tpu_torch.cli.serve <warehouse_path>
        [--input_format lakehouse] [--port 8080] [--property_file F]
        [--stream query_0.sql] [--job_dir DIR] [--floats]
        [--aot_cache_dir DIR] [--device DEV]

One process, one warm Session, one HTTP listener (shared with /metrics,
/statusz, /healthz: obs/httpserv.py):

    POST /query    {"sql": ...} or {"template": "query3", "params": {}}
                   + optional offset/limit; the X-NDS-Tenant header keys
                   the per-tenant accounting. 429 = admission rejected (the
                   body carries the modeled peak bytes) or shed
                   (Retry-After).
    POST /plan     the statement's budget verdict, no admission slot
    POST /stream   {"stream": <server-side stream file>} -> 202 job
    GET  /jobs/<id>  job progress (resumable, full_bench's state pattern)
    POST /drain    stop admitting, finish in-flight, flip /healthz to 503
    POST /reload   re-resolve the warehouse (fresh lakehouse heads)

The sessions run on the card (`--device` names another, e.g. `cpu`); a
session without a GPU raises rather than moving to the CPU. SIGTERM /
SIGINT drains before exit, so a rolling restart loses no in-flight work
inside the drain budget.
"""

from __future__ import annotations

import argparse
import os
import signal
import threading

from ..check import check_version
from ..engine.session import Session
from ..obs import metrics as obs_metrics
from ..power import gen_sql_from_stream, load_properties
from ..serve.service import QueryService, resolve_serve_port


def build_service(args):
    """Sessions + service + listener from CLI args; returns (service,
    server). Split from main() so tests drive the real construction path
    without a subprocess."""
    conf = {"app.name": "NDS - Serve"}
    if args.property_file:
        conf.update(load_properties(args.property_file))
    if args.port is not None:
        conf["engine.serve_port"] = args.port
    port = resolve_serve_port(conf)
    if port is None:
        raise SystemExit(
            "serve: no port configured (pass --port, set engine.serve_port "
            "in the property file, or NDS_SERVE_PORT; 0 binds ephemeral)"
        )
    # one listener: serve rides the process-wide metrics endpoint, so the
    # query routes, /metrics, /statusz and /healthz share a port
    conf["engine.metrics_port"] = port
    if args.job_dir:
        conf["engine.serve_job_dir"] = args.job_dir
    # replicas pointed at one shared persistent cache load the fused
    # builds `cache warm` made once (engine/aotcache.py)
    aot_dir = getattr(args, "aot_cache_dir", None)
    if aot_dir:
        conf["engine.aot_cache_dir"] = aot_dir
        os.environ["NDS_AOT_CACHE_DIR"] = aot_dir
    # fleet cardinality feedback: the same wiring shape. A shared
    # --aot_cache_dir already shares feedback (the store defaults to
    # <aot dir>/feedback); this flag points replicas at a standalone store
    # when the AOT dir is per-host or disabled
    fb_dir = getattr(args, "feedback_dir", None)
    if fb_dir:
        conf["engine.feedback_dir"] = fb_dir
        os.environ["NDS_FEEDBACK_DIR"] = fb_dir
    use_decimal = not args.floats
    device = getattr(args, "device", None)
    session = Session(use_decimal=use_decimal, conf=conf, device=device)
    # DML runs on a session of its own (its own caches and
    # last_plan_budget), so the writer path never perturbs the read
    # tier's planning; both share the process's lease table
    wconf = dict(conf)
    wconf["app.name"] = "NDS - Serve writer"
    writer = Session(use_decimal=use_decimal, conf=wconf, device=device)

    def register(target):
        target.register_nds_tables(
            args.warehouse_path, fmt=args.input_format
        )
        return len(target.catalog.entries)

    n = register(session)
    register(writer)
    if n == 0:
        raise SystemExit(
            f"serve: no tables found under {args.warehouse_path!r} "
            f"(format {args.input_format})"
        )
    templates = {}
    if args.stream:
        templates = gen_sql_from_stream(args.stream)

    def reload_fn():
        return max(register(session), register(writer))

    service = QueryService(
        session, writer_session=writer, templates=templates,
        reload_fn=reload_fn,
    )
    server = obs_metrics.active_server()
    if server is None:
        raise SystemExit(
            f"serve: could not bind port {port} (already in use?): a "
            f"query service without a listener is useless"
        )
    server.attach_app(service)
    return service, server


def main(argv=None):
    check_version()
    parser = argparse.ArgumentParser(
        description="long-lived multi-tenant query service over a warehouse"
    )
    parser.add_argument(
        "warehouse_path", help="warehouse root (transcoded tables)"
    )
    parser.add_argument(
        "--input_format", default="lakehouse",
        choices=("parquet", "orc", "csv", "lakehouse"),
        help="warehouse table format (default: lakehouse, which DML needs)",
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
        "--stream",
        help="generated query stream file whose entries become named "
        "templates for POST /query {'template': ...}",
    )
    parser.add_argument(
        "--job_dir", help="stream-job checkpoint directory "
        "(engine.serve_job_dir)",
    )
    parser.add_argument(
        "--floats", action="store_true",
        help="use double instead of decimal for decimal-typed columns",
    )
    parser.add_argument(
        "--aot_cache_dir",
        help="shared persistent cache dir (engine.aot_cache_dir): point "
        "every replica at the dir `cache warm` filled",
    )
    parser.add_argument(
        "--feedback_dir",
        help="shared cardinality feedback store dir "
        "(engine.feedback_dir): replicas record and consume learned "
        "per-node actuals fleet-wide; defaults to <aot_cache_dir>/"
        "feedback when an AOT dir is set",
    )
    parser.add_argument(
        "--device",
        help="the sessions' device (default: the card, cuda)",
    )
    args = parser.parse_args(argv)
    service, server = build_service(args)
    stop = threading.Event()

    def _on_signal(signum, frame):
        print(f"serve: signal {signum}; draining "
              f"(budget {service.drain_timeout_s:.0f}s)", flush=True)
        stop.set()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    print(
        f"serve: listening on {server.host}:{server.port} "
        f"({service.workers} workers, row cap {service.row_cap}, "
        f"{len(service.templates)} templates, pid {os.getpid()})",
        flush=True,
    )
    stop.wait()
    service.handle_drain()
    print("serve: drained; bye", flush=True)


if __name__ == "__main__":
    main()

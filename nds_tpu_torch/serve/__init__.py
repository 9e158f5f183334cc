"""Serve mode: the long-lived multi-tenant query service, the port of
nds_tpu/serve/.

`nds-tpu-torch-submit serve` turns the batch engine into a query
*service*: one warm Session (plan / result, join-order and fused-build
caches shared across requests) behind `POST /query`, stream jobs, and
admin verbs on the same process-wide HTTP endpoint that already serves
/metrics, /statusz and /healthz (obs/httpserv.py). Admission control is
the static plan budgeter's verdict per request; backpressure rides the
RSS watermark; per-request isolation reuses the lakehouse snapshot pins
and reader leases. The fleet router (router.py) fronts N such services.
"""

from .service import (  # noqa: F401
    QueryService,
    resolve_serve_port,
    resolve_row_cap,
    resolve_drain_timeout,
)

"""Sessions of both engines over the same Arrow tables, and one query run
through both with chip_smoke.branch_spy on each executor: the harness of
tests/test_torch_windows.py, test_torch_rollup.py and
test_torch_templates.py. JAX runs on the CPU with no AOT cache and its
Pallas routes in interpret mode; the port runs as Session(device="cpu").
"""

from nds_tpu.engine import exec as JX
from nds_tpu.engine.session import Session as JaxSession
from nds_tpu_torch.engine import exec as TX
from nds_tpu_torch.engine.session import Session as TorchSession

from torch_join_cases import CS


def kernel_conf(mode):
    return {f"engine.pallas_{k}": mode for k in ("agg", "join", "sort")}


def session_pair(arrow, conf=None, schemas=None):
    """(JAX session, port session) over the same tables."""
    conf = dict(conf or {})
    j = JaxSession(conf={**conf, "engine.aot_cache_dir": ""})
    t = TorchSession(conf=conf, device="cpu")
    for name, at in arrow.items():
        schema = None if schemas is None else schemas.get(name)
        j.register_arrow(name, at, schema)
        t.register_arrow(name, at, schema)
    return j, t


def sessions(arrow, conf=None):
    """{mode: (JAX session, port session)} for the kernel routes `off`
    and `on`."""
    return {mode: session_pair(arrow, {**(conf or {}), **kernel_conf(mode)})
            for mode in ("off", "on")}


def run_both(j, t, sql):
    """(JAX result, port result, JAX events, port events)."""
    out = []
    for sess, ex in ((j, JX.Executor), (t, TX.Executor)):
        ev = []
        restore = CS.branch_spy(ex, ev)
        try:
            out.append((sess.sql(sql).collect(), ev))
        finally:
            restore()
    (a, ev_j), (b, ev_t) = out
    return a, b, ev_j, ev_t

"""Print a statement's plan, and with `--budget` the static budgeter's
per-node estimate table and verdict (analysis/budget.py): modeled
rows / width / capacity / allocation / peak per plan node, the plan-level
peak against the working-set line, and the chosen execution mode (direct |
blocked(window_rows) | spill | over | reject). The port of
nds_tpu/cli/explain.py.

Schema-only by default: `--scale SF` synthesizes base-table cardinalities
from the TPC-DS scaling model, so no data is needed. `--data_dir` points
at a parquet warehouse to estimate against its row counts instead. The
session runs on the card unless `--device` names another (e.g. `cpu`), so
the verdicts are against the device's own budget lines
(`budget.budget_lines`); `--budget_bytes` overrides the working-set line.
With `engine.verify_plans` / NDS_VERIFY_PLANS set, every plan goes
through the plan verifier (analysis/verifier.py) as it is planned.

Examples:
    # one template's budget table at SF10, schema-only, on the card
    python -m nds_tpu_torch.cli.explain --query 5 --scale 10 --budget

    # ad-hoc SQL against a warehouse, on the CPU's lines
    python -m nds_tpu_torch.cli.explain --data_dir /data/wh --budget \\
        --device cpu --sql "select count(*) from store_sales"
"""

from __future__ import annotations

import argparse
import os
import sys


def _build_session(args):
    from ..engine.session import Session, _Entry
    from ..schema import get_schemas

    conf = {"engine.plan_budget": "off"}  # enforcement off: explain only
    if args.budget_bytes:
        conf["engine.plan_budget_bytes"] = int(args.budget_bytes)
    sess = Session(use_decimal=not args.float, conf=conf, device=args.device)
    if args.data_dir:
        sess.register_nds_tables(args.data_dir, fmt=args.format)
    else:
        for name, schema in get_schemas(not args.float).items():
            sess.catalog.entries[name] = _Entry(schema=schema)
    return sess


def _statements(args):
    if args.sql:
        yield "sql", args.sql
        return
    if args.file:
        with open(args.file, encoding="utf-8") as f:
            yield os.path.basename(args.file), f.read()
        return
    import numpy as np

    from ..datagen.query_streams import instantiate

    for q in (int(x) for x in args.query.split(",")):
        rng = np.random.default_rng(np.random.SeedSequence([args.rngseed, 0]))
        yield f"query{q}", instantiate(q, rng, args.scale)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="print a statement's plan (and its static budget table)"
    )
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--sql", help="ad-hoc SQL text")
    src.add_argument("--file", help="path to a .sql file")
    src.add_argument(
        "--query", help="comma-separated TPC-DS template numbers"
    )
    ap.add_argument(
        "--budget", action="store_true",
        help="print the per-node estimate table + verdict",
    )
    ap.add_argument(
        "--mesh", type=int, default=None, metavar="N",
        help="model execution over an N-device mesh (not ported yet: "
        "raises)",
    )
    ap.add_argument(
        "--scale", type=float, default=1.0,
        help="scale factor for schema-only cardinalities (default 1.0)",
    )
    ap.add_argument(
        "--data_dir", default=None,
        help="real warehouse dir (estimates use actual catalog rows)",
    )
    ap.add_argument("--format", default="parquet")
    ap.add_argument("--float", action="store_true",
                    help="float (non-decimal) type mapping")
    ap.add_argument("--budget_bytes", type=int, default=None,
                    help="override the working-set budget")
    ap.add_argument("--rngseed", type=int, default=0)
    ap.add_argument(
        "--top", type=int, default=0,
        help="only print the last N (outermost) estimate rows",
    )
    ap.add_argument(
        "--device",
        help="the session's device, whose budget lines the verdicts are "
        "against (default: the card, cuda)",
    )
    args = ap.parse_args(argv)
    if args.mesh is not None:
        raise NotImplementedError(
            "explain --mesh is not ported to nds_tpu_torch yet: ROADMAP.md "
            "queue 1 item 13 (parallel/)"
        )

    from ..analysis import budget as B
    from ..engine.sql import ast as A
    from ..engine.sql.parser import parse_script

    sess = _build_session(args)
    rejected = 0
    for label, text in _statements(args):
        for i, stmt in enumerate(parse_script(text)):
            if not isinstance(stmt, A.SelectStmt):
                print(f"== {label}#{i}: skipped ({type(stmt).__name__})")
                continue
            res = sess.run_stmt(stmt)
            print(f"== {label}#{i}")
            print(res.explain(), end="")
            if not args.budget:
                continue
            pb = B.analyze_plan(
                res.plan,
                sess.catalog,
                scale_factor=None if args.data_dir else args.scale,
                budget_bytes=B.resolve_budget_bytes(sess.conf, sess.device),
                reject_bytes=B.resolve_reject_bytes(sess.conf, sess.device),
            )
            print(pb.table(limit=args.top))
            B.emit_budget_event(sess.tracer, pb)
            if pb.verdict == "reject":
                rejected += 1
    return 2 if rejected else 0


if __name__ == "__main__":
    sys.exit(main())

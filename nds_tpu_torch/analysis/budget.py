"""Static plan budgeter: plan-time cardinality and peak device-memory
analysis, the port of nds_tpu/analysis/budget.py.

It walks a bound + pruned plan and derives, per node, a cardinality bound
(catalog row counts, filter-selectivity heuristics, join key-uniqueness
from TABLE_PRIMARY_KEYS, blocked-union annotations) and a peak device-byte
model of what the executor materializes (power-of-two capacity buckets,
gather and pair-table widths, sort key words, segment-reduce outputs,
union concatenations, per-window slices), and folds them into one verdict:

  direct   the modeled peak fits the working-set budget
  blocked  over budget, but fits once the blocked-union aggregates run in
           statically sized windows (`window_rows`, which
           exec._blocked_union_ctx consumes ahead of the runtime size)
  spill    over budget, under the reject line, with an out-of-core seam:
           the spillable nodes are annotated with `spill_partitions` and
           the executor's `auto` spill mode runs them partitioned
  over     over budget, under the reject line, with no seam: admitted,
           the prediction recorded for the device-OOM ladder
  reject   beyond the reject line even windowed: PlanBudgetError, on
           every device, as in the reference
  unknown  some base-table cardinality is unknown: no enforcement

The byte model is the JAX package's, unchanged (same nodes, bucketing and
slack), so both budgeters give the same verdict on the same plan and
lines. It is an upper bound: it rounds every row count up to a power of
two and keeps children live while their parent runs. Where the port
materializes less than the JAX executor (grouping sets concatenate the
packed parts by their row counts, exec._concat_rows), the model stays the
JAX executor's and so an upper bound for the port too.

The lines. On a CPU session they are the reference package's constants
(DEFAULT_BUDGET_BYTES, DEFAULT_REJECT_BYTES, DEFAULT_CATALOG_BUDGET_BYTES),
so the CPU parity tests compare like with like. On a CUDA session they are
the card's own (`budget_lines`).

Knobs (the JAX package's names): conf `engine.plan_budget` / env
NDS_PLAN_BUDGET = off | warn | on (default on; warn records but never
annotates or rejects), conf `engine.plan_budget_bytes` / env
NDS_PLAN_BUDGET_BYTES, conf `engine.plan_budget_reject_bytes` / env
NDS_PLAN_BUDGET_REJECT_BYTES, env NDS_CATALOG_BUDGET_BYTES (the catalog
residency budget the union windows are sized against), and conf
`engine.plan_budget_sf` (schema-only sessions: base-table rows from the
TPC-DS scale model). Each budgeted statement emits a `plan_budget` trace
event (emit_budget_event). With a feedback store
(analysis/feedback.py; `engine.plan_feedback` = off | record | on, default
record) the plan's nodes carry their store keys and static estimates for
the executor to record actuals against, and in mode `on` a recorded
actual replaces a node's static row estimate. Not ported: the mesh's
per-device model (ROADMAP.md queue 1 item 13).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Optional

import torch

from ..engine import expr as E
from ..engine import plan as P
from ..schema import TABLE_PRIMARY_KEYS
from . import feedback as _feedback

# ---------------------------------------------------------------------------
# TPC-DS row-count model (a copy of the generator's datagen/native/
# rowcounts.hpp table: the generator and the budgeter must agree on what a
# scale factor means)
# ---------------------------------------------------------------------------

#: spec row counts (TPC-DS v3.2.0 table 3-2) at the defined scale knots
_SCALE_KNOTS = (1, 10, 100, 1000, 3000, 10000, 100000)

_DIM_SCALE_POINTS = {
    "call_center": (6, 24, 30, 42, 48, 54, 60),
    "catalog_page": (11718, 12000, 20400, 30000, 36000, 40000, 50000),
    "customer": (100000, 500000, 2000000, 12000000, 30000000, 65000000,
                 100000000),
    "customer_address": (50000, 250000, 1000000, 6000000, 15000000,
                         32500000, 50000000),
    "item": (18000, 102000, 204000, 300000, 360000, 402000, 502000),
    "promotion": (300, 500, 1000, 1500, 1800, 2000, 2500),
    "reason": (35, 45, 55, 65, 67, 70, 75),
    "store": (12, 102, 402, 1002, 1350, 1500, 1902),
    "warehouse": (5, 10, 15, 20, 22, 25, 30),
    "web_page": (60, 200, 2040, 3000, 3600, 4002, 5004),
    "web_site": (30, 42, 54, 60, 66, 78, 96),
}

_FIXED_ROWS = {
    "customer_demographics": 1920800,
    "household_demographics": 7200,
    "date_dim": 73049,
    "time_dim": 86400,
    "income_band": 20,
    "ship_mode": 20,
}

#: (orders at SF1, average lines per order) per sales channel; returns are
#: ~10% of sales lines
_CHANNELS = {
    "store_sales": (240000, 12.0),
    "catalog_sales": (160000, 9.0),
    "web_sales": (60000, 12.0),
}
_RETURN_FRACTION = 0.10
_INVENTORY_WEEKS = 261


def _interp_rows(points, sf: float) -> int:
    if sf <= 1.0:
        return max(int(math.ceil(points[0] * sf)), min(points[0], 2))
    for i in range(len(_SCALE_KNOTS) - 1):
        if sf <= _SCALE_KNOTS[i + 1]:
            t = (math.log(sf) - math.log(_SCALE_KNOTS[i])) / (
                math.log(_SCALE_KNOTS[i + 1]) - math.log(_SCALE_KNOTS[i])
            )
            lo = math.log(points[i])
            hi = math.log(points[i + 1])
            return int(round(math.exp(lo + t * (hi - lo))))
    return points[-1]


def spec_table_rows(table: str, sf: float) -> Optional[int]:
    """Estimated base-table rows at scale factor `sf` under the generator's
    scaling model (exact at the spec's scale points for dimensions, the
    expected value for the line-count-randomized facts); None for a table
    the model does not know."""
    if table in _DIM_SCALE_POINTS:
        return _interp_rows(_DIM_SCALE_POINTS[table], sf)
    if table in _FIXED_ROWS:
        return _FIXED_ROWS[table]
    if table in _CHANNELS:
        orders, lines = _CHANNELS[table]
        return max(int(round(orders * sf * lines)), 1)
    if table.endswith("_returns"):
        sales = table[: -len("_returns")] + "_sales"
        if sales in _CHANNELS:
            orders, lines = _CHANNELS[sales]
            return max(int(round(orders * sf * lines * _RETURN_FRACTION)), 1)
    if table == "inventory":
        item = _interp_rows(_DIM_SCALE_POINTS["item"], sf)
        wh = _interp_rows(_DIM_SCALE_POINTS["warehouse"], sf)
        return _INVENTORY_WEEKS * max(item // 2, 1) * wh
    return None


# ---------------------------------------------------------------------------
# widths
# ---------------------------------------------------------------------------

#: minimum capacity bucket (columnar._MIN_CAP, kept literal so the model
#: needs no device module)
_MIN_CAP = 1024


def bucket_cap(n: int) -> int:
    cap = _MIN_CAP
    while cap < n:
        cap *= 2
    return cap


def column_row_bytes(dtype) -> int:
    """Device bytes per row of one column: data itemsize + 1 validity byte
    (the row_bytes rule of exec._blocked_union_ctx). Strings are int32
    dictionary codes on the device; decimals are scaled int64."""
    k = dtype.kind
    if k in ("int32", "date", "string", "char", "varchar"):
        return 5
    if k == "bool":
        return 2
    return 9  # int64 / float64 / decimal


def schema_row_bytes(sch: dict) -> int:
    """Bytes per row over a name -> DType schema mapping."""
    return max(sum(column_row_bytes(dt) for dt in sch.values()), 1)


# ---------------------------------------------------------------------------
# budget lines
# ---------------------------------------------------------------------------

#: the reference package's working-set line, reject line and catalog
#: residency budget: the lines of a CPU session
DEFAULT_BUDGET_BYTES = 4 << 30
DEFAULT_REJECT_BYTES = 14 << 30
DEFAULT_CATALOG_BUDGET_BYTES = 6 << 30

#: the reference's calibration contract: a query's measured working set
#: must not exceed CALIBRATION_SLACK x its modeled peak
CALIBRATION_SLACK = 2.0

#: blocked-union windows get at most this fraction of a budget (the window
#: buffers coexist with cached base tables, the per-window join output and
#: the partial-aggregate merge intermediates)
WINDOW_BUDGET_FRACTION = 16

#: out-of-core partition-count cap: past this, per-partition fixed costs
#: (probe re-scan, segment round trips) dominate any device-memory relief
SPILL_MAX_PARTITIONS = 256

MODES = ("off", "warn", "on")


@dataclass(frozen=True)
class BudgetLines:
    """A device's budget lines, in bytes."""

    working_set: int  # engine.plan_budget_bytes: modeled peak of `direct`
    reject: int  # engine.plan_budget_reject_bytes: admission refuses above
    catalog: int  # catalog residency: the union windows' budget


#: a CUDA card's headrooms, each a reading on an NVIDIA H100 80GB HBM3 at
#: 700 W (chip_smoke.py at SF100; PERF.md section 4) rounded up to a whole
#: GiB. Runtime: what the CUDA runtime held outside the caching allocator
#: (the context, the loaded kernels) at the end of the run, 665,649,152 B
#: (0.62 GiB; chip_smoke's `device_memory.runtime_bytes`).
CARD_RUNTIME_HEADROOM_BYTES = 1 << 30
#: Allocator: the largest gap of peak reserved over peak allocated in any
#: query's steady runs, read from an emptied cache with expandable
#: segments: 8.76 GiB, in q51 (q97 8.01, q3 4.56; chip_smoke's
#: `budget.allocator_gap_gib`).
CARD_ALLOCATOR_HEADROOM_BYTES = 9 << 30


def budget_lines(device=None) -> BudgetLines:
    """The lines of a session on `device` where neither conf nor
    environment sets them.

    CPU: the reference package's constants, so that the CPU parity tests
    hold both budgeters to the same lines.

    CUDA: the card's own, from its memory M
    (`torch.cuda.get_device_properties(device).total_memory`), by the rule
    the reference states for its device: the working set is the device
    minus the catalog's residency minus the allocator's headroom, and the
    reject line is the device minus the runtime's headroom. The catalog
    residency keeps the reference's share, 3/8 of M (the port's SF100
    tables hold 25.7-32.5 GiB of an 80 GB card); the two headrooms are
    readings on the card (CARD_RUNTIME_HEADROOM_BYTES,
    CARD_ALLOCATOR_HEADROOM_BYTES). PERF.md gives the lines for the H100.
    """
    dev = torch.device("cpu" if device is None else device)
    if dev.type != "cuda":
        return BudgetLines(DEFAULT_BUDGET_BYTES, DEFAULT_REJECT_BYTES,
                           DEFAULT_CATALOG_BUDGET_BYTES)
    m = int(torch.cuda.get_device_properties(dev).total_memory)
    catalog = 3 * m // 8
    return BudgetLines(m - catalog - CARD_ALLOCATOR_HEADROOM_BYTES,
                       m - CARD_RUNTIME_HEADROOM_BYTES, catalog)


def _conf_bytes(conf, key, env, default) -> int:
    v = (conf.get(key) if conf else None) or os.environ.get(env)
    return int(v) if v else int(default)


def resolve_mode(conf: Optional[dict] = None) -> str:
    v = conf.get("engine.plan_budget") if conf else None
    v = str(v or os.environ.get("NDS_PLAN_BUDGET") or "on").lower()
    if v not in MODES:
        raise ValueError(
            f"engine.plan_budget must be one of {MODES}, got {v!r}"
        )
    return v


def resolve_budget_bytes(conf: Optional[dict] = None, device=None) -> int:
    return _conf_bytes(conf, "engine.plan_budget_bytes",
                       "NDS_PLAN_BUDGET_BYTES",
                       budget_lines(device).working_set)


def resolve_reject_bytes(conf: Optional[dict] = None, device=None) -> int:
    return _conf_bytes(conf, "engine.plan_budget_reject_bytes",
                       "NDS_PLAN_BUDGET_REJECT_BYTES",
                       budget_lines(device).reject)


def resolve_catalog_bytes(device=None) -> int:
    v = os.environ.get("NDS_CATALOG_BUDGET_BYTES")
    return int(v) if v else budget_lines(device).catalog


def spillable_node(v) -> bool:
    """True when a plan node owns an out-of-core rewrite the executor runs
    (exec._spilled_join / _spilled_take / _spilled_distinct): inner and
    left joins and MultiJoins (hash-partitioned build and probe), sorts
    (sorted runs), Distinct and UNION (partition-hash dedup). Semi, anti
    and full joins, the other set operations and aggregates do not
    decompose over hash partitions."""
    if isinstance(v, P.Join):
        return v.kind in ("inner", "left")
    if isinstance(v, (P.MultiJoin, P.Sort, P.Distinct)):
        return True
    if isinstance(v, P.SetOp):
        return v.op == "union"
    return False


def choose_spill_partitions(peak_bytes: int, budget_bytes: int) -> int:
    """The smallest power of two that models the dominant transient under
    the budget, clamped to [2, SPILL_MAX_PARTITIONS]."""
    ratio = max(-(-int(peak_bytes) // max(int(budget_bytes), 1)), 2)
    parts = 1 << (ratio - 1).bit_length()
    return int(min(max(parts, 2), SPILL_MAX_PARTITIONS))


def default_window_rows(row_bytes: int, budget_bytes: int) -> int:
    """Rows per blocked-union window for `row_bytes`-wide rows under a byte
    budget: 1/WINDOW_BUDGET_FRACTION of the budget, rounded down to a power
    of two, clamped to [64Ki, 16Mi] rows. The session's runtime sizing
    (Session.union_agg_window_rows) and the static verdict share it."""
    budget = budget_bytes // WINDOW_BUDGET_FRACTION
    rows = max(budget // max(row_bytes, 1), 1)
    pow2 = 1 << (rows.bit_length() - 1)
    return int(min(max(pow2, 1 << 16), 1 << 24))


def derive_share_bytes(total_bytes: int, fraction: int,
                       lo: int, hi: int) -> int:
    """A byte budget as 1/`fraction` of a measured resource, rounded down
    to a power of two and clamped to [lo, hi] (the spill pool's `auto`
    host-RAM share)."""
    share = max(int(total_bytes) // max(int(fraction), 1), 1)
    pow2 = 1 << (share.bit_length() - 1)
    return int(min(max(pow2, lo), hi))


#: serve mode's admission sizing: one admitted request is assumed to hold
#: up to this much device working set beyond the catalog's residency, so
#: slots = working-set line // this keeps full occupancy inside the line a
#: single statement is admitted against
SERVE_SLOT_BYTES = 1 << 30


def serve_concurrency(conf: Optional[dict] = None, device=None) -> int:
    """Admission slots (the worker bound) of serve/service.py's
    QueryService: `engine.serve_workers` / NDS_SERVE_WORKERS, else one
    slot per SERVE_SLOT_BYTES of the working-set line the budgeter admits
    statements against (resolve_budget_bytes on `device`), clamped to
    [1, 16]. A CPU session's default 4 GiB line carries 4 requests, as the
    reference's does."""
    v = None
    if conf:
        v = conf.get("engine.serve_workers")
    if v is None:
        v = os.environ.get("NDS_SERVE_WORKERS")
    if v:
        try:
            return max(int(v), 1)
        except (TypeError, ValueError):
            pass
    budget = resolve_budget_bytes(conf, device)
    return int(min(max(budget // SERVE_SLOT_BYTES, 1), 16))


def host_ram_bytes() -> int:
    """Physical host RAM in bytes (sysconf), or 16 GiB where the counters
    are missing."""
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page = os.sysconf("SC_PAGE_SIZE")
        if pages > 0 and page > 0:
            return int(pages) * int(page)
    except (ValueError, OSError, AttributeError):
        pass
    return 16 << 30


#: TPC-DS column-name prefix -> owning table (longest match wins). A
#: column cannot carry more distinct values than its owning table has rows:
#: a sound static NDV bound for group keys.
_COL_PREFIX_TABLE = {
    "ss_": "store_sales", "sr_": "store_returns",
    "cs_": "catalog_sales", "cr_": "catalog_returns",
    "ws_": "web_sales", "wr_": "web_returns", "inv_": "inventory",
    "d_": "date_dim", "t_": "time_dim",
    "c_": "customer", "ca_": "customer_address",
    "cd_": "customer_demographics", "hd_": "household_demographics",
    "ib_": "income_band", "i_": "item", "p_": "promotion",
    "r_": "reason", "s_": "store", "sm_": "ship_mode",
    "w_": "warehouse", "wp_": "web_page", "web_": "web_site",
    "cc_": "call_center", "cp_": "catalog_page",
}

#: foreign-key suffix -> referenced dimension (a FK column's distinct
#: values are bounded by the referenced table's rows)
_FK_SUFFIX_TABLE = {
    "_item_sk": "item", "_date_sk": "date_dim", "_time_sk": "time_dim",
    "_customer_sk": "customer", "_store_sk": "store",
    "_warehouse_sk": "warehouse", "_promo_sk": "promotion",
    "_cdemo_sk": "customer_demographics",
    "_hdemo_sk": "household_demographics", "_addr_sk": "customer_address",
    "_web_page_sk": "web_page", "_web_site_sk": "web_site",
    "_call_center_sk": "call_center", "_catalog_page_sk": "catalog_page",
    "_ship_mode_sk": "ship_mode", "_reason_sk": "reason",
}


def column_owner_table(col_name: str) -> Optional[str]:
    """The TPC-DS table a column name belongs to by prefix convention
    ("store.s_store_id" -> "store"), or None for derived names."""
    bare = col_name.split(".")[-1]
    best = None
    for pref, table in _COL_PREFIX_TABLE.items():
        if bare.startswith(pref) and (best is None or len(pref) > len(best[0])):
            best = (pref, table)
    return best[1] if best else None


def column_domain_table(col_name: str) -> Optional[str]:
    """The table bounding a column's distinct-value count: the referenced
    dimension for FK-suffixed columns (ss_item_sk -> item), else the
    owning table by prefix."""
    bare = col_name.split(".")[-1]
    for suf, table in _FK_SUFFIX_TABLE.items():
        if bare.endswith(suf):
            return table
    return column_owner_table(col_name)


# ---------------------------------------------------------------------------
# catalog cardinality source
# ---------------------------------------------------------------------------


class CatalogStats:
    """Base-table row counts for the budgeter, best source first: the rows
    of a table already on the device, of a `table_from_numpy` table, of an
    in-memory Arrow table, of a parquet or orc dataset's metadata, of a
    lakehouse table's manifest; then the TPC-DS
    scale model when a scale factor is declared (conf
    `engine.plan_budget_sf`); else None (unknown)."""

    def __init__(self, catalog, scale_factor: Optional[float] = None):
        self.catalog = catalog
        self.scale_factor = scale_factor

    def table_rows(self, name: str) -> Optional[int]:
        e = self.catalog.entries.get(name) if self.catalog else None
        if e is not None:
            if e.nrows is not None:
                return int(e.nrows)
            if e.table is not None:
                return int(e.table.nrows)
            if e.arrow is not None:
                return int(e.arrow.num_rows)
            if getattr(e, "fmt", None) in ("parquet", "orc", "lakehouse"):
                # memoized metadata count; a failed probe is memoized as
                # -1 and falls through to the scale model. A lakehouse
                # table answers from its manifest (the pinned snapshot,
                # else the head), so a cold lakehouse warehouse still gets
                # enforceable verdicts
                if e.budget_est_rows is None:
                    try:
                        if e.fmt == "lakehouse":
                            snap = e.pinned_snapshot
                            if snap is None:
                                from ..lakehouse.table import LakehouseTable

                                snap = LakehouseTable(e.path).snapshot()
                            e.budget_est_rows = int(snap.num_rows())
                        else:
                            e.budget_est_rows = int(
                                self.catalog._dataset(e).count_rows())
                    except Exception:
                        e.budget_est_rows = -1
                if e.budget_est_rows >= 0:
                    return e.budget_est_rows
        if self.scale_factor is not None:
            return spec_table_rows(name, self.scale_factor)
        return None


# ---------------------------------------------------------------------------
# selectivity heuristics
# ---------------------------------------------------------------------------

_SEL_EQ = 0.1
_SEL_RANGE = 0.4
_SEL_BETWEEN = 0.3
_SEL_LIKE = 0.25
_SEL_NULL = 0.1
_SEL_FLOOR = 0.02  # conjunction floor: heuristics must not promise miracles


def selectivity(e) -> float:
    """Heuristic fraction of rows a predicate keeps, in [_SEL_FLOOR, 1]:
    coarse and floor-clamped, since the budgeter needs an upper bound."""
    return max(_SEL_FLOOR, min(_raw_sel(e), 1.0))


def _raw_sel(e) -> float:
    if isinstance(e, E.BinOp):
        if e.op == "and":
            return max(_raw_sel(e.left) * _raw_sel(e.right), _SEL_FLOOR)
        if e.op == "or":
            return min(_raw_sel(e.left) + _raw_sel(e.right), 1.0)
        if e.op == "=":
            return _SEL_EQ
        if e.op in ("<", "<=", ">", ">="):
            return _SEL_RANGE
        if e.op in ("<>", "!="):
            return 0.9
        return 1.0
    if isinstance(e, E.Between):
        return _SEL_BETWEEN
    if isinstance(e, E.InList):
        return min(_SEL_EQ * max(len(e.values), 1), 0.6)
    if isinstance(e, E.Like):
        return _SEL_LIKE
    if isinstance(e, E.UnaryOp):
        if e.op == "not":
            return max(1.0 - _raw_sel(e.operand), _SEL_FLOOR)
        if e.op == "isnull":
            return _SEL_NULL
        if e.op == "isnotnull":
            return 1.0
    return 1.0


# ---------------------------------------------------------------------------
# the analyzer
# ---------------------------------------------------------------------------


class PlanBudgetError(Exception):
    """Admission control: the plan's modeled peak exceeds the reject line
    even under windowed execution (deterministic for a given catalog)."""

    def __init__(self, peak_bytes: int, budget_bytes: int, detail: str = ""):
        self.peak_bytes = peak_bytes
        self.budget_bytes = budget_bytes
        super().__init__(
            f"plan rejected by admission control: modeled peak "
            f"{peak_bytes / (1 << 30):.2f} GiB exceeds the "
            f"{budget_bytes / (1 << 30):.2f} GiB plan budget"
            + (f" ({detail})" if detail else "")
        )


@dataclass
class NodeEstimate:
    """Per-node static estimate. `alloc_bytes` is what executing this node
    materializes (output buffers and transient work: key words, pair
    gathers, sort scratch); `live_bytes` what its result pins for its
    parent; `peak_bytes` the modeled high-water of the whole subtree
    (children retained while later siblings and the parent run)."""

    node: object
    desc: str
    rows: int
    width: int
    cap: int
    alloc_bytes: int
    live_bytes: int
    peak_bytes: int
    blocked: bool = False
    children: list = field(default_factory=list)


@dataclass
class PlanBudget:
    """The analyzer's statement-level result."""

    nodes: list  # post-order NodeEstimate list
    peak_bytes: int  # modeled peak, blocked-union aggregates direct
    peak_blocked_bytes: int  # modeled peak with blocked aggregates windowed
    budget_bytes: int
    verdict: str  # direct | blocked | spill | over | reject | unknown
    window_rows: Optional[int] = None  # set when verdict == blocked
    unknown_tables: list = field(default_factory=list)
    #: the plan carries >= 1 out-of-core seam (spillable_node), recorded
    #: for every verdict
    spillable: bool = False
    spill_partitions: Optional[int] = None  # set when verdict == spill
    #: nodes whose static row estimate a recorded actual replaced
    #: (engine.plan_feedback=on; 0 = the pure static model)
    feedback_overrides: int = 0

    def table(self, limit: int = 0) -> str:
        """The per-node estimate table and the verdict line, as the
        reference prints them (explain --budget); the single-device model
        has no sharded node and no per-device verdict."""
        rows = self.nodes if not limit else self.nodes[-limit:]
        out = [
            f"{'rows':>12}  {'width':>6}  {'cap':>12}  {'alloc':>10}  "
            f"{'peak':>10}  node"
        ]
        for n in rows:
            out.append(
                f"{n.rows:>12}  {n.width:>6}  {n.cap:>12}  "
                f"{_fmt_bytes(n.alloc_bytes):>10}  "
                f"{_fmt_bytes(n.peak_bytes):>10}  "
                f"{'[blocked] ' if n.blocked else ''}{n.desc[:72]}"
            )
        out.append(
            f"verdict: {self.verdict}  peak={_fmt_bytes(self.peak_bytes)}"
            f" (windowed={_fmt_bytes(self.peak_blocked_bytes)})"
            f" budget={_fmt_bytes(self.budget_bytes)}"
            + (f" window_rows={self.window_rows}" if self.window_rows else "")
            + (
                f" spill_partitions={self.spill_partitions}"
                if self.spill_partitions
                else ""
            )
            + (
                f" unknown_tables={sorted(set(self.unknown_tables))}"
                if self.unknown_tables
                else ""
            )
        )
        return "\n".join(out)


def _fmt_bytes(b: int) -> str:
    if b >= 1 << 30:
        return f"{b / (1 << 30):.2f}G"
    if b >= 1 << 20:
        return f"{b / (1 << 20):.1f}M"
    if b >= 1 << 10:
        return f"{b / (1 << 10):.1f}K"
    return str(int(b))



def emit_budget_event(tracer, pb: PlanBudget) -> None:
    """The one `plan_budget` event payload (the EVENT_SCHEMA contract),
    shared by the plan-time hook and the explain CLI. No-op without a
    tracer. `mesh_devices` is None: the single-device model."""
    if tracer is None:
        return
    tracer.emit(
        "plan_budget",
        verdict=pb.verdict,
        peak_bytes=pb.peak_bytes,
        budget_bytes=pb.budget_bytes,
        peak_blocked_bytes=pb.peak_blocked_bytes,
        window_rows=pb.window_rows,
        spill_partitions=pb.spill_partitions,
        mesh_devices=None,
        nodes=len(pb.nodes),
    )


class PlanBudgeter:
    """Walks a bound plan bottom-up, producing NodeEstimates.

    Schemas come from the PlanVerifier's memoized static dtype inference,
    so the byte model and the schema rules never disagree about a node's
    columns. Estimates memoize by node id: a shared subtree (a CTE
    diamond) costs one walk, and its live bytes count at each consumer,
    which is what the executor's _cte_cache does to memory."""

    def __init__(self, catalog=None, stats: Optional[CatalogStats] = None,
                 budget_bytes: Optional[int] = None, windowed: bool = False,
                 feedback=None):
        self.stats = stats or CatalogStats(catalog)
        self.budget_bytes = (
            budget_bytes if budget_bytes is not None else DEFAULT_BUDGET_BYTES
        )
        #: windowed=True models blocked-union aggregates on the windowed
        #: executor path instead of the direct full-concat path
        self.windowed = windowed
        self._ver = _verifier.PlanVerifier(catalog)
        self._memo: dict = {}
        self._post: list = []
        self.unknown_tables: list = []
        #: statically derived window rows per blocked aggregate modeled in
        #: windowed mode (the plan's window is the least of these)
        self.blocked_windows: list = []
        #: measured-cardinality overrides (engine.plan_feedback=on):
        #: {id(node): recorded actual rows} from the FeedbackStore. None
        #: (or empty) keeps the static model byte-identical; applied
        #: overrides are collected for the plan_feedback event
        self.feedback = feedback or None
        self.feedback_applied: list = []

    # -- entry ----------------------------------------------------------
    def run(self, root: P.PlanNode) -> int:
        """Walk the plan; return the modeled peak bytes. Scalar subquery
        plans execute as separate statements before the main plan, so
        their peaks are independent candidates."""
        peak = self._est(root).peak_bytes
        for sub in self._subquery_plans(root):
            peak = max(peak, self._est(sub).peak_bytes)
        return peak

    def _subquery_plans(self, root):
        return [
            v.plan
            for v in P.walk_plan(root)
            if isinstance(v, E.ScalarSubquery) and v.plan is not None
        ]

    # -- helpers --------------------------------------------------------
    def _schema(self, node) -> dict:
        sch = self._ver._schema_of(node)
        return sch if sch is not None else {}

    def _width(self, node) -> int:
        return schema_row_bytes(self._schema(node))

    def _finish(self, node, rows, width, alloc, children,
                live=None, blocked=False) -> NodeEstimate:
        rows = max(int(rows), 0)
        fb = self.feedback.get(id(node)) if self.feedback else None
        if fb is not None:
            # measured actual overrides the static estimate (clamped: the
            # recorded value is the observed MAXIMUM, so the new estimate
            # is never below anything this node has produced). Allocation
            # scales with the capacity bucket ratio (the per-rule alloc
            # terms are cap-proportional), and children's own overrides
            # were already applied bottom-up
            fb = max(int(fb), 0)
            if fb != rows:
                old_cap = bucket_cap(max(rows, 1))
                new_cap = bucket_cap(max(fb, 1))
                if new_cap != old_cap:
                    alloc = int(alloc * (new_cap / old_cap))
                    if live is not None:
                        live = int(live * (new_cap / old_cap))
                rows = fb
                self.feedback_applied.append(node)
        cap = bucket_cap(max(rows, 1))
        live_b = live if live is not None else cap * width
        # executor retention model: children run left to right, each
        # earlier child's result stays live while later siblings execute,
        # and all children stay live while this node materializes
        peak = 0
        acc = 0
        for c in children:
            peak = max(peak, acc + c.peak_bytes)
            acc += c.live_bytes
        peak = max(peak, acc + alloc)
        est = NodeEstimate(
            node=node,
            desc=P.node_desc(node),
            rows=rows,
            width=width,
            cap=cap,
            alloc_bytes=int(alloc),
            live_bytes=int(live_b),
            peak_bytes=int(peak),
            blocked=blocked,
        )
        self._post.append(est)
        return est

    def _est(self, node) -> NodeEstimate:
        if node is None:
            return NodeEstimate(None, "missing", 0, 1, _MIN_CAP, 0, 0, 0)
        key = id(node)
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        m = getattr(self, f"_est_{type(node).__name__.lower()}", None)
        if m is None:
            est = self._finish(node, 1, self._width(node), 0, [])
        else:
            est = m(node)
        self._memo[key] = est
        return est

    # -- per-node rules (mirror the executors' materialization) ----------
    def _est_scan(self, node: P.Scan) -> NodeEstimate:
        rows = self.stats.table_rows(node.table)
        # the zone-map surviving-row bound (Session._prune_lake_scans): a
        # hard upper bound from the pinned manifest's per-file stats,
        # tighter than any table-level estimate whenever pruning fired
        prune_rows = getattr(node, "prune_rows", None)
        if prune_rows is not None:
            rows = prune_rows if rows is None else min(rows, prune_rows)
        if rows is None:
            self.unknown_tables.append(node.table)
            rows = 0
        width = self._width(node)
        cap = bucket_cap(max(rows, 1))
        return self._finish(node, rows, width, cap * width, [])

    def _est_materializedscan(self, node: P.MaterializedScan) -> NodeEstimate:
        rows = 1
        if node.table is not None:
            known = node.table.nrows_known
            rows = known if known is not None else int(node.table.cap)
        width = self._width(node)
        # already materialized: no new allocation, but it is live input
        return self._finish(node, rows, width, 0, [])

    def _est_project(self, node: P.Project) -> NodeEstimate:
        child = self._est(node.child)
        sch = self._schema(node)
        width = schema_row_bytes(sch)
        computed = sum(
            column_row_bytes(dt)
            for (e, _name), dt in zip(node.items, sch.values())
            if not isinstance(e, E.Col)
        )
        return self._finish(node, child.rows, width, child.cap * computed,
                            [child])

    def _est_filter(self, node: P.Filter) -> NodeEstimate:
        child = self._est(node.child)
        rows = int(math.ceil(child.rows * selectivity(node.predicate)))
        # deferred compaction: the live mask is the only new buffer; data
        # buffers are shared with the child (capacity stays the child's)
        return self._finish(node, rows, child.width, child.cap, [child],
                            live=child.cap * child.width)

    def _est_pipeline(self, node: P.Pipeline) -> NodeEstimate:
        child = self._est(node.child)
        rows = child.rows
        for s in node.stages:
            if isinstance(s, P.Filter):
                rows = int(math.ceil(rows * selectivity(s.predicate)))
        if node.agg is not None:
            # the fused call runs the chain AND the partial-aggregate
            # scatter over the chain INPUT (masks deferred to the end), so
            # the key / sort-word working set scales with the child's
            # capacity, not the post-filter estimate
            return self._agg_estimate(node, node.agg, [child], rows,
                                      child.cap)
        width = self._width(node)
        # the fused call holds the full output column set at the input
        # capacity (masks deferred to the end)
        return self._finish(node, rows, width, child.cap * width, [child])

    def _keys_unique(self, side, keys) -> bool:
        """True when `keys` cover a declared primary key of the side's base
        table (a Scan reached through Filter/Project/Pipeline wrappers):
        the static stand-in for the runtime unique-key probe."""
        _, base = P._peel_wrappers(side)
        if not isinstance(base, P.Scan):
            return False
        pk = TABLE_PRIMARY_KEYS.get(base.table)
        if pk is None:
            return False
        names = set()
        for k in keys:
            for c in E.walk(k):
                if isinstance(c, E.Col):
                    names.add(c.name.split(".")[-1])
        return set(pk) <= names

    def _est_join(self, node: P.Join) -> NodeEstimate:
        left = self._est(node.left)
        right = self._est(node.right)
        if node.kind == "cross":
            rows = max(left.rows, 1) * max(right.rows, 1)
        elif node.kind in ("semi", "anti", "mark"):
            rows = left.rows
        elif self._keys_unique(node.right, node.right_keys):
            rows = left.rows
        elif self._keys_unique(node.left, node.left_keys):
            rows = right.rows
        else:
            rows = max(left.rows, right.rows)
        width = self._width(node)
        cap = bucket_cap(max(rows, 1))
        # key words (8 B per side) + compaction of both inputs + the pair
        # table gathered at the output width
        alloc = (
            8 * left.cap + left.cap * left.width
            + 8 * right.cap + right.cap * right.width
            + cap * width
        )
        return self._finish(node, rows, width, alloc, [left, right])

    def _est_multijoin(self, node: P.MultiJoin) -> NodeEstimate:
        rels = [self._est(r) for r in node.relations]
        width = self._width(node)
        # greedy pairwise joins: output rows bounded by the largest
        # non-unique (fact-like) relation; a relation whose edges cover its
        # base table's primary key matches at most one row per probe and
        # never expands the join; the last two pair tables carry about the
        # full accumulated width
        edge_cols = [set() for _ in node.relations]
        for i, j, le, re_ in node.edges:
            for idx, e in ((i, le), (j, re_)):
                if 0 <= idx < len(edge_cols):
                    for c in E.walk(e):
                        if isinstance(c, E.Col):
                            edge_cols[idx].add(c.name.split(".")[-1])
        non_unique = []
        for i, r in enumerate(node.relations):
            _, base = P._peel_wrappers(r)
            pk = (
                TABLE_PRIMARY_KEYS.get(base.table)
                if isinstance(base, P.Scan)
                else None
            )
            if pk is None or not set(pk) <= edge_cols[i]:
                non_unique.append(rels[i].rows)
        rows = max(non_unique or [r.rows for r in rels] or [1])
        cap = bucket_cap(max(rows, 1))
        alloc = 2 * cap * width + sum(8 * r.cap for r in rels)
        return self._finish(node, rows, width, alloc, rels)

    def _agg_groups(self, agg, in_rows: int) -> int:
        """Group-count bound. Each key column's distinct values are bounded
        by its domain table's rows, and keys sharing one domain table count
        that table once; a derived key falls back to the input rows."""
        if not agg.keys:
            return 1
        in_rows = max(in_rows, 1)
        domains = {}
        for e, _name in agg.keys:
            owner = (
                column_domain_table(e.name) if isinstance(e, E.Col) else None
            )
            rows_t = self.stats.table_rows(owner) if owner else None
            if rows_t is None:
                return in_rows
            domains[owner] = max(rows_t, 1)
        prod = 1
        for rows_t in domains.values():
            prod *= rows_t
            if prod >= in_rows:
                return in_rows
        return max(min(prod, in_rows), 1)

    def _agg_estimate(self, node, agg, children, in_rows, in_cap,
                      blocked=False) -> NodeEstimate:
        sch = self._schema(node)
        width = schema_row_bytes(sch)
        groups = self._agg_groups(agg, in_rows)
        levels = min(len(agg.grouping_sets), 3) if agg.grouping_sets else 1
        rows = groups * (2 if agg.grouping_sets else 1)
        cap = bucket_cap(max(rows, 1))
        # segment-reduce path: 2 x 8 B key/sort words over the input + the
        # group output (x the cascade levels' incremental concatenation)
        alloc = 16 * in_cap + levels * cap * width
        return self._finish(node, rows, width, alloc, children,
                            blocked=blocked)

    def _est_aggregate(self, node: P.Aggregate) -> NodeEstimate:
        if node.blocked_union and self.windowed:
            shape = P.union_agg_shape(node)
            if shape is not None:
                return self._est_blocked_agg(node, shape)
        child = self._est(node.child)
        return self._agg_estimate(
            node, node, [child], child.rows, child.cap,
            blocked=bool(node.blocked_union),
        )

    def _est_blocked_agg(self, node: P.Aggregate, shape) -> NodeEstimate:
        """The windowed executor path (exec._blocked_union_ctx): the union
        branches execute and stay materialized, but the concatenation never
        happens; alignment, the dimension joins and the partial aggregate
        run per bounded window, and partials merge into group-sized tables.
        Peak = branches + dimensions + O(window x joined width) + O(3 x
        groups x output width)."""
        outer, join, inner, branch_plans = shape
        children = [self._est(b) for b in branch_plans]
        joined_width = self._width(node.child)
        branch_width = max((c.width for c in children), default=9)
        if join is not None:
            mj, uidx = join
            children += [
                self._est(r) for i, r in enumerate(mj.relations) if i != uidx
            ]
        in_rows = sum(c.rows for c in children[: len(branch_plans)])
        row_bytes = max(branch_width, joined_width)
        wrows = default_window_rows(row_bytes, self.budget_bytes)
        self.blocked_windows.append(wrows)
        wcap = bucket_cap(wrows)
        groups = self._agg_groups(node, in_rows)
        out_width = self._width(node)
        gcap = bucket_cap(max(groups, 1))
        # aligned window slice + per-window join pair/wrapped output + key
        # words, plus merged/part/concat group tables
        alloc = wcap * (branch_width + joined_width + 16) + 3 * gcap * out_width
        levels = min(len(node.grouping_sets), 3) if node.grouping_sets else 1
        rows = groups * (2 if node.grouping_sets else 1)
        return self._finish(node, rows, out_width, alloc * min(levels, 2),
                            children, blocked=True)

    def _est_window(self, node: P.Window) -> NodeEstimate:
        child = self._est(node.child)
        width = self._width(node)
        alloc = 16 * child.cap + 8 * child.cap * max(len(node.fns), 1)
        return self._finish(node, child.rows, width, alloc, [child])

    def _est_sort(self, node: P.Sort) -> NodeEstimate:
        child = self._est(node.child)
        width = child.width
        alloc = 16 * child.cap + child.cap * width
        return self._finish(node, child.rows, width, alloc, [child])

    def _est_limit(self, node: P.Limit) -> NodeEstimate:
        child = self._est(node.child)
        rows = min(child.rows, max(int(node.n), 0))
        return self._finish(node, rows, child.width, 0, [child])

    def _est_distinct(self, node: P.Distinct) -> NodeEstimate:
        child = self._est(node.child)
        alloc = 16 * child.cap + child.cap * child.width
        return self._finish(node, child.rows, child.width, alloc, [child])

    def _est_setop(self, node: P.SetOp) -> NodeEstimate:
        left = self._est(node.left)
        right = self._est(node.right)
        width = self._width(node)
        rows = left.rows + right.rows
        if node.op in ("intersect", "except"):
            rows = left.rows
        cap = bucket_cap(max(rows, 1))
        # the concatenation materializes both sides into one capacity
        # bucket; distinct set operations add a sort-words pass
        alloc = cap * width + (16 * cap if node.op != "union_all" else 0)
        if node.op == "union":
            rows = max(rows // 2, 1)
        return self._finish(node, rows, width, alloc, [left, right])


# ---------------------------------------------------------------------------
# statement-level entry points
# ---------------------------------------------------------------------------


def analyze_plan(
    plan: P.PlanNode,
    catalog=None,
    scale_factor: Optional[float] = None,
    budget_bytes: Optional[int] = None,
    reject_bytes: Optional[int] = None,
    feedback=None,
) -> PlanBudget:
    """Analyze one bound plan against a catalog (or the TPC-DS scale model
    when `scale_factor` is given): a direct-path pass, a windowed pass when
    the plan carries blocked-union aggregates, and the verdict folding both
    against the two lines (the module docstring lists the verdicts). The
    lines default to the reference's constants.

    `feedback` ({id(node): recorded actual rows}, engine.plan_feedback=on)
    replaces static per-node row estimates with measured cardinalities
    before verdict folding; None (the default) is the static model."""
    stats = CatalogStats(catalog, scale_factor)
    direct = PlanBudgeter(catalog, stats, budget_bytes, windowed=False,
                          feedback=feedback)
    peak = direct.run(plan)
    budget = direct.budget_bytes
    reject_line = (
        reject_bytes if reject_bytes is not None else DEFAULT_REJECT_BYTES
    )
    has_blocked = any(e.blocked for e in direct._post)
    peak_blocked = peak
    window_rows = None
    if has_blocked:
        win = PlanBudgeter(catalog, stats, budget_bytes, windowed=True,
                           feedback=feedback)
        peak_blocked = min(win.run(plan), peak)
        if win.blocked_windows:
            window_rows = min(win.blocked_windows)
    spillable = any(
        spillable_node(v)
        for v in P.walk_plan(plan)
        if isinstance(v, P.PlanNode)
    )
    spill_partitions = None
    if direct.unknown_tables:
        verdict = "unknown"
        window_rows = None
    elif peak <= budget:
        verdict = "direct"
        window_rows = None
    elif has_blocked and peak_blocked <= budget:
        verdict = "blocked"
    elif min(peak_blocked, peak) <= reject_line:
        # admitted over budget: with an out-of-core seam the overage
        # partitions away through the executor's spilled paths, with the
        # partition count chosen here; seamless plans stay `over`
        if spillable:
            verdict = "spill"
            spill_partitions = choose_spill_partitions(
                min(peak_blocked, peak), budget
            )
        else:
            verdict = "over"
        window_rows = window_rows if has_blocked else None
    else:
        verdict = "reject"
        window_rows = None
    return PlanBudget(
        nodes=list(direct._post),
        peak_bytes=peak,
        peak_blocked_bytes=peak_blocked,
        budget_bytes=budget,
        verdict=verdict,
        window_rows=window_rows,
        unknown_tables=list(direct.unknown_tables),
        spillable=spillable,
        spill_partitions=spill_partitions,
        feedback_overrides=len(direct.feedback_applied),
    )


def budget_plan(plan: P.PlanNode, session) -> Optional[PlanBudget]:
    """The Session's plan-time hook: analyze, annotate, enforce.

    * verdict `blocked` (or `spill` / `over` with a window): annotates
      every blocked-union Aggregate with `budget_window_rows`;
    * verdict `spill`: annotates `spill_partitions` on the spillable nodes
      (the executor's `auto` spill mode runs exactly those);
    * verdict `reject` in mode `on`: raises PlanBudgetError;
    * records the result on `session.last_plan_budget` (the JAX session's
      keys; the device-OOM ladder of ROADMAP.md queue 1 item 9 reads it);
    * with a feedback store and `engine.plan_feedback` record / on:
      annotates each node's store key (`node_fp`) and static estimates
      (`est_rows`, `est_live_bytes`) for the executor to record against,
      consumes recorded actuals as estimate overrides in mode `on`, and
      emits a `plan_feedback` event.

    Returns None, and does nothing, when the budgeter is off. An analysis
    failure is recorded as `verdict="error"` instead of failing the
    statement, unless NDS_PLAN_BUDGET_STRICT is set (the port's tests and
    chip_smoke.py set it, so a budgeter fault shows)."""
    mode = resolve_mode(session.conf)
    if mode == "off":
        session.last_plan_budget = None
        return None
    sf = session.conf.get("engine.plan_budget_sf")
    # cardinality feedback (analysis/feedback.py): compute this plan's
    # per-node store keys once, consume recorded actuals as estimate
    # overrides in mode `on`, and (below) annotate node_fp / est_rows onto
    # the nodes so the executor can record what actually happened. Store
    # absent or mode off: fb_fps stays None and nothing changes
    fb_store = getattr(session, "feedback_store", None)
    fb_mode = "off"
    fb_fps = None
    fb_overrides = None
    if fb_store is not None:
        fb_mode = _feedback.resolve_feedback_mode(session.conf)
    if fb_mode != "off":
        try:
            fb_fps = _feedback.plan_node_fps(plan, session)
        except Exception:
            if os.environ.get("NDS_PLAN_BUDGET_STRICT"):
                raise
            fb_fps = None
        if fb_fps and fb_mode == "on":
            fb_overrides = {}
            with session.cache_lock:
                for nid, fp in fb_fps.items():
                    rec = fb_store.lookup(fp)
                    rows = (rec or {}).get("rows") or {}
                    if rows.get("max") is not None:
                        fb_overrides[nid] = int(rows["max"])
    try:
        pb = analyze_plan(
            plan,
            session.catalog,
            scale_factor=float(sf) if sf else None,
            budget_bytes=resolve_budget_bytes(session.conf, session.device),
            reject_bytes=resolve_reject_bytes(session.conf, session.device),
            feedback=fb_overrides,
        )
    except Exception as exc:
        if os.environ.get("NDS_PLAN_BUDGET_STRICT"):
            raise
        session.last_plan_budget = {"verdict": "error", "error": str(exc)}
        session.notify_failure(f"plan budgeter failed: {str(exc)[:200]}")
        return None
    emit_budget_event(getattr(session, "tracer", None), pb)
    if fb_fps:
        # annotate estimate accounting onto the plan (the same dynamic-
        # annotation family as budget_window_rows: not dataclass fields, so
        # structural fingerprints and the plan cache stay feedback-
        # agnostic). The executor reads these to emit op_span est-vs-actual
        # fields and to record into the store
        for est in pb.nodes:
            fp = fb_fps.get(id(est.node))
            if fp is None:
                continue
            est.node.node_fp = fp
            est.node.est_rows = est.rows
            est.node.est_live_bytes = est.live_bytes
        tracer = getattr(session, "tracer", None)
        if tracer is not None:
            tracer.emit(
                "plan_feedback",
                op="consume" if fb_mode == "on" else "annotate",
                result="applied" if pb.feedback_overrides else "static",
                mode=fb_mode,
                lookups=len(fb_fps) if fb_mode == "on" else 0,
                hits=len(fb_overrides or {}),
                overrides=pb.feedback_overrides,
                verdict=pb.verdict,
            )
    # `warn` is observe-only: record, but never annotate or reject
    annotate = (
        mode == "on"
        and pb.window_rows is not None
        and pb.verdict in ("blocked", "spill", "over")
    )
    # an explicit conf/env window eclipses the annotation at execution
    # (Session.union_agg_window_rows), so the static window is in effect
    # only when nothing explicit is set
    explicit = session.conf.get(
        "engine.union_agg_window_rows"
    ) or os.environ.get("NDS_UNION_AGG_WINDOW_ROWS")
    session.last_plan_budget = {
        "verdict": pb.verdict,
        "peak_bytes": pb.peak_bytes,
        "budget_bytes": pb.budget_bytes,
        "window_rows": pb.window_rows,
        "mesh_devices": None,  # the single-device model
        "annotated": annotate and not explicit,
        "spillable": pb.spillable,
        "spill_partitions": pb.spill_partitions,
        # estimate-vs-actual accounting: the feedback mode this statement
        # planned under, how many store hits were consulted and how many
        # static estimates a recorded actual replaced
        "feedback_mode": fb_mode,
        "feedback_hits": len(fb_overrides or {}),
        "feedback_overrides": pb.feedback_overrides,
    }
    if annotate:
        _annotate_blocked_windows(plan, pb.window_rows)
    if mode == "on" and pb.verdict == "spill" and pb.spill_partitions:
        _annotate_spill(plan, pb.spill_partitions)
    if pb.verdict == "reject" and mode == "on":
        raise PlanBudgetError(
            pb.peak_bytes, pb.budget_bytes,
            detail="no blocked-union seam can window the overage",
        )
    return pb


def _annotate_blocked_windows(plan: P.PlanNode, window_rows: int):
    """Set `budget_window_rows` (a dynamic annotation, not a dataclass
    field, so plan fingerprints stay window-agnostic) on every
    blocked-union Aggregate in the tree."""
    for v in P.walk_plan(plan):
        if isinstance(v, P.Aggregate) and v.blocked_union:
            v.budget_window_rows = int(window_rows)


def _annotate_spill(plan: P.PlanNode, partitions: int):
    """Set `spill_partitions` (the same dynamic-annotation family) on every
    out-of-core-capable node; the executor's `auto` spill mode consumes it
    (exec._spill_parts_for)."""
    for v in P.walk_plan(plan):
        if isinstance(v, P.PlanNode) and spillable_node(v):
            v.spill_partitions = int(partitions)


# The verifier imports this module's SPILL_MAX_PARTITIONS and
# spillable_node, so it is bound last, as a module: imported here it is
# paid once at import and not inside the first statement's wall, which
# no span covers (the first budgeter built would otherwise import it).
from . import verifier as _verifier  # noqa: E402

"""All 99 TPC-DS templates through nds_tpu_torch against the JAX package.

The repo's own generator (nds_tpu.cli.gen_data) writes SF0.01 data into a
fresh temporary directory of this module; both engines read the same Arrow
tables (nds_tpu.io.csv.read_dat_dir). Each template is instantiated as the
reference test_query_streams does (seed 1000 + its number) and runs through
the JAX package's Session (CPU; no AOT cache; its cross-statement plan
cache off, so that a two-statement template executes every node in both
engines) and the port's Session(device="cpu"), with chip_smoke.branch_spy
on both executors: the joins, set operations, DISTINCT, distinct
aggregates, windows, grouping sets, grouping() and blocked union levels
must take the same branches, and the last statement's results must agree.

Tolerance: integers, dates and strings EXACTLY; floats within
nds_tpu.validate.compare's 1e-5 relative epsilon. Results are compared as
row multisets (rows tied at an ORDER BY ... LIMIT cut are the same rows in
both engines only because both sorts are stable).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nds_tpu.datagen import query_streams as QS
from nds_tpu.engine.sql.parser import parse_script as jax_parse
from nds_tpu.io.csv import read_dat_dir
from nds_tpu.schema import get_schemas as jax_schemas
from nds_tpu_torch.engine.sql.parser import parse_script as torch_parse
from nds_tpu_torch.schema import get_schemas as torch_schemas

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import CS, assert_same, strict_budget  # noqa: E402,F401
from torch_parity import session_pair  # noqa: E402
from torch_window_cases import structural  # noqa: E402

from nds_tpu.engine import exec as JX  # noqa: E402
from nds_tpu_torch.engine import exec as TX  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEMPLATES = QS.available_templates()


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    data = tmp_path_factory.mktemp("nds_sf001")
    subprocess.run(
        [sys.executable, "-m", "nds_tpu.cli.gen_data", "--scale", "0.01",
         "--parallel", "2", "--data_dir", str(data), "--overwrite_output"],
        check=True, capture_output=True, cwd=ROOT,
    )
    js, ts = jax_schemas(), torch_schemas()
    j, t = session_pair({}, {"engine.plan_cache": "off"})
    for name, schema in js.items():
        path = os.path.join(data, name)
        if os.path.isdir(path):
            arrow = read_dat_dir(path, schema, True)
            j.register_arrow(name, arrow, schema)
            t.register_arrow(name, arrow, ts[name])
    return j, t


def _run(session, parse, executor_cls, sql):
    events = []
    restore = CS.branch_spy(executor_cls, events)
    out = None
    try:
        for stmt in parse(sql):
            res = session.run_stmt(stmt)
            if res is not None:
                out = res.collect()
    finally:
        restore()
    return out, events


def test_every_template_is_here():
    assert TEMPLATES == list(range(1, 100))


@pytest.mark.parametrize("qnum", TEMPLATES)
def test_template_matches_jax(engines, qnum):
    j, t = engines
    sql = QS.instantiate(qnum, np.random.default_rng(1000 + qnum), 0.01)
    a, ev_j = _run(j, jax_parse, JX.Executor, sql)
    b, ev_t = _run(t, torch_parse, TX.Executor, sql)
    assert structural(ev_t) == structural(ev_j), (ev_j, ev_t)
    assert_same(a, b, f"query{qnum}")

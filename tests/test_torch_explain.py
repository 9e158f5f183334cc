"""The port's explain CLI (nds_tpu_torch.cli.explain) against the JAX
package's (nds_tpu.cli.explain): the plan text, and with `--budget` the
per-node estimate table and the verdict line, schema-only at SF100.

The port runs with `--device cpu`, whose budget lines are the reference's
(4 GiB working set, 14 GiB reject). Both explain the plans their Sessions
make, fused by default (Pipeline nodes with their `+A` aggregate tails).

Tolerance: exact (the text, line for line, and the exit code).
"""

import os
import sys

import pytest

from nds_tpu.cli import explain as JX
from nds_tpu_torch.cli import explain as TX

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import strict_budget  # noqa: E402,F401

#: a spread of shapes: star joins, a blocked union (5), two-statement
#: templates (14, 23), rollups and windows (36, 67, 77), a correlated
#: subquery (1), the SF100 refusals (16, 93)
TEMPLATES = (1, 3, 5, 14, 16, 23, 36, 49, 67, 77, 93)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("NDS_VERIFY_PLANS", "NDS_PLAN_BUDGET_BYTES",
                "NDS_PLAN_BUDGET_REJECT_BYTES", "NDS_TRACE_DIR"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("NDS_FLIGHT_RECORDER", "off")
    orig = JX._build_session

    def uncached(args):
        s = orig(args)
        s.conf.update({"engine.plan_cache": "off"})
        return s
    monkeypatch.setattr(JX, "_build_session", uncached)


def _both(argv, capsys):
    rc_j = JX.main(list(argv))
    out_j = capsys.readouterr().out
    rc_t = TX.main(list(argv) + ["--device", "cpu"])
    out_t = capsys.readouterr().out
    return (rc_j, out_j), (rc_t, out_t)


@pytest.mark.parametrize("qnum", TEMPLATES)
def test_budget_table_and_verdict_match_jax(qnum, capsys):
    j, t = _both(["--query", str(qnum), "--budget", "--scale", "100"],
                 capsys)
    assert t[1].splitlines() == j[1].splitlines()
    assert t[0] == j[0]
    assert "verdict: " in t[1]


@pytest.mark.parametrize("argv", [
    ["--query", "3,42", "--scale", "10"],
    ["--query", "5", "--budget", "--scale", "1", "--top", "3"],
    ["--query", "14", "--budget", "--scale", "100", "--float"],
    ["--query", "3", "--budget", "--scale", "100",
     "--budget_bytes", str(100 << 30)],
    ["--sql", "select i_brand_id, count(*) c from item group by i_brand_id",
     "--budget", "--scale", "1000"],
], ids=["plans", "top", "float", "budget-bytes", "sql"])
def test_options_match_jax(argv, capsys):
    j, t = _both(argv, capsys)
    assert t == j


def test_file_matches_jax(tmp_path, capsys):
    f = tmp_path / "q.sql"
    f.write_text("select count(*) c from store_sales;\n"
                 "select d_year from date_dim where d_moy = 1;\n")
    j, t = _both(["--file", str(f), "--budget", "--scale", "100"], capsys)
    assert t == j


def test_verify_plans_all_raises_nowhere(monkeypatch, capsys):
    monkeypatch.setenv("NDS_VERIFY_PLANS", "all")
    j, t = _both(["--query", ",".join(map(str, TEMPLATES)), "--budget",
                  "--scale", "100"], capsys)
    assert t == j


def test_mesh_raises():
    with pytest.raises(NotImplementedError, match="item 13"):
        TX.main(["--query", "3", "--budget", "--mesh", "4",
                 "--device", "cpu"])


def test_runs_on_the_card_by_default(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TX.main(["--query", "3"])

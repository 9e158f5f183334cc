"""The port's query-stream generation (nds_tpu_torch.datagen.query_streams,
substitutions.py, its own copies of the 99 templates, and
nds_tpu_torch.cli.gen_query_stream) against the JAX package's.

Tolerance: exact. Each template instantiates to the same SQL text from the
same seeded generator; stream files are byte-identical; the template copies
are byte-identical to the reference's.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from nds_tpu.cli import gen_query_stream as JCLI
from nds_tpu.datagen import query_streams as JQ
from nds_tpu.datagen import substitutions as JS
from nds_tpu_torch import power as TP
from nds_tpu_torch.cli import gen_query_stream as TCLI
from nds_tpu_torch.datagen import query_streams as TQ
from nds_tpu_torch.datagen import substitutions as TS

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import strict_budget  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEMPLATES = JQ.available_templates()
SEEDS = (19620718, 10172044268)
SCALES = (1, 10, 100)
#: the templates whose entry holds two statements
TWO_PART = (14, 23, 24, 39)


def test_port_has_its_own_templates():
    assert TQ.TEMPLATE_DIR == os.path.join(
        ROOT, "nds_tpu_torch", "datagen", "templates")
    assert TQ.available_templates() == TEMPLATES == list(range(1, 100))
    assert sorted(os.listdir(TQ.TEMPLATE_DIR)) == sorted(
        os.listdir(JQ.TEMPLATE_DIR))


@pytest.mark.parametrize("q", TEMPLATES)
def test_template_copy_is_byte_identical(q):
    name = f"query{q}.tpl"
    port = open(os.path.join(TQ.TEMPLATE_DIR, name), "rb").read()
    assert port == open(os.path.join(JQ.TEMPLATE_DIR, name), "rb").read()
    assert TQ.load_template(q) == JQ.load_template(q)


@pytest.mark.parametrize("q", TEMPLATES)
def test_instantiate_matches_jax(q):
    """Two seeds at scales 1, 10 and 100, each from a fresh generator and
    from one generator shared across the scales (the draws a stream makes
    in sequence)."""
    for seed in SEEDS:
        shared_t = np.random.default_rng(seed)
        shared_j = np.random.default_rng(seed)
        for scale in SCALES:
            got = TQ.instantiate(q, np.random.default_rng([seed, scale]),
                                 scale)
            assert got == JQ.instantiate(
                q, np.random.default_rng([seed, scale]), scale)
            assert (TQ.instantiate(q, shared_t, scale)
                    == JQ.instantiate(q, shared_j, scale))


def test_parameter_generators_match_jax():
    assert sorted(TS.PARAM_GENERATORS) == sorted(JS.PARAM_GENERATORS)
    for name in ("CATEGORIES", "CLASSES", "STATES", "COUNTIES", "CITIES",
                 "COLORS"):
        assert getattr(TS, name) == getattr(JS, name), name


def test_missing_substitution_raises(tmp_path):
    (tmp_path / "query1.tpl").write_text("select [NOPE] from item")
    for mod in (TQ, JQ):
        with pytest.raises(KeyError, match="NOPE"):
            mod.instantiate(1, np.random.default_rng(0), 1, str(tmp_path))


@pytest.mark.parametrize("scale", SCALES)
def test_stream_files_match_jax(tmp_path, scale):
    """Stream files 0-2: stream 0 in template order, the others permuted,
    byte-identical to the reference's."""
    port, ref = tmp_path / "port", tmp_path / "ref"
    assert (TQ.generate_streams(str(port), 3, scale, SEEDS[1])
            == JQ.generate_streams(str(ref), 3, scale, SEEDS[1]))
    for s in range(3):
        a = (port / f"query_{s}.sql").read_bytes()
        assert a == (ref / f"query_{s}.sql").read_bytes(), s
    head = [ln for ln in (port / "query_0.sql").read_text().splitlines()
            if ln.startswith("-- start")]
    assert head[0] == "-- start query 1 in stream 0 using template query1.tpl"
    assert len(head) == 99
    perm = [ln.split("template ")[1] for ln in
            (port / "query_1.sql").read_text().splitlines()
            if ln.startswith("-- start")]
    assert sorted(perm) == sorted(f"query{q}.tpl" for q in TEMPLATES)
    assert perm != [f"query{q}.tpl" for q in TEMPLATES]


def test_stream_splits_into_103_statements(tmp_path):
    """The port's power.gen_sql_from_stream (its one splitter) makes 103
    statements of a generated stream: 99 templates, 14 / 23 / 24 / 39 in two
    parts, named as the JAX package names them."""
    from nds_tpu import power as JP

    TQ.generate_streams(str(tmp_path), 1, 10, SEEDS[0])
    path = str(tmp_path / "query_0.sql")
    got = TP.gen_sql_from_stream(path)
    assert got == JP.gen_sql_from_stream(path)
    assert len(got) == 103
    for q in TWO_PART:
        assert f"query{q}" not in got
        assert {f"query{q}_part1", f"query{q}_part2"} <= set(got)
        assert got[f"query{q}_part2"].startswith(
            f"-- start query {q} in stream 0 using template "
            f"query{q}_part2.tpl")
    assert not hasattr(TQ, "split_special_query")


@pytest.mark.parametrize("template", ["query3.tpl", "query14.tpl"])
def test_generate_single_matches_jax(tmp_path, template):
    a = TQ.generate_single(str(tmp_path / "a"), template, 10, SEEDS[0])
    b = JQ.generate_single(str(tmp_path / "b"), template, 10, SEEDS[0])
    assert os.path.basename(a) == os.path.basename(b)
    assert open(a, "rb").read() == open(b, "rb").read()
    with pytest.raises(ValueError, match="queryN.tpl"):
        TQ.generate_single(str(tmp_path), "q3.sql", 1, 1)


def test_cli_matches_jax(tmp_path):
    args = ["--scale", "10", "--streams", "2", "--rngseed", str(SEEDS[1])]
    TCLI.main(args + ["--output_dir", str(tmp_path / "t")])
    JCLI.main(args + ["--output_dir", str(tmp_path / "j")])
    for s in range(2):
        assert ((tmp_path / "t" / f"query_{s}.sql").read_bytes()
                == (tmp_path / "j" / f"query_{s}.sql").read_bytes())
    TCLI.main(["--scale", "1", "--template", "query39.tpl", "--output_dir",
               str(tmp_path / "one")])
    JCLI.main(["--scale", "1", "--template", "query39.tpl", "--output_dir",
               str(tmp_path / "one_j")])
    assert ((tmp_path / "one" / "query_39.sql").read_bytes()
            == (tmp_path / "one_j" / "query_39.sql").read_bytes())


def test_cli_template_dir(tmp_path):
    tdir = tmp_path / "tpl"
    tdir.mkdir()
    (tdir / "query7.tpl").write_text(
        open(os.path.join(TQ.TEMPLATE_DIR, "query7.tpl")).read())
    subprocess.run(
        [sys.executable, "-m", "nds_tpu_torch.cli.gen_query_stream",
         "--template_dir", str(tdir), "--scale", "1", "--output_dir",
         str(tmp_path / "out")],
        check=True, capture_output=True, cwd=ROOT)
    text = (tmp_path / "out" / "query_0.sql").read_text()
    assert text.count("-- start query") == 1
    assert "using template query7.tpl" in text

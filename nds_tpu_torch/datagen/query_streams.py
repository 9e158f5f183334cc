"""Query-stream generation, the dsqgen equivalent: the port of
nds_tpu/datagen/query_streams.py over the port's own copies of the
templates (templates/, held byte-identical to the reference's).

Substitutes seeded random parameters into the query templates under
templates/ and emits permuted query streams `query_0.sql .. query_N.sql`
(reference: nds/nds_gen_query_stream.py:42-89 forks `dsqgen -dialect spark`;
the template patch mechanism is nds/tpcds-gen/patches/templates.patch).

Stream-file format parity: every query is wrapped in
  -- start query N in stream S using template queryK.tpl
  <sql>;
  -- end query N in stream S using template queryK.tpl
which is what the Power Run driver splits on (reference: nds/nds_power.py:50-77);
power.split_special_query is the port's one splitter of two-part entries.
"""

from __future__ import annotations

import os
import re

import numpy as np

from .substitutions import PARAM_GENERATORS

TEMPLATE_DIR = os.path.join(os.path.dirname(__file__), "templates")

_PARAM_RE = re.compile(r"\[([A-Z][A-Z0-9_.]*)\]")


def available_templates(template_dir=None):
    d = template_dir or TEMPLATE_DIR
    out = []
    for f in sorted(os.listdir(d)):
        m = re.match(r"query(\d+)\.tpl$", f)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def load_template(qnum, template_dir=None):
    d = template_dir or TEMPLATE_DIR
    with open(os.path.join(d, f"query{qnum}.tpl")) as f:
        return f.read()


def instantiate(qnum, rng, scale, template_dir=None) -> str:
    """Fill one template's parameters from the seeded rng."""
    text = load_template(qnum, template_dir)
    gen = PARAM_GENERATORS.get(qnum)
    params = gen(rng, scale) if gen else {}
    missing = set()

    def sub(m):
        key = m.group(1)
        if key in params:
            return str(params[key])
        missing.add(key)
        return m.group(0)

    out = _PARAM_RE.sub(sub, text)
    if missing:
        raise KeyError(f"query{qnum}.tpl: no substitution for {sorted(missing)}")
    return out.strip().rstrip(";").strip()


def stream_permutation(qnums, rng):
    """Permuted query order for one stream (dsqgen-style per-stream shuffle)."""
    idx = rng.permutation(len(qnums))
    return [qnums[i] for i in idx]


def generate_streams(
    output_dir,
    streams: int,
    scale: float,
    rngseed: int,
    template_dir=None,
    qnums=None,
):
    """Write query_0.sql .. query_{streams-1}.sql; returns template list."""
    os.makedirs(output_dir, exist_ok=True)
    qnums = qnums or available_templates(template_dir)
    for s in range(streams):
        rng = np.random.default_rng(np.random.SeedSequence([rngseed, s]))
        order = stream_permutation(qnums, rng) if s > 0 else list(qnums)
        parts = []
        for n, q in enumerate(order):
            sql = instantiate(q, rng, scale, template_dir)
            parts.append(
                f"-- start query {n + 1} in stream {s} using template query{q}.tpl\n"
                f"{sql}\n;\n"
                f"-- end query {n + 1} in stream {s} using template query{q}.tpl\n"
            )
        with open(os.path.join(output_dir, f"query_{s}.sql"), "w") as f:
            f.write("\n".join(parts))
    return qnums


def generate_single(output_dir, template_name, scale, rngseed, template_dir=None):
    """Generate one query from one template (reference: --template flag,
    nds/nds_gen_query_stream.py:115-119)."""
    m = re.match(r"query(\d+)\.tpl$", template_name)
    if not m:
        raise ValueError(f"template name must be queryN.tpl, got {template_name}")
    q = int(m.group(1))
    os.makedirs(output_dir, exist_ok=True)
    rng = np.random.default_rng(np.random.SeedSequence([rngseed, 0]))
    sql = instantiate(q, rng, scale, template_dir)
    path = os.path.join(output_dir, f"query_{q}.sql")
    with open(path, "w") as f:
        f.write(
            f"-- start query 1 in stream 0 using template query{q}.tpl\n"
            f"{sql}\n;\n"
            f"-- end query 1 in stream 0 using template query{q}.tpl\n"
        )
    return path

"""nds_tpu_torch/engine/columnar.py against nds_tpu/engine/columnar.py.

The Arrow round trip (nulls, dictionaries, decimals, dates) and the state
hand-over `table_from_numpy`, fed the numpy form of the JAX catalog's own
device tables, must reproduce the JAX columns, validity, dictionaries and
ColStats EXACTLY.
"""

import decimal

import os
import sys

import numpy as np
import pyarrow as pa
import pytest
import torch

from nds_tpu.engine import columnar as JC
from nds_tpu.engine.session import Session as JaxSession
from nds_tpu_torch.engine import columnar as TC

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_join_cases import strict_budget  # noqa: E402,F401

torch.set_num_threads(1)

CPU = torch.device("cpu")


def _arrow_table(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    ints = rng.integers(-1000, 1000, n)
    ints_null = np.where(rng.random(n) < 0.2, None, ints.astype(object))
    words = rng.choice(["alpha", "beta", "gamma", None], n)
    prices = [
        None if rng.random() < 0.1 else decimal.Decimal(f"{x:.2f}")
        for x in rng.random(n) * 1000
    ]
    return pa.table({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "i32": pa.array(ints.astype(np.int32)),
        "maybe": pa.array(ints_null, type=pa.int64()),
        "word": pa.array(words, type=pa.string()),
        "price": pa.array(prices, type=pa.decimal128(7, 2)),
        "day": pa.array(rng.integers(0, 20000, n).astype(np.int32)).cast(
            pa.date32()),
        "f": pa.array(rng.random(n)),
    })


def test_arrow_round_trip_matches_input_and_jax():
    at = _arrow_table()
    tt = TC.table_from_arrow(at, with_stats=True, device=CPU)
    jt = JC.table_from_arrow(at, with_stats=True)
    back = TC.table_to_arrow(tt)
    assert back.equals(JC.table_to_arrow(jt))
    for name in at.column_names:
        assert back.column(name).to_pylist() == at.column(name).to_pylist()
        assert tt.columns[name].stats == (
            None if jt.columns[name].stats is None
            else TC.ColStats(*vars(jt.columns[name].stats).values())
        )


def test_round_trip_of_a_masked_table_compacts():
    at = _arrow_table(1500, 1)
    tt = TC.table_from_arrow(at, device=CPU)
    live = torch.from_numpy(np.arange(tt.cap) % 3 == 0) & tt.row_mask()
    masked = TC.Table(tt.columns, int(live.sum()), live=live)
    back = TC.table_to_arrow(masked)
    assert back.equals(at.take(np.arange(0, at.num_rows, 3)))


def _numpy_form(jt):
    cols, stats = {}, {}
    for name, c in jt.columns.items():
        cols[name] = (
            np.asarray(c.data),
            None if c.valid is None else np.asarray(c.valid),
            str(c.dtype),
            c.dictionary,
        )
        if c.stats is not None:
            s = c.stats
            stats[name] = (s.vmin, s.vmax, s.unique, s.base_rows)
    return cols, stats


@pytest.fixture(scope="module")
def jax_catalog_tables():
    at = _arrow_table(2500, 2)
    dim = pa.table({
        "d_sk": pa.array(np.arange(100, 400, dtype=np.int32)),
        "d_name": pa.array([f"n{i % 37}" for i in range(300)]),
    })
    s = JaxSession(conf={"engine.aot_cache_dir": ""})  # no shared disk cache
    s.register_arrow("facts", at)
    s.register_arrow("dim", dim)
    return {name: s.catalog.load(name) for name in ("facts", "dim")}


@pytest.mark.parametrize("name", ["facts", "dim"])
@pytest.mark.parametrize("pass_stats", [True, False])
def test_table_from_numpy_reproduces_jax_table(jax_catalog_tables, name,
                                               pass_stats):
    jt = jax_catalog_tables[name]
    cols, stats = _numpy_form(jt)
    tt = TC.table_from_numpy(cols, jt.nrows, stats if pass_stats else None,
                             device=CPU)
    assert tt.nrows == jt.nrows and tt.cap == jt.cap
    assert list(tt.columns) == list(jt.columns)
    n = jt.nrows
    for cname, jc in jt.columns.items():
        tc = tt.columns[cname]
        assert str(tc.dtype) == str(jc.dtype)  # two DType classes
        np.testing.assert_array_equal(tc.data.numpy()[:n],
                                      np.asarray(jc.data)[:n])
        if jc.valid is None:
            assert tc.valid is None
        else:
            np.testing.assert_array_equal(tc.valid.numpy()[:n],
                                          np.asarray(jc.valid)[:n])
        if jc.dictionary is None:
            assert tc.dictionary is None
        else:
            assert tc.dictionary.equals(jc.dictionary)
        if jc.stats is None:
            assert tc.stats is None
        else:
            assert (tc.stats.vmin, tc.stats.vmax, tc.stats.unique,
                    tc.stats.base_rows) == (jc.stats.vmin, jc.stats.vmax,
                                            jc.stats.unique,
                                            jc.stats.base_rows)
    assert TC.table_to_arrow(tt).equals(JC.table_to_arrow(jt))


def test_dictionary_helpers_match_jax():
    a = pa.array(["pear", "apple", None, "fig", "apple"]).dictionary_encode()
    b = pa.array(["fig", "kiwi", "pear"]).dictionary_encode()
    cap = 1024
    ja = JC.column_from_arrow(a, JC.parse_dtype("string"), cap)
    jb = JC.column_from_arrow(b, JC.parse_dtype("string"), cap)
    ta = TC.column_from_arrow(a, TC.parse_dtype("string"), cap, CPU)
    tb = TC.column_from_arrow(b, TC.parse_dtype("string"), cap, CPU)
    jca, jcb, juni = JC.unify_dictionaries(ja, jb)
    tca, tcb, tuni = TC.unify_dictionaries(ta, tb)
    assert tuni.equals(juni)
    np.testing.assert_array_equal(tca.numpy(), np.asarray(jca))
    np.testing.assert_array_equal(tcb.numpy(), np.asarray(jcb))
    jr, jd = JC.sort_dictionary(ja)
    tr, td = TC.sort_dictionary(ta)
    assert td.equals(jd)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_device_path_modules_do_not_import_pyarrow():
    """The card's main path must not need pyarrow: importing the engine and
    building a table from numpy loads no pyarrow module of its own."""
    import subprocess
    import sys

    code = (
        "import sys, numpy as np\n"
        "sys.modules['pyarrow'] = None\n"  # any import of it now fails
        "from nds_tpu_torch.engine.session import Session\n"
        "from nds_tpu_torch.engine.columnar import table_from_numpy\n"
        "t = table_from_numpy({'a': (np.arange(5, dtype=np.int32), None,"
        " 'int32', None)}, 5, device='cpu')\n"
        "s = Session(device='cpu'); s.register_table('t', t)\n"
        "r = s.sql('select a, count(*) c from t where a > 1 group by a "
        "order by a').table()\n"
        "print(r.nrows)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=__file__.rsplit("/tests/", 1)[0])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "3"

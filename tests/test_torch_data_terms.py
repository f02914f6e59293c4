"""The port's term evaluator and data layer against the reference's.

Terms: ``evaluate`` equals the reference's ``Term.evaluate`` on the same
environment (exactly: both evaluate one float32 operation per element), and
``key()`` is identical, so view merging produces the same views.
Datasets: the port's copy of the generators gives bit-identical tables;
``from_numpy`` keeps every column value and casts to the engine dtypes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregates as J
from repro.data import datasets as JD
from repro.data import relations as JR
from repro_torch.core import aggregates as T
from repro_torch.data import datasets as TD
from repro_torch.data import relations as TR


def _env(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 5, (7, 1)).astype(np.int32)     # a code column
    u = rng.normal(size=(7, 1)).astype(np.float32)      # a continuous column
    d = np.arange(4, dtype=np.int32)[None, :]           # a domain axis
    return {"x": x, "u": u, "d": d}


_CASES = [
    ("Constant", (), {}),
    ("Constant", (2.5,), {}),
    ("Var", ("u",), {}),
    ("Var", ("x",), {}),
    ("Pow", ("u", 2), {}),
    ("Pow", ("x", 3), {}),
] + [("Delta", ("x", op, 2), {}) for op in ("<=", "<", ">=", ">", "==", "!=")] \
  + [("Delta", ("d", "<", 2), {})]


@pytest.mark.parametrize("name,args,kw", _CASES,
                         ids=[f"{c[0]}{c[1]}" for c in _CASES])
def test_term_evaluate_and_key_match_reference(name, args, kw):
    env = _env()
    jt = getattr(J, name)(*args, **kw)
    tt = getattr(T, name)(*args, **kw)
    want = np.asarray(jt.evaluate({k: jnp.asarray(v) for k, v in env.items()}, {}))
    got = tt.evaluate({k: torch.from_numpy(v) for k, v in env.items()}, {})
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(np.broadcast_to(got.numpy(), want.shape), want)
    assert tt.key() == jt.key()


def test_param_threshold_and_lambda_match_reference():
    env = _env(1)
    jenv = {k: jnp.asarray(v) for k, v in env.items()}
    tenv = {k: torch.from_numpy(v) for k, v in env.items()}
    jd = J.Delta("u", "<=", J.Param("t"))
    td = T.Delta("u", "<=", T.Param("t"))
    np.testing.assert_array_equal(td.evaluate(tenv, {"t": 0.1}).numpy(),
                                  np.asarray(jd.evaluate(jenv, {"t": 0.1})))
    jl = J.Lambda(("u", "x"), lambda u, x, p: u * x + 1.0, tag="ux1")
    tl = T.Lambda(("u", "x"), lambda u, x, p: u * x + 1.0, tag="ux1")
    np.testing.assert_array_equal(tl.evaluate(tenv, {}).numpy(),
                                  np.asarray(jl.evaluate(jenv, {})))
    assert tl.key() == jl.key() and td.key() != jd.key()  # Param classes differ


def test_aggregate_keys_match_reference():
    for jq, tq in [(J.COUNT, T.COUNT), (J.sum_of("u"), T.sum_of("u")),
                   (J.sum_prod("u", "v"), T.sum_prod("u", "v")),
                   (J.sum_prod("u", "u"), T.sum_prod("u", "u"))]:
        assert tq.key() == jq.key()


@pytest.mark.parametrize("name", ["favorita", "retailer", "yelp", "tpcds"])
def test_dataset_tables_bit_identical(name):
    jd, td = JD.make(name, scale=0.02), TD.make(name, scale=0.02)
    assert td.tables.keys() == jd.tables.keys()
    for rel, cols in jd.tables.items():
        assert td.tables[rel].keys() == cols.keys()
        for a, c in cols.items():
            t = td.tables[rel][a]
            assert t.dtype == c.dtype, (rel, a)
            np.testing.assert_array_equal(t, c, err_msg=f"{rel}.{a}")
    assert (td.edges, td.features_cont, td.features_cat, td.label, td.fact) == \
        (jd.edges, jd.features_cont, jd.features_cat, jd.label, jd.fact)
    astuple = lambda S: ([dataclasses.astuple(a) for a in S.attributes.values()],
                         [dataclasses.astuple(r) for r in S.relations.values()])
    assert astuple(td.schema) == astuple(jd.schema)


def test_from_numpy_matches_reference_columns():
    ds = TD.make("retailer", scale=0.02)
    jdb = JR.from_numpy(JD.make("retailer", scale=0.02).schema, ds.tables)
    tdb = TR.from_numpy(ds.schema, ds.tables, "cpu")
    assert tdb.sizes() == jdb.sizes()
    for name, rel in jdb.relations.items():
        for a, c in rel.columns.items():
            t = tdb.relation(name).columns[a]
            assert str(t.dtype).split(".")[-1] == str(c.dtype), (name, a)
            np.testing.assert_array_equal(t.numpy(), np.asarray(c))


def test_from_numpy_rejects_codes_outside_domain():
    ds = TD.make("retailer", scale=0.02)
    tables = {r: dict(c) for r, c in ds.tables.items()}
    tables["Items"]["category"] = tables["Items"]["category"] + 100
    with pytest.raises(ValueError, match="outside"):
        TR.from_numpy(ds.schema, tables, "cpu")

"""The data makers: deterministic in the seed, inside the schema's domains,
dense dimension keys, and numpy's distributions."""

import numpy as np
import pytest
import torch

from cardbench.data import _tables
from cardbench.harness import spec

SMALL = {"retailer.covar": 20_000, "favorita.tree": 20_000}


def make(workload, seed):
    c = spec.cell(workload)
    cfg = dict(c.config, fact_rows=SMALL[workload])
    return c.data_maker().make(cfg, seed, "cpu")


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_deterministic_in_the_seed(workload):
    a, b, c = make(workload, 2**31 + 11), make(workload, 2**31 + 11), make(workload, 5)
    for rel, cols in a.columns.items():
        for k, v in cols.items():
            assert torch.equal(v, b.columns[rel][k]), (rel, k)
    fact = a.fact
    assert any(not torch.equal(v, c.columns[fact][k]) for k, v in a.columns[fact].items())


@pytest.mark.parametrize("workload", sorted(SMALL))
def test_fits_the_schema(workload):
    t = make(workload, 3)
    assert t.n_rows(t.fact) == SMALL[workload]
    for rel, attrs in t.relations:
        cols = t.columns[rel]
        assert sorted(cols) == sorted(attrs)
        n = t.n_rows(rel)
        for a, col in cols.items():
            assert col.shape == (n,)
            if t.kind(a) == _tables.CONTINUOUS:
                assert col.dtype == torch.float32 and torch.isfinite(col).all()
            else:
                assert col.dtype == torch.int32
                assert int(col.min()) >= 0 and int(col.max()) < t.domain(a), (rel, a)


def test_zipf_codes_follow_numpy():
    n, d = 400_000, 40
    got = np.bincount(_tables.zipf_codes(_tables.generator(1, "cpu"), n, d, 1.3, "cpu").numpy(),
                      minlength=d) / n
    z = np.random.default_rng(0).zipf(1.3, size=n)
    want = np.bincount((z - 1) % d, minlength=d) / n
    assert np.abs(got - want).max() < 5e-3
    assert got[0] > 0.2 and got.argmax() == 0


def test_bucketize_is_numpys():
    x = torch.randn(10_001, generator=_tables.generator(2, "cpu"))
    qs = np.quantile(x.double().numpy(), np.linspace(0, 1, 21)[1:-1])
    want = np.searchsorted(qs, x.double().numpy())
    assert np.array_equal(_tables.bucketize(x, 20).numpy(), want)


def test_retailer_has_the_sources_attributes_and_sizes():
    t = make("retailer.covar", 1)
    source = {a for a, _, _ in t.attrs if not a.endswith("__b")}
    assert len(source) == 43
    assert {r: len([a for a in attrs if not a.endswith("__b")])
            for r, attrs in t.relations} == {"Inventory": 4, "Items": 5, "Location": 15,
                                             "Census": 16, "Weather": 8}
    rows = {r: t.n_rows(r) for r, _ in t.relations}
    assert rows == {"Inventory": SMALL["retailer.covar"], "Items": 5618, "Location": 1317,
                    "Census": 1302, "Weather": 1317 * 880}


def test_favorita_has_kaggles_sizes_and_every_sale_joins():
    c = spec.cell("favorita.tree")
    t = make("favorita.tree", 1)
    assert {r: t.n_rows(r) for r in ("Items", "Stores", "Transactions")} == {
        "Items": 4100, "Stores": 54, "Transactions": 83488}
    assert t.domain("date") == 1684 and t.domain("item_class") == 337
    tx = t.columns["Transactions"]
    key = tx["date"].long() * 54 + tx["store_nbr"].long()
    assert key.unique().numel() == 83488
    have = torch.zeros(1684 * 54, dtype=torch.bool)
    have[key] = True
    s = t.columns["Sales"]
    assert have[s["date"].long() * 54 + s["store_nbr"].long()].all()
    assert c.config["published_rows"]["Transactions"] == 83488

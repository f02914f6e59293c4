"""Favorita (LMFAO's star; fact = Sales) made on the device from the seed,
with the columns of Kaggle's Corporación Favorita files (train.csv without
its row id, items, stores, transactions, oil, holidays_events) and their
published sizes and domains:

    Sales(date, store_nbr, item_nbr, unit_sales, onpromotion)
    Transactions(date, store_nbr, transactions)
    Stores(store_nbr, city, state, store_type, cluster)
    Oil(date, dcoilwtico)
    Holiday(date, holiday_type, locale, locale_name, description, transferred)
    Items(item_nbr, family, item_class, perishable)

Sales joins Transactions on (date, store_nbr), Holiday on date and Items
on item_nbr; Transactions joins Stores on store_nbr and Oil on date.
Transactions holds the configuration's ``transactions_rows`` of the
(date, store_nbr) grid: the last stores open late, and each store sells
only on its open days, so every sale finds its transactions row.  Oil and
Holiday hold one row per date, as the join of every sale needs.  The zipf
skew of stores and items and the label's dependence on a few features are
the port's ``make_favorita``'s; every continuous attribute also has its
bucket codes (``<attr>__b``), the tree workload's split attributes.
"""

from __future__ import annotations

import math

import torch

from cardbench.data._tables import (CATEGORICAL, CONTINUOUS, KEY, Tables,
                                    bucketize, generator, normal,
                                    uniform_codes, zipf_codes)

CAT = {"Sales": ["onpromotion"],
       "Stores": ["city", "state", "store_type", "cluster"],
       "Holiday": ["holiday_type", "locale", "locale_name", "description", "transferred"],
       "Items": ["family", "item_class", "perishable"]}
CONT = ["unit_sales", "transactions", "dcoilwtico"]


def open_dates(n_date: int, n_store: int, rows: int) -> torch.Tensor:
    """Each store's first open date: the grid's ``n_date·n_store - rows``
    missing days fall on the fewest last stores that leave each of them at
    least a quarter of the dates, spread evenly."""
    missing = n_date * n_store - rows
    if not 0 <= missing <= n_store * (n_date - n_date // 4):
        raise ValueError(f"{rows} transactions rows do not fit {n_date} × {n_store}")
    k = max(math.ceil(missing / (n_date - n_date // 4)), 1)
    out = torch.zeros(n_store, dtype=torch.long)
    for i in range(k):
        out[n_store - k + i] = missing // k + (i < missing % k)
    return out


def make(cfg: dict, seed: int, device) -> Tables:
    dom = cfg["domains"]
    n_date, n_store, n_item = (dom[k] for k in ("date", "store_nbr", "item_nbr"))
    n_fact, nb, za = cfg["fact_rows"], cfg["n_buckets"], cfg["zipf_a"]
    g = generator(seed, device)
    codes = lambda n, d: uniform_codes(g, n, d, device)
    nrm = lambda n, m, s: normal(g, n, m, s, device)
    ar = lambda n: torch.arange(n, device=device, dtype=torch.int32)

    attrs = [("date", KEY, n_date), ("store_nbr", KEY, n_store),
             ("item_nbr", KEY, n_item)]
    attrs += [(a, CATEGORICAL, dom[a]) for r in CAT for a in CAT[r]]
    attrs += [(a, CONTINUOUS, 0) for a in CONT]
    attrs += [(a + "__b", CATEGORICAL, nb) for a in CONT]
    relations = [
        ("Sales", ["date", "store_nbr", "item_nbr", "unit_sales", "onpromotion",
                   "unit_sales__b"]),
        ("Transactions", ["date", "store_nbr", "transactions", "transactions__b"]),
        ("Stores", ["store_nbr"] + CAT["Stores"]),
        ("Oil", ["date", "dcoilwtico", "dcoilwtico__b"]),
        ("Holiday", ["date"] + CAT["Holiday"]),
        ("Items", ["item_nbr"] + CAT["Items"]),
    ]

    opens = open_dates(n_date, n_store, cfg["transactions_rows"]).to(device)
    grid = torch.arange(n_date * n_store, device=device)
    present = grid[(grid // n_store) >= opens[grid % n_store]]   # date-major
    td, ts = (present // n_store).to(torch.int32), (present % n_store).to(torch.int32)
    row_of = torch.full((n_date * n_store,), -1, dtype=torch.long, device=device)
    row_of[present] = torch.arange(present.shape[0], device=device)
    txns = torch.clamp(nrm(present.shape[0], 1000, 300), min=1.0)
    oil = nrm(n_date, 60, 20).abs()
    fam = codes(n_item, dom["family"])
    fam_eff = nrm(dom["family"], 0, 2.0)

    store = zipf_codes(g, n_fact, n_store, za, device)
    item = zipf_codes(g, n_fact, n_item, za, device)
    first = opens[store.long()]
    u = torch.rand(n_fact, generator=g, device=device, dtype=torch.float64)
    dl = (first + (u * (n_date - first)).long()).clamp_(max=n_date - 1)
    del u, first
    promo = codes(n_fact, dom["onpromotion"])
    units = (8.0 + 2.5 * promo + 0.004 * txns[row_of[dl * n_store + store.long()]]
             + fam_eff[fam.long()[item.long()]] - 0.03 * oil[dl]
             + nrm(n_fact, 0, 2.0))
    date = dl.to(torch.int32)
    del dl

    columns = {
        "Sales": {"date": date, "store_nbr": store, "item_nbr": item,
                  "unit_sales": units, "onpromotion": promo,
                  "unit_sales__b": bucketize(units, nb)},
        "Transactions": {"date": td, "store_nbr": ts, "transactions": txns,
                         "transactions__b": bucketize(txns, nb)},
        "Stores": {"store_nbr": ar(n_store),
                   **{a: codes(n_store, dom[a]) for a in CAT["Stores"]}},
        "Oil": {"date": ar(n_date), "dcoilwtico": oil,
                "dcoilwtico__b": bucketize(oil, nb)},
        "Holiday": {"date": ar(n_date),
                    **{a: codes(n_date, dom[a]) for a in CAT["Holiday"]}},
        "Items": {"item_nbr": ar(n_item), "family": fam,
                  "item_class": codes(n_item, dom["item_class"]),
                  "perishable": codes(n_item, dom["perishable"])},
    }
    edges = [("Sales", "Transactions"), ("Transactions", "Stores"),
             ("Transactions", "Oil"), ("Sales", "Holiday"), ("Sales", "Items")]
    return Tables("favorita", attrs, relations, edges, fact="Sales",
                  label="unit_sales", features_cont=["transactions", "dcoilwtico"],
                  features_cat=[a for r in CAT for a in CAT[r]],
                  columns=columns)

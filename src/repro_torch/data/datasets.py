"""Copy of ``repro/data/datasets.py`` for the PyTorch port: the same
generators and seeds, so the numpy tables are bit-identical.  A dataset
holds host tables only; ``repro_torch.connect`` moves them to a device.

Synthetic datasets mirroring the paper's four benchmark schemas (App. A).

Retailer and TPC-DS are snowflakes, Favorita is a star, Yelp is a star with
many-to-many joins (Category/Attribute) that blow up the join result — the
exact structural variety the paper exercises.  Generators are deterministic
in ``seed`` and scale-free: ``scale=1.0`` ≈ 60k fact rows (CPU-friendly);
benchmarks raise it.

Continuous features are also *bucketized* into companion categorical
attributes (``<attr>__b``) at generation time — the decision-tree workload
groups by bucket codes (paper §4.2 bucketizes into 20 buckets).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.schema import DatabaseSchema, schema

N_BUCKETS = 20


@dataclasses.dataclass
class Dataset:
    name: str
    schema: DatabaseSchema
    tables: Dict[str, Dict[str, np.ndarray]]
    edges: List[Tuple[str, str]]              # join tree (paper Fig. 6)
    features_cont: List[str]                  # continuous model features
    features_cat: List[str]                   # categorical model features
    label: str                                # continuous label (fact table)
    fact: str

    def bucket_attr(self, cont_attr: str) -> str:
        return cont_attr + "__b"


def _bucketize(x: np.ndarray, n: int = N_BUCKETS) -> Tuple[np.ndarray, np.ndarray]:
    qs = np.quantile(x, np.linspace(0, 1, n + 1)[1:-1])
    return np.searchsorted(qs, x).astype(np.int32), qs.astype(np.float32)


def _zipf_codes(rng, n, domain, a=1.3):
    z = rng.zipf(a, size=n)
    return ((z - 1) % domain).astype(np.int32)


# ---------------------------------------------------------------------------
# Favorita (paper Fig. 3): star, fact = Sales
# ---------------------------------------------------------------------------

def make_favorita(scale: float = 1.0, seed: int = 0) -> Dataset:
    rng = np.random.default_rng(seed)
    n_date, n_store, n_item = 334, 54, max(40, int(100 * min(scale, 4.0)))
    n_fact = int(60_000 * scale)

    attr_specs = [
        ("date", "key", n_date), ("store", "key", n_store), ("item", "key", n_item),
        ("units", "continuous", 0), ("promo", "categorical", 2),
        ("txns", "continuous", 0),
        ("city", "categorical", 22), ("state", "categorical", 16),
        ("stype", "categorical", 5), ("cluster", "categorical", 17),
        ("price", "continuous", 0),
        ("htype", "categorical", 6), ("locale", "categorical", 3),
        ("transferred", "categorical", 2),
        ("family", "categorical", 33), ("iclass", "categorical", 30),
        ("perishable", "categorical", 2),
    ]
    cont = ["units", "txns", "price"]
    attr_specs += [(c + "__b", "categorical", N_BUCKETS) for c in cont]

    S = schema(attr_specs, [
        ("Sales", ["date", "store", "item", "units", "promo", "units__b"]),
        ("Transactions", ["date", "store", "txns", "txns__b"]),
        ("Stores", ["store", "city", "state", "stype", "cluster"]),
        ("Oil", ["date", "price", "price__b"]),
        ("Holiday", ["date", "htype", "locale", "transferred"]),
        ("Items", ["item", "family", "iclass", "perishable"]),
    ])

    date = rng.integers(0, n_date, n_fact).astype(np.int32)
    store = _zipf_codes(rng, n_fact, n_store)
    item = _zipf_codes(rng, n_fact, n_item)
    promo = rng.integers(0, 2, n_fact).astype(np.int32)
    txns = np.maximum(1.0, rng.normal(1000, 300, n_date * n_store)).astype(np.float32)
    txns_b, _ = _bucketize(txns)
    td, ts = np.divmod(np.arange(n_date * n_store, dtype=np.int32), n_store)
    price = np.abs(rng.normal(60, 20, n_date)).astype(np.float32)
    price_b, _ = _bucketize(price)
    # label with genuine signal through the join: promo, store traffic,
    # item family effects, and the (date-level) oil price
    fam = rng.integers(0, 33, n_item).astype(np.int32)
    fam_eff = rng.normal(0, 2.0, 33).astype(np.float32)
    units = (8.0 + 2.5 * promo + 0.004 * txns[date * n_store + store]
             + fam_eff[fam[item]] - 0.03 * price[date]
             + rng.normal(0, 2.0, n_fact)).astype(np.float32)
    units_b, _ = _bucketize(units)

    tables = {
        "Sales": {"date": date, "store": store, "item": item, "units": units,
                  "promo": promo, "units__b": units_b},
        "Transactions": {"date": td, "store": ts, "txns": txns, "txns__b": txns_b},
        "Stores": {"store": np.arange(n_store, dtype=np.int32),
                   "city": rng.integers(0, 22, n_store).astype(np.int32),
                   "state": rng.integers(0, 16, n_store).astype(np.int32),
                   "stype": rng.integers(0, 5, n_store).astype(np.int32),
                   "cluster": rng.integers(0, 17, n_store).astype(np.int32)},
        "Oil": {"date": np.arange(n_date, dtype=np.int32), "price": price,
                "price__b": price_b},
        "Holiday": {"date": np.arange(n_date, dtype=np.int32),
                    "htype": rng.integers(0, 6, n_date).astype(np.int32),
                    "locale": rng.integers(0, 3, n_date).astype(np.int32),
                    "transferred": rng.integers(0, 2, n_date).astype(np.int32)},
        "Items": {"item": np.arange(n_item, dtype=np.int32),
                  "family": fam,
                  "iclass": rng.integers(0, 30, n_item).astype(np.int32),
                  "perishable": rng.integers(0, 2, n_item).astype(np.int32)},
    }
    edges = [("Sales", "Transactions"), ("Transactions", "Stores"),
             ("Transactions", "Oil"), ("Sales", "Holiday"), ("Sales", "Items")]
    return Dataset("favorita", S, tables, edges,
                   features_cont=["txns", "price"],
                   features_cat=["promo", "city", "state", "stype", "cluster",
                                 "htype", "locale", "transferred", "family",
                                 "iclass", "perishable"],
                   label="units", fact="Sales")


# ---------------------------------------------------------------------------
# Retailer (App. A): snowflake, fact = Inventory
# ---------------------------------------------------------------------------

def make_retailer(scale: float = 1.0, seed: int = 1) -> Dataset:
    rng = np.random.default_rng(seed)
    n_date, n_locn, n_zip, n_sku = 124, 40, 30, max(60, int(120 * min(scale, 4.0)))
    n_fact = int(60_000 * scale)

    cont = ["inventoryunits", "maxtemp", "population", "medianage", "distance",
            "sales_area", "avghhi", "supertargetdistance"]
    attr_specs = [
        ("date", "key", n_date), ("locn", "key", n_locn), ("zip", "key", n_zip),
        ("sku", "key", n_sku),
        ("rain", "categorical", 2), ("snow", "categorical", 2),
        ("thunder", "categorical", 2),
        ("rgn_cd", "categorical", 5), ("clim_zn", "categorical", 6),
        ("category", "categorical", 10), ("subcategory", "categorical", 25),
        ("categoryCluster", "categorical", 8), ("prize", "continuous", 0),
    ] + [(c, "continuous", 0) for c in cont]
    attr_specs += [(c + "__b", "categorical", N_BUCKETS)
                   for c in ["inventoryunits", "maxtemp", "population", "prize"]]

    S = schema(attr_specs, [
        ("Inventory", ["date", "locn", "sku", "inventoryunits", "inventoryunits__b"]),
        ("Weather", ["date", "locn", "rain", "snow", "thunder", "maxtemp", "maxtemp__b"]),
        ("Location", ["locn", "zip", "rgn_cd", "clim_zn", "distance",
                      "sales_area", "supertargetdistance"]),
        ("Census", ["zip", "population", "population__b", "medianage", "avghhi"]),
        ("Items", ["sku", "category", "subcategory", "categoryCluster", "prize",
                   "prize__b"]),
    ])

    maxtemp = rng.normal(60, 20, n_date * n_locn).astype(np.float32)
    maxtemp_b, _ = _bucketize(maxtemp)
    wd, wl = np.divmod(np.arange(n_date * n_locn, dtype=np.int32), n_locn)
    pop = np.abs(rng.normal(30_000, 12_000, n_zip)).astype(np.float32)
    pop_b, _ = _bucketize(pop)
    prize = np.abs(rng.normal(25, 10, n_sku)).astype(np.float32)
    prize_b, _ = _bucketize(prize)
    zip_of = rng.integers(0, n_zip, n_locn).astype(np.int32)
    cat_of = rng.integers(0, 10, n_sku).astype(np.int32)
    cat_eff = rng.normal(0, 5.0, 10).astype(np.float32)
    f_date = rng.integers(0, n_date, n_fact).astype(np.int32)
    f_locn = _zipf_codes(rng, n_fact, n_locn)
    f_sku = _zipf_codes(rng, n_fact, n_sku)
    inv = (12.0 + 0.0004 * pop[zip_of[f_locn]] + cat_eff[cat_of[f_sku]]
           + 0.1 * maxtemp[f_date * n_locn + f_locn] - 0.2 * prize[f_sku]
           + rng.normal(0, 4.0, n_fact)).astype(np.float32)
    inv_b, _ = _bucketize(inv)

    tables = {
        "Inventory": {"date": f_date, "locn": f_locn, "sku": f_sku,
                      "inventoryunits": inv, "inventoryunits__b": inv_b},
        "Weather": {"date": wd, "locn": wl,
                    "rain": rng.integers(0, 2, n_date * n_locn).astype(np.int32),
                    "snow": rng.integers(0, 2, n_date * n_locn).astype(np.int32),
                    "thunder": rng.integers(0, 2, n_date * n_locn).astype(np.int32),
                    "maxtemp": maxtemp, "maxtemp__b": maxtemp_b},
        "Location": {"locn": np.arange(n_locn, dtype=np.int32),
                     "zip": zip_of,
                     "rgn_cd": rng.integers(0, 5, n_locn).astype(np.int32),
                     "clim_zn": rng.integers(0, 6, n_locn).astype(np.int32),
                     "distance": np.abs(rng.normal(5, 3, n_locn)).astype(np.float32),
                     "sales_area": np.abs(rng.normal(2000, 700, n_locn)).astype(np.float32),
                     "supertargetdistance": np.abs(rng.normal(8, 4, n_locn)).astype(np.float32)},
        "Census": {"zip": np.arange(n_zip, dtype=np.int32),
                   "population": pop, "population__b": pop_b,
                   "medianage": np.abs(rng.normal(38, 8, n_zip)).astype(np.float32),
                   "avghhi": np.abs(rng.normal(60_000, 15_000, n_zip)).astype(np.float32)},
        "Items": {"sku": np.arange(n_sku, dtype=np.int32),
                  "category": cat_of,
                  "subcategory": rng.integers(0, 25, n_sku).astype(np.int32),
                  "categoryCluster": rng.integers(0, 8, n_sku).astype(np.int32),
                  "prize": prize, "prize__b": prize_b},
    }
    edges = [("Inventory", "Weather"), ("Inventory", "Location"),
             ("Location", "Census"), ("Inventory", "Items")]
    return Dataset("retailer", S, tables, edges,
                   features_cont=["maxtemp", "population", "medianage", "avghhi",
                                  "distance", "sales_area", "supertargetdistance",
                                  "prize"],
                   features_cat=["rain", "snow", "thunder", "rgn_cd", "clim_zn",
                                 "category", "subcategory", "categoryCluster"],
                   label="inventoryunits", fact="Inventory")


# ---------------------------------------------------------------------------
# Yelp: star with many-to-many Category/Attribute joins
# ---------------------------------------------------------------------------

def make_yelp(scale: float = 1.0, seed: int = 2) -> Dataset:
    rng = np.random.default_rng(seed)
    n_user, n_biz = max(80, int(200 * min(scale, 4.0))), max(50, int(120 * min(scale, 4.0)))
    n_fact = int(40_000 * scale)
    n_cat_rows, n_attr_rows = n_biz * 3, n_biz * 4

    attr_specs = [
        ("user", "key", n_user), ("business", "key", n_biz),
        ("stars", "continuous", 0), ("useful", "continuous", 0),
        ("u_review_count", "continuous", 0), ("u_avg_stars", "continuous", 0),
        ("b_city", "categorical", 30), ("b_stars", "continuous", 0),
        ("b_review_count", "continuous", 0), ("b_open", "categorical", 2),
        ("cat", "categorical", 40), ("attr", "categorical", 50),
        ("attr_val", "categorical", 2),
    ]
    attr_specs += [(c + "__b", "categorical", N_BUCKETS)
                   for c in ["stars", "u_avg_stars", "b_stars"]]

    S = schema(attr_specs, [
        ("Review", ["user", "business", "stars", "stars__b", "useful"]),
        ("User", ["user", "u_review_count", "u_avg_stars", "u_avg_stars__b"]),
        ("Business", ["business", "b_city", "b_stars", "b_stars__b",
                      "b_review_count", "b_open"]),
        ("Category", ["business", "cat"]),
        ("Attribute", ["business", "attr", "attr_val"]),
    ])

    stars = rng.integers(1, 6, n_fact).astype(np.float32)
    stars_b, _ = _bucketize(stars)
    u_avg = rng.uniform(1, 5, n_user).astype(np.float32)
    u_avg_b, _ = _bucketize(u_avg)
    b_stars = rng.uniform(1, 5, n_biz).astype(np.float32)
    b_stars_b, _ = _bucketize(b_stars)

    tables = {
        "Review": {"user": _zipf_codes(rng, n_fact, n_user),
                   "business": _zipf_codes(rng, n_fact, n_biz),
                   "stars": stars, "stars__b": stars_b,
                   "useful": np.abs(rng.normal(2, 2, n_fact)).astype(np.float32)},
        "User": {"user": np.arange(n_user, dtype=np.int32),
                 "u_review_count": np.abs(rng.normal(50, 40, n_user)).astype(np.float32),
                 "u_avg_stars": u_avg, "u_avg_stars__b": u_avg_b},
        "Business": {"business": np.arange(n_biz, dtype=np.int32),
                     "b_city": rng.integers(0, 30, n_biz).astype(np.int32),
                     "b_stars": b_stars, "b_stars__b": b_stars_b,
                     "b_review_count": np.abs(rng.normal(120, 80, n_biz)).astype(np.float32),
                     "b_open": rng.integers(0, 2, n_biz).astype(np.int32)},
        "Category": {"business": rng.integers(0, n_biz, n_cat_rows).astype(np.int32),
                     "cat": rng.integers(0, 40, n_cat_rows).astype(np.int32)},
        "Attribute": {"business": rng.integers(0, n_biz, n_attr_rows).astype(np.int32),
                      "attr": rng.integers(0, 50, n_attr_rows).astype(np.int32),
                      "attr_val": rng.integers(0, 2, n_attr_rows).astype(np.int32)},
    }
    edges = [("Review", "User"), ("Review", "Business"),
             ("Business", "Category"), ("Business", "Attribute")]
    return Dataset("yelp", S, tables, edges,
                   features_cont=["useful", "u_review_count", "u_avg_stars",
                                  "b_stars", "b_review_count"],
                   features_cat=["b_city", "b_open", "cat", "attr", "attr_val"],
                   label="stars", fact="Review")


# ---------------------------------------------------------------------------
# TPC-DS (excerpt, store_sales snowflake, 10 relations)
# ---------------------------------------------------------------------------

def make_tpcds(scale: float = 1.0, seed: int = 3) -> Dataset:
    rng = np.random.default_rng(seed)
    n_date, n_item, n_cust, n_cd, n_hd = 240, max(60, int(120 * min(scale, 4.0))), \
        max(80, int(160 * min(scale, 4.0))), 48, 36
    n_store, n_promo, n_addr, n_time = 12, 16, 60, 48
    n_fact = int(60_000 * scale)

    attr_specs = [
        ("d_date_sk", "key", n_date), ("i_item_sk", "key", n_item),
        ("c_customer_sk", "key", n_cust), ("cd_demo_sk", "key", n_cd),
        ("hd_demo_sk", "key", n_hd), ("s_store_sk", "key", n_store),
        ("p_promo_sk", "key", n_promo), ("ca_address_sk", "key", n_addr),
        ("t_time_sk", "key", n_time),
        ("ss_quantity", "continuous", 0), ("ss_sales_price", "continuous", 0),
        ("ss_ext_discount", "continuous", 0),
        ("d_year", "categorical", 5), ("d_moy", "categorical", 12),
        ("d_dow", "categorical", 7),
        ("i_category", "categorical", 10), ("i_brand", "categorical", 20),
        ("i_price", "continuous", 0),
        ("c_preferred", "categorical", 2), ("c_birth_year", "categorical", 40),
        ("cd_gender", "categorical", 2), ("cd_marital", "categorical", 5),
        ("cd_education", "categorical", 7),
        ("hd_income_band", "categorical", 20), ("hd_dep_count", "categorical", 10),
        ("s_city", "categorical", 8), ("s_tax", "continuous", 0),
        ("p_channel", "categorical", 4),
        ("ca_state", "categorical", 25), ("ca_gmt", "categorical", 6),
        ("t_hour", "categorical", 24),
    ]
    attr_specs += [(c + "__b", "categorical", N_BUCKETS)
                   for c in ["ss_quantity", "ss_sales_price", "i_price"]]

    S = schema(attr_specs, [
        ("store_sales", ["d_date_sk", "t_time_sk", "i_item_sk", "c_customer_sk",
                         "s_store_sk", "p_promo_sk", "ss_quantity", "ss_quantity__b",
                         "ss_sales_price", "ss_sales_price__b", "ss_ext_discount"]),
        ("date_dim", ["d_date_sk", "d_year", "d_moy", "d_dow"]),
        ("time_dim", ["t_time_sk", "t_hour"]),
        ("item", ["i_item_sk", "i_category", "i_brand", "i_price", "i_price__b"]),
        ("customer", ["c_customer_sk", "cd_demo_sk", "hd_demo_sk", "ca_address_sk",
                      "c_preferred", "c_birth_year"]),
        ("customer_demographics", ["cd_demo_sk", "cd_gender", "cd_marital",
                                   "cd_education"]),
        ("household_demographics", ["hd_demo_sk", "hd_income_band", "hd_dep_count"]),
        ("customer_address", ["ca_address_sk", "ca_state", "ca_gmt"]),
        ("store", ["s_store_sk", "s_city", "s_tax"]),
        ("promotion", ["p_promo_sk", "p_channel"]),
    ])

    sp = np.abs(rng.normal(35, 18, n_fact)).astype(np.float32)
    sp_b, _ = _bucketize(sp)
    ip = np.abs(rng.normal(40, 20, n_item)).astype(np.float32)
    ip_b, _ = _bucketize(ip)
    # demographics drive c_preferred (classification label, paper §4.2)
    cd_of = rng.integers(0, n_cd, n_cust).astype(np.int32)
    hd_of = rng.integers(0, n_hd, n_cust).astype(np.int32)
    educ = rng.integers(0, 7, n_cd).astype(np.int32)
    inc = rng.integers(0, 20, n_hd).astype(np.int32)
    logit = -0.6 + 0.45 * (educ[cd_of] - 3) + 0.12 * (inc[hd_of] - 10)
    c_pref = (rng.random(n_cust) < 1 / (1 + np.exp(-logit))).astype(np.int32)
    # quantity depends on item price, promo channel, and sales price
    f_item = _zipf_codes(rng, n_fact, n_item)
    f_promo = rng.integers(0, n_promo, n_fact).astype(np.int32)
    ch_of = rng.integers(0, 4, n_promo).astype(np.int32)
    ch_eff = np.array([0.0, 2.0, 4.0, -1.5], dtype=np.float32)
    qty = (24.0 - 0.15 * ip[f_item] + ch_eff[ch_of[f_promo]] - 0.05 * sp
           + rng.normal(0, 5.0, n_fact)).astype(np.float32)
    qty_b, _ = _bucketize(qty)

    tables = {
        "store_sales": {"d_date_sk": rng.integers(0, n_date, n_fact).astype(np.int32),
                        "t_time_sk": rng.integers(0, n_time, n_fact).astype(np.int32),
                        "i_item_sk": f_item,
                        "c_customer_sk": _zipf_codes(rng, n_fact, n_cust),
                        "s_store_sk": rng.integers(0, n_store, n_fact).astype(np.int32),
                        "p_promo_sk": f_promo,
                        "ss_quantity": qty, "ss_quantity__b": qty_b,
                        "ss_sales_price": sp, "ss_sales_price__b": sp_b,
                        "ss_ext_discount": np.abs(rng.normal(3, 2, n_fact)).astype(np.float32)},
        "date_dim": {"d_date_sk": np.arange(n_date, dtype=np.int32),
                     "d_year": (np.arange(n_date) * 5 // n_date).astype(np.int32),
                     "d_moy": (np.arange(n_date) % 12).astype(np.int32),
                     "d_dow": (np.arange(n_date) % 7).astype(np.int32)},
        "time_dim": {"t_time_sk": np.arange(n_time, dtype=np.int32),
                     "t_hour": (np.arange(n_time) % 24).astype(np.int32)},
        "item": {"i_item_sk": np.arange(n_item, dtype=np.int32),
                 "i_category": rng.integers(0, 10, n_item).astype(np.int32),
                 "i_brand": rng.integers(0, 20, n_item).astype(np.int32),
                 "i_price": ip, "i_price__b": ip_b},
        "customer": {"c_customer_sk": np.arange(n_cust, dtype=np.int32),
                     "cd_demo_sk": cd_of,
                     "hd_demo_sk": hd_of,
                     "ca_address_sk": rng.integers(0, n_addr, n_cust).astype(np.int32),
                     "c_preferred": c_pref,
                     "c_birth_year": rng.integers(0, 40, n_cust).astype(np.int32)},
        "customer_demographics": {"cd_demo_sk": np.arange(n_cd, dtype=np.int32),
                                  "cd_gender": rng.integers(0, 2, n_cd).astype(np.int32),
                                  "cd_marital": rng.integers(0, 5, n_cd).astype(np.int32),
                                  "cd_education": educ},
        "household_demographics": {"hd_demo_sk": np.arange(n_hd, dtype=np.int32),
                                   "hd_income_band": inc,
                                   "hd_dep_count": rng.integers(0, 10, n_hd).astype(np.int32)},
        "customer_address": {"ca_address_sk": np.arange(n_addr, dtype=np.int32),
                             "ca_state": rng.integers(0, 25, n_addr).astype(np.int32),
                             "ca_gmt": rng.integers(0, 6, n_addr).astype(np.int32)},
        "store": {"s_store_sk": np.arange(n_store, dtype=np.int32),
                  "s_city": rng.integers(0, 8, n_store).astype(np.int32),
                  "s_tax": rng.uniform(0, 0.1, n_store).astype(np.float32)},
        "promotion": {"p_promo_sk": np.arange(n_promo, dtype=np.int32),
                      "p_channel": rng.integers(0, 4, n_promo).astype(np.int32)},
    }
    edges = [("store_sales", "date_dim"), ("store_sales", "time_dim"),
             ("store_sales", "item"), ("store_sales", "customer"),
             ("store_sales", "store"), ("store_sales", "promotion"),
             ("customer", "customer_demographics"),
             ("customer", "household_demographics"),
             ("customer", "customer_address")]
    return Dataset("tpcds", S, tables, edges,
                   features_cont=["ss_sales_price", "ss_ext_discount", "i_price",
                                  "s_tax"],
                   features_cat=["d_year", "d_moy", "d_dow", "i_category", "i_brand",
                                 "cd_gender", "cd_marital", "cd_education",
                                 "hd_income_band", "hd_dep_count", "s_city",
                                 "p_channel", "ca_state", "ca_gmt", "t_hour",
                                 "c_preferred"],
                   label="ss_quantity", fact="store_sales")


MAKERS = {
    "favorita": make_favorita,
    "retailer": make_retailer,
    "yelp": make_yelp,
    "tpcds": make_tpcds,
}


def make(name: str, scale: float = 1.0, seed: Optional[int] = None) -> Dataset:
    kw = {} if seed is None else {"seed": seed}
    return MAKERS[name](scale=scale, **kw)

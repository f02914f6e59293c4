"""Retailer (LMFAO's snowflake; fact = Inventory) made on the device from
the seed, with the source's five relations and 43 attributes at its
published table sizes:

    Inventory(locn, dateid, ksn, inventoryunits)
    Items(ksn, subcategory, category, categoryCluster, prize)
    Location(locn, zip, rgn_cd, clim_zn_nbr, tot_area_sq_ft, sell_area_sq_ft,
             avghhi, supertargetdistance, supertargetdrivetime,
             targetdistance, targetdrivetime, walmartdistance,
             walmartdrivetime, walmartsupercenterdistance,
             walmartsupercenterdrivetime)
    Census(zip, population, white, asian, pacific, black, medianage,
           occupiedhouseunits, houseunits, families, households, husbwife,
           males, females, householdschildren, hispanic)
    Weather(locn, dateid, rain, snow, maxtemp, mintemp, meanwind, thunder)

Inventory joins Weather on (locn, dateid), Location on locn and Items on
ksn; Location joins Census on zip.  Every dimension table is keyed
densely: Weather's row ``locn·n_dateid + dateid``, Location's row
``locn``, Census's row ``zip``, Items's row ``ksn``.  The zipf skew of
locn and ksn and the label's dependence on a few features are the port's
``make_retailer``'s; every continuous attribute also has its bucket codes
(``<attr>__b``), the tree workload's split attributes.
"""

from __future__ import annotations

import torch

from cardbench.data._tables import (CATEGORICAL, CONTINUOUS, KEY, Tables,
                                    bucketize, generator, uniform_codes,
                                    zipf_codes)

#: each relation's continuous attributes: (name, mean, std), drawn normal
#: and folded to their absolute value (temperatures keep their sign)
CONT = {
    "Items": [("prize", 25, 10)],
    "Location": [("tot_area_sq_ft", 120_000, 40_000), ("sell_area_sq_ft", 90_000, 30_000),
                 ("avghhi", 60_000, 15_000), ("supertargetdistance", 8, 4),
                 ("supertargetdrivetime", 12, 5), ("targetdistance", 6, 3),
                 ("targetdrivetime", 10, 4), ("walmartdistance", 5, 3),
                 ("walmartdrivetime", 9, 4), ("walmartsupercenterdistance", 7, 4),
                 ("walmartsupercenterdrivetime", 11, 5)],
    "Census": [("population", 30_000, 12_000), ("white", 20_000, 9_000),
               ("asian", 1_500, 1_000), ("pacific", 60, 40), ("black", 4_000, 3_000),
               ("medianage", 38, 8), ("occupiedhouseunits", 11_000, 4_500),
               ("houseunits", 12_000, 5_000), ("families", 7_500, 3_000),
               ("households", 11_000, 4_500), ("husbwife", 5_500, 2_200),
               ("males", 15_000, 6_000), ("females", 15_000, 6_000),
               ("householdschildren", 3_800, 1_600), ("hispanic", 4_500, 4_000)],
    "Weather": [("maxtemp", 60, 20), ("mintemp", 42, 18), ("meanwind", 8, 4)],
}
#: each relation's categorical attributes
CAT = {"Items": ["subcategory", "category", "categoryCluster"],
       "Location": ["rgn_cd", "clim_zn_nbr"],
       "Weather": ["rain", "snow", "thunder"]}


def _draw(g, n: int, spec, device) -> dict:
    """One relation's continuous columns in one call."""
    mean = torch.tensor([m for _, m, _ in spec], device=device)
    std = torch.tensor([s for _, _, s in spec], device=device)
    x = torch.randn((len(spec), n), generator=g, device=device) * std[:, None] + mean[:, None]
    return {a: (x[i] if "temp" in a else x[i].abs()).contiguous()
            for i, (a, _, _) in enumerate(spec)}


def make(cfg: dict, seed: int, device) -> Tables:
    dom = cfg["domains"]
    n_date, n_locn, n_zip, n_ksn = (dom[k] for k in ("dateid", "locn", "zip", "ksn"))
    n_fact, nb, za = cfg["fact_rows"], cfg["n_buckets"], cfg["zipf_a"]
    g = generator(seed, device)
    codes = lambda n, d: uniform_codes(g, n, d, device)
    ar = lambda n: torch.arange(n, device=device, dtype=torch.int32)
    rows = {"Items": n_ksn, "Location": n_locn, "Census": n_zip,
            "Weather": n_locn * n_date}
    keys = {"Inventory": ["locn", "dateid", "ksn"], "Items": ["ksn"],
            "Location": ["locn", "zip"], "Census": ["zip"],
            "Weather": ["locn", "dateid"]}
    label = "inventoryunits"
    cont_all = [label] + [a for r in CONT for a, _, _ in CONT[r]]

    attrs = [("locn", KEY, n_locn), ("dateid", KEY, n_date), ("ksn", KEY, n_ksn),
             ("zip", KEY, n_zip)]
    attrs += [(a, CATEGORICAL, dom[a]) for r in CAT for a in CAT[r]]
    attrs += [(a, CONTINUOUS, 0) for a in cont_all]
    attrs += [(a + "__b", CATEGORICAL, nb) for a in cont_all]
    relations = [("Inventory", keys["Inventory"] + [label, label + "__b"])]
    relations += [(r, keys[r] + CAT.get(r, []) + [x for a, _, _ in CONT.get(r, [])
                                                  for x in (a, a + "__b")])
                  for r in ("Items", "Location", "Census", "Weather")]

    columns = {r: _draw(g, rows[r], CONT[r], device) for r in CONT}
    for r, names in CAT.items():
        columns[r].update({a: codes(rows[r], dom[a]) for a in names})
    w = torch.arange(rows["Weather"], device=device)
    columns["Weather"].update(locn=(w // n_date).to(torch.int32),
                              dateid=(w % n_date).to(torch.int32))
    columns["Items"]["ksn"] = ar(n_ksn)
    columns["Location"].update(locn=ar(n_locn), zip=codes(n_locn, n_zip))
    columns["Census"]["zip"] = ar(n_zip)

    f_locn = zipf_codes(g, n_fact, n_locn, za, device)
    f_date = codes(n_fact, n_date)
    f_ksn = zipf_codes(g, n_fact, n_ksn, za, device)
    cat_eff = torch.randn(dom["category"], generator=g, device=device) * 5.0
    fl, fk = f_locn.long(), f_ksn.long()
    pop = columns["Census"]["population"]
    items = columns["Items"]
    inv = (12.0 + 0.0004 * pop[columns["Location"]["zip"].long()[fl]]
           + cat_eff[items["category"].long()[fk]]
           + 0.1 * columns["Weather"]["maxtemp"][fl * n_date + f_date.long()]
           - 0.2 * items["prize"][fk]
           + torch.randn(n_fact, generator=g, device=device) * 4.0)
    del fl, fk
    columns["Inventory"] = {"locn": f_locn, "dateid": f_date, "ksn": f_ksn, label: inv}
    for r, cols in columns.items():
        for a in [a for a in cols if a in cont_all]:
            cols[a + "__b"] = bucketize(cols[a], nb)

    edges = [("Inventory", "Weather"), ("Inventory", "Location"),
             ("Location", "Census"), ("Inventory", "Items")]
    return Tables("retailer", attrs, relations, edges, fact="Inventory",
                  label=label,
                  features_cont=[a for a in cont_all if a != label],
                  features_cat=[a for r in CAT for a in CAT[r]],
                  columns=columns)

"""A regression tree fit's work by its definition: a pass over the join
a level (``info["levels"]``), each reading the split features', the
label's and the join keys' columns once; each joined row adds ``[1, y,
y²]`` to one bin of every split feature (three terms, a multiply and an
add each, a feature).  The output is each level's statistics in float32."""

from cardbench.metrics._roofline import bytes_read


def work(tables, info: dict):
    feats = tables.tree_features()
    used = set(feats) | {tables.label}
    n = tables.n_rows(tables.fact)      # every fact row joins one row of each dimension
    out = 4 * 3 * sum(info["frontier"]) * sum(tables.domain(a) for a in feats)
    return (info["levels"] * bytes_read(tables, used) + out,
            info["levels"] * n * len(feats) * 3 * 2)

"""The covar job's work by its definition: one pass over the join reads
the label's and the features' columns and the join keys once, and each
joined row's design vector ``[1 | continuous | one-hot | label]`` has
``nz = 2 + n_cont + n_cat`` non-zeros, whose ``nz·(nz + 1)/2`` products
(a multiply and an add each) make the upper triangle of ``XᵀX``.  The
output is that triangle in float32."""

from cardbench.metrics._roofline import bytes_read


def work(tables, info: dict):
    used = set(tables.features_cont) | set(tables.features_cat) | {tables.label}
    nz = 2 + len(tables.features_cont) + len(tables.features_cat)
    p = 2 + len(tables.features_cont) + sum(tables.domain(a) for a in tables.features_cat)
    n = tables.n_rows(tables.fact)      # every fact row joins one row of each dimension
    return (bytes_read(tables, used) + 4 * p * (p + 1) // 2,
            n * nz * (nz + 1))

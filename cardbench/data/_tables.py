"""What a data maker returns, and the samplers the makers share.

A data maker builds one configuration's tables on the device from the seed,
with nothing made on the host but a few small constant tables (the zipf
probabilities).  Its output is plain: attribute kinds and domains,
relations, the join tree's edges, the model's features, and the columns as
device tensors (int32 codes, float32 values).  The program and the
reference are both handed these same tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch

KEY, CATEGORICAL, CONTINUOUS = "key", "categorical", "continuous"


@dataclasses.dataclass
class Tables:
    name: str
    attrs: List[Tuple[str, str, int]]            # (name, kind, domain)
    relations: List[Tuple[str, List[str]]]       # (name, attributes)
    edges: List[Tuple[str, str]]                 # join tree, parent first
    fact: str
    label: str
    features_cont: List[str]
    features_cat: List[str]
    columns: Dict[str, Dict[str, torch.Tensor]]

    def kind(self, attr: str) -> str:
        return next(k for a, k, _ in self.attrs if a == attr)

    def domain(self, attr: str) -> int:
        return next(d for a, _, d in self.attrs if a == attr)

    def rel_attrs(self, rel: str) -> List[str]:
        return next(list(a) for r, a in self.relations if r == rel)

    def n_rows(self, rel: str) -> int:
        return int(next(iter(self.columns[rel].values())).shape[0])

    def bucket_attr(self, attr: str) -> str:
        return attr + "__b"

    def tree_features(self) -> List[str]:
        """The split attributes of a regression tree on the label: each
        continuous feature's bucket codes, then the categorical features."""
        return ([self.bucket_attr(c) for c in self.features_cont
                 if any(a == self.bucket_attr(c) for a, _, _ in self.attrs)]
                + list(self.features_cat))


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def uniform_codes(g, n: int, domain: int, device) -> torch.Tensor:
    return torch.randint(0, domain, (n,), generator=g, device=device,
                         dtype=torch.int32)


def normal(g, n: int, mean: float, std: float, device) -> torch.Tensor:
    return torch.randn(n, generator=g, device=device) * std + mean


def zipf_codes(g, n: int, domain: int, a: float, device) -> torch.Tensor:
    """``(z - 1) % domain`` for ``z`` drawn from Zipf(``a``), as numpy's
    ``rng.zipf`` draws it: code ``c`` has probability
    ``Σ_k (c + 1 + k·domain)^-a / ζ(a)``, the Hurwitz zeta
    ``domain^-a · ζ(a, (c + 1) / domain) / ζ(a)``.  Drawn by inverting the
    code's distribution function on uniform numbers."""
    q = (torch.arange(domain, dtype=torch.float64) + 1) / domain
    p = torch.special.zeta(torch.full_like(q, a), q) * domain ** -a
    cdf = torch.cumsum(p / p.sum(), 0).to(device)
    u = torch.rand(n, generator=g, device=device, dtype=torch.float64)
    return torch.searchsorted(cdf, u, right=True).clamp_(max=domain - 1).to(
        torch.int32)


def bucketize(x: torch.Tensor, n: int) -> torch.Tensor:
    """numpy's ``searchsorted(quantile(x, linspace(0, 1, n + 1)[1:-1]), x)``:
    the ``n - 1`` inner quantiles by numpy's linear interpolation between
    order statistics (its virtual index and ``lerp``, to the last bit), then
    each value's bucket (the count of quantiles below it)."""
    s = torch.sort(x.double()).values
    m = s.shape[0]
    q = torch.tensor([i * (1.0 / n) for i in range(1, n)], dtype=torch.float64,
                     device=x.device)
    virt = m * q - q
    lo = virt.floor()
    t = virt - lo
    lo = lo.long().clamp(0, m - 1)
    a, b = s[lo], s[(lo + 1).clamp(max=m - 1)]
    qs = torch.where(t >= 0.5, b - (b - a) * (1 - t), a + (b - a) * t)
    return torch.searchsorted(qs, x.double()).to(torch.int32)

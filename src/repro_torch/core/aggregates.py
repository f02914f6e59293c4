"""The LMFAO aggregate DSL with a torch evaluator; counterpart of
``repro/core/aggregates.py``.

Every aggregate is  α = Σ_{j∈[s]} Π_{k∈[p_j]} f_jk  (paper §1.1).  Terms
evaluate against an *environment* mapping attribute names to broadcastable
tensors; the executor provides row columns and pulled-up domain axes through
the same interface, so a term never knows whether its attribute is a scanned
column or a pulled group-by dimension.

The dataclasses and their ``key()`` values are the reference's, so view
merging produces the same views.  ``Lambda.fn`` receives torch tensors here:
a Lambda written for the reference (jnp code) is rebuilt for the port with
the same ``tag``, which keeps its key equal.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, FrozenSet, Mapping, Sequence, Tuple

import torch

Env = Mapping[str, torch.Tensor]
Params = Mapping[str, object]


@dataclasses.dataclass(frozen=True)
class Param:
    """Reference to a runtime parameter (dynamic UDAF input).  ``batched``
    declares a leading param-batch (node) axis; the port does not run such
    plans yet."""

    name: str
    batched: bool = False


def _resolve(v, params: Params):
    if isinstance(v, Param):
        return params[v.name]
    return v


class Term:
    """A function f(attrs...) appearing in a product."""

    def attrs(self) -> FrozenSet[str]:
        raise NotImplementedError

    def evaluate(self, env: Env, params: Params) -> torch.Tensor:
        raise NotImplementedError

    def params(self) -> Tuple[Param, ...]:
        """The runtime :class:`Param` references this term resolves."""
        return ()

    def is_batched(self) -> bool:
        """True if any referenced param carries the param-batch axis."""
        return any(p.batched for p in self.params())

    def key(self) -> Tuple:
        """Structural identity for view merging/dedup."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Constant(Term):
    value: object = 1.0  # float or Param

    def attrs(self) -> FrozenSet[str]:
        return frozenset()

    def evaluate(self, env: Env, params: Params) -> torch.Tensor:
        return torch.as_tensor(_resolve(self.value, params), dtype=torch.float32)

    def params(self) -> Tuple[Param, ...]:
        return (self.value,) if isinstance(self.value, Param) else ()

    def key(self) -> Tuple:
        return ("const", self.value)


@dataclasses.dataclass(frozen=True)
class Var(Term):
    """Identity f(X) = X."""

    attr: str

    def attrs(self) -> FrozenSet[str]:
        return frozenset([self.attr])

    def evaluate(self, env: Env, params: Params) -> torch.Tensor:
        return env[self.attr].to(torch.float32)

    def key(self) -> Tuple:
        return ("var", self.attr)


@dataclasses.dataclass(frozen=True)
class Pow(Term):
    """f(X) = X**k."""

    attr: str
    k: int

    def attrs(self) -> FrozenSet[str]:
        return frozenset([self.attr])

    def evaluate(self, env: Env, params: Params) -> torch.Tensor:
        return env[self.attr].to(torch.float32) ** self.k

    def key(self) -> Tuple:
        return ("pow", self.attr, self.k)


_OPS: Dict[str, Callable] = {
    "<=": lambda x, t: x <= t,
    "<": lambda x, t: x < t,
    ">=": lambda x, t: x >= t,
    ">": lambda x, t: x > t,
    "==": lambda x, t: x == t,
    "!=": lambda x, t: x != t,
}


@dataclasses.dataclass(frozen=True)
class Delta(Term):
    """Kronecker delta 1[X op t] — selection conditions / decision-tree nodes.
    ``threshold`` is a Python scalar or an unbatched :class:`Param`."""

    attr: str
    op: str
    threshold: object

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"unknown op {self.op!r}")

    def attrs(self) -> FrozenSet[str]:
        return frozenset([self.attr])

    def evaluate(self, env: Env, params: Params) -> torch.Tensor:
        return _OPS[self.op](env[self.attr],
                             _resolve(self.threshold, params)).to(torch.float32)

    def params(self) -> Tuple[Param, ...]:
        return (self.threshold,) if isinstance(self.threshold, Param) else ()

    def key(self) -> Tuple:
        return ("delta", self.attr, self.op, self.threshold)


@dataclasses.dataclass(frozen=True)
class Lambda(Term):
    """Generic UDAF over one or more attributes: f(X_a, X_b, ...).

    ``fn`` receives broadcastable torch tensors in ``attr_order`` and the
    params dict.  ``tag`` provides structural identity (callables do not hash
    stably across sessions); ``invertible`` is carried for key equality with
    the reference."""

    attr_order: Tuple[str, ...]
    fn: Callable
    tag: str = ""
    param_refs: Tuple[Param, ...] = ()
    invertible: bool = True

    def attrs(self) -> FrozenSet[str]:
        return frozenset(self.attr_order)

    def evaluate(self, env: Env, params: Params) -> torch.Tensor:
        out = self.fn(*[env[a] for a in self.attr_order], params)
        return torch.as_tensor(out).to(torch.float32)

    def params(self) -> Tuple[Param, ...]:
        return self.param_refs

    def key(self) -> Tuple:
        return ("lambda", self.attr_order, self.tag or id(self.fn),
                tuple((p.name, p.batched) for p in self.param_refs),
                self.invertible)


@dataclasses.dataclass(frozen=True)
class ProductAgg:
    """One product Π_k f_k — the unit pushed through the join tree."""

    terms: Tuple[Term, ...] = ()

    def attrs(self) -> FrozenSet[str]:
        out: FrozenSet[str] = frozenset()
        for t in self.terms:
            out |= t.attrs()
        return out

    def key(self) -> Tuple:
        return tuple(sorted((t.key() for t in self.terms), key=repr))


@dataclasses.dataclass(frozen=True)
class Aggregate:
    """α = Σ_j products_j  (sum of products)."""

    products: Tuple[ProductAgg, ...]

    def attrs(self) -> FrozenSet[str]:
        out: FrozenSet[str] = frozenset()
        for p in self.products:
            out |= p.attrs()
        return out

    def key(self) -> Tuple:
        return tuple(p.key() for p in self.products)


def agg(*terms: Term) -> Aggregate:
    """Single-product aggregate Σ Π terms (the common case: count, sum, covar)."""
    return Aggregate((ProductAgg(tuple(terms)),))


COUNT = agg()  # SUM(1)


def sum_of(attr: str) -> Aggregate:
    return agg(Var(attr))


def sum_sq(attr: str) -> Aggregate:
    return agg(Pow(attr, 2))


def sum_prod(a1: str, a2: str) -> Aggregate:
    if a1 == a2:
        return sum_sq(a1)
    return agg(Var(a1), Var(a2))


@dataclasses.dataclass(frozen=True)
class Query:
    """Q(F_1,...,F_f ; α_1,...,α_ℓ) += R_1 ⋈ ... ⋈ R_m   (paper eq. (1)).

    ``group_by`` attributes must be discrete (dictionary-encoded); the output
    is a dense tensor over their code domains with a trailing aggregate axis.
    """

    name: str
    group_by: Tuple[str, ...]
    aggregates: Tuple[Aggregate, ...]

    def __post_init__(self):
        if len(set(self.group_by)) != len(self.group_by):
            raise ValueError(f"query {self.name!r}: duplicate group-by attrs")

    def all_attrs(self) -> FrozenSet[str]:
        out = frozenset(self.group_by)
        for a in self.aggregates:
            out |= a.attrs()
        return out


def query(name: str, group_by: Sequence[str], aggregates: Sequence[Aggregate]) -> Query:
    return Query(name, tuple(group_by), tuple(aggregates))

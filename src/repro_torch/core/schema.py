"""Copy of ``repro/core/schema.py`` for the PyTorch port: identical apart
from imports, so that the port compiles the same plans without importing
the JAX package.

Database schema: attributes, relation schemas, and the attribute registry.

LMFAO operates over a database of named relations whose attributes are either
join keys, categorical (dictionary-encoded to ``[0, domain)`` int32 codes), or
continuous (float32).  Dense code domains are the TPU-native replacement for
LMFAO's sorted-relation tries and hashmaps (DESIGN.md §2): joins become gathers
and group-bys become segment reductions over integer codes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

KEY = "key"
CATEGORICAL = "categorical"
CONTINUOUS = "continuous"

_KINDS = (KEY, CATEGORICAL, CONTINUOUS)


@dataclasses.dataclass(frozen=True)
class Attribute:
    """A database attribute.

    ``domain`` is the number of distinct dictionary codes for key/categorical
    attributes; it is ignored (0) for continuous attributes.
    """

    name: str
    kind: str
    domain: int = 0

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown attribute kind {self.kind!r}")
        if self.kind in (KEY, CATEGORICAL) and self.domain <= 0:
            raise ValueError(f"attribute {self.name!r}: {self.kind} needs domain > 0")

    @property
    def is_discrete(self) -> bool:
        return self.kind in (KEY, CATEGORICAL)


@dataclasses.dataclass(frozen=True)
class RelationSchema:
    """Named relation with an ordered attribute list."""

    name: str
    attrs: Tuple[str, ...]

    def __post_init__(self) -> None:
        if len(set(self.attrs)) != len(self.attrs):
            raise ValueError(f"relation {self.name!r} has duplicate attributes")

    @property
    def attr_set(self) -> frozenset:
        return frozenset(self.attrs)


class DatabaseSchema:
    """Attribute registry + relation schemas; the static input to the engine."""

    def __init__(self, attributes: Iterable[Attribute], relations: Iterable[RelationSchema]):
        self.attributes: Dict[str, Attribute] = {a.name: a for a in attributes}
        self.relations: Dict[str, RelationSchema] = {r.name: r for r in relations}
        for r in self.relations.values():
            for a in r.attrs:
                if a not in self.attributes:
                    raise ValueError(f"relation {r.name!r} references unknown attribute {a!r}")

    def attr(self, name: str) -> Attribute:
        return self.attributes[name]

    def relation(self, name: str) -> RelationSchema:
        return self.relations[name]

    def shared_attrs(self, r1: str, r2: str) -> frozenset:
        return self.relations[r1].attr_set & self.relations[r2].attr_set

    def relations_with(self, attr: str) -> List[str]:
        return [r.name for r in self.relations.values() if attr in r.attr_set]

    def domain(self, attr: str) -> int:
        a = self.attributes[attr]
        if not a.is_discrete:
            raise ValueError(f"attribute {attr!r} is continuous; no domain")
        return a.domain

    def all_attrs(self) -> List[str]:
        return list(self.attributes)

    def validate(self) -> None:
        """Sanity: every attribute appears in at least one relation."""
        seen = set()
        for r in self.relations.values():
            seen |= r.attr_set
        missing = set(self.attributes) - seen
        if missing:
            raise ValueError(f"attributes not used by any relation: {sorted(missing)}")


def schema(attr_specs: Sequence[Tuple[str, str, int]],
           relation_specs: Sequence[Tuple[str, Sequence[str]]]) -> DatabaseSchema:
    """Terse constructor: ``schema([("date", "key", 366), ...], [("Sales", [...]), ...])``."""
    attrs = [Attribute(n, k, d) for (n, k, d) in attr_specs]
    rels = [RelationSchema(n, tuple(a)) for (n, a) in relation_specs]
    s = DatabaseSchema(attrs, rels)
    s.validate()
    return s

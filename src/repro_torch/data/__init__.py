"""Data substrate of the port: device-resident columnar relations, update
batches and the synthetic dataset generators."""

from repro_torch.data.relations import (Database, DeltaBatchUpdate, Relation,
                                        RelationDelta, ResidentRelation,
                                        apply_delta, from_numpy, sort_by)

__all__ = ["Database", "DeltaBatchUpdate", "Relation", "RelationDelta",
           "ResidentRelation", "apply_delta", "from_numpy", "sort_by"]

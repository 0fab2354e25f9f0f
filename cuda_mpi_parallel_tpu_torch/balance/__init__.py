"""balance: imbalance-aware partition planning.

Counterpart of the JAX package's ``balance`` package, host numpy, its
own copy (the port imports nothing of the JAX package).

The feedback loop the ROADMAP's "imbalance-aware repartitioning" item
asked for: ``telemetry.shardscope`` measures per-shard nnz/halo skew at
partition time; this package feeds the measurement BACK into how the
partition is cut, so skewed unstructured systems stop stalling every
``psum`` behind their heaviest shard.

* :mod:`.nnz_split` - contiguous balanced-nnz row splitting (exact
  chains-on-chains bottleneck via prefix-sum probing + boundary
  refinement), variable real rows per shard under the partitioners'
  common padded slot count;
* :mod:`.reorder` - SPD-preserving symmetric permutations (RCM
  bandwidth reduction; a greedy nnz-aware envelope ordering) that
  shrink the cross-shard coupling a contiguous cut has to pay;
* :mod:`.plan` - :class:`PartitionPlan` and :func:`plan_partition`,
  which enumerates (reorder x split) candidates, scores each with
  shardscope's static accounting joined to the roofline comm model,
  and returns the minimizer.

Consumption: ``solve_distributed(..., plan="auto" | PartitionPlan)``
and ``solve_distributed_df64(..., plan=...)`` thread a plan through
the CSR partitioners (``parallel.partition`` honors
``row_ranges=``), key the solver cache on the plan fingerprint, and
scatter the solution back through the inverse permutation; ``plan=None`` is bit-identical to the legacy even split.
All host-side numpy - a plan never touches device state.
"""
from .nnz_split import balanced_nnz_ranges, even_ranges, validate_ranges
from .plan import (
    GREEDY_REORDER_LIMIT,
    PartitionPlan,
    plan_partition,
    reference_model,
    score_report,
)
from .reorder import (
    greedy_nnz_reorder,
    inverse_permutation,
    rcm_reorder,
)

__all__ = [
    "GREEDY_REORDER_LIMIT",
    "PartitionPlan",
    "balanced_nnz_ranges",
    "even_ranges",
    "greedy_nnz_reorder",
    "inverse_permutation",
    "plan_partition",
    "rcm_reorder",
    "reference_model",
    "score_report",
    "validate_ranges",
]

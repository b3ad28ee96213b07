"""Programmable H-tree NoC (§III-D) and its mapping onto mesh collectives.

The physical chip connects 4096 cores through a radix-4 H-tree (1365
routers) to a co-processor.  Each router has one config bit:

    1 = accumulate   incoming leaf flits are summed before forwarding
                     (regression / binary classification, Fig. 7a)
    0 = forward      flits pass through untouched; the CP reduces
                     globally (multiclass, Fig. 7b)

Input batching (Fig. 7c) replicates the model across core groups and sets
the bits to accumulate *below* the replication boundary and forward above
it.

On the TPU mesh, the same three programs become collective plans:
  accumulate        -> psum over the `model` axis (ICI all-reduce is an
                       in-network reduction tree, like the H-tree)
  forward           -> per-class partial sums kept as channels; one psum
                       of the (B, n_classes) block (numerically identical,
                       but the traffic model differs — more flits/sample)
  batch             -> table replicated; batch sharded over `model` too;
                       no cross-core reduction (replica groups)
  hybrid            -> the 2-D batch × core program for large meshes: rows
                       shard over `model` AND the batch over every axis;
                       queries all-gather along `model` into each row
                       shard, partial margins psum_scatter back — an
                       all-reduce split into its gather/reduce-scatter
                       halves so no device ever holds a replicated output
                       block.  (A mesh-level extension of Fig. 7c, not a
                       router program the 1365-router chip can express —
                       shard_map only, see DESIGN.md §8.)

This module computes the router program + traffic statistics for the perf
model, and the collective plan used by ``XTimeEngine``.

A copy of ``repro.core.noc``: the port imports nothing of ``repro``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.compile import CAMTable, ChipSpec, CorePlacement

# engine noc_config -> the explicit collective(s) the shard_map path
# issues over the row axis (introspection for benches/examples/docs)
ENGINE_COLLECTIVES = {
    "accumulate": "psum",
    "batch": "none (replica groups)",
    "hybrid": "all_gather + psum_scatter",
}


@dataclass
class NoCPlan:
    config: str  # 'accumulate' | 'forward' | 'batch'
    n_levels: int  # H-tree depth
    router_bits: list[int]  # per level, 1=accumulate 0=forward
    n_classes: int
    replication: int
    flits_per_sample_per_level: list[float]  # upward traffic at each level
    engine_noc_config: str  # XTimeEngine noc_config string
    reduction_axes: tuple[str, ...]  # mesh axes the reduction spans

    @property
    def flits_per_sample(self) -> float:
        return float(sum(self.flits_per_sample_per_level))

    @property
    def cp_ops_per_sample(self) -> int:
        """Reduction work left for the co-processor."""
        if self.config == "forward":
            # class-wise sums over the forwarded streams + argmax
            return self.n_classes + 1
        return 1  # threshold compare / identity


def plan_noc(
    table: CAMTable,
    placement: CorePlacement,
    *,
    spec: ChipSpec | None = None,
    batching: bool = True,
) -> NoCPlan:
    """Derive the router program for a compiled + placed model."""
    spec = spec or placement.spec
    n_levels = int(round(np.log(spec.n_cores) / np.log(spec.noc_radix)))
    n_used = placement.n_cores_used
    repl = placement.replication if batching else 1

    multiclass = table.task == "multiclass" or (
        table.kind == "rf" and table.n_outputs > 1
    )

    if multiclass:
        # Fig. 7(b): logits of *different* classes cannot be summed in a
        # router.  The compiler places same-class trees in contiguous core
        # subtrees, accumulates inside each class subtree (bits=1) and
        # forwards the n_classes streams above it (bits=0) — this yields
        # the paper's stated throughput bound of 1/N_classes samples per
        # clock at the root.
        config = "forward"
        cores_per_class = max(1, int(np.ceil(n_used / max(1, table.n_outputs))))
        boundary = int(np.ceil(np.log(cores_per_class) / np.log(spec.noc_radix)))
        boundary = min(boundary, n_levels)
        bits = [1] * boundary + [0] * (n_levels - boundary)
        # per-level upward flits per sample on the busiest link
        flits = [1.0] * boundary + [float(table.n_outputs)] * (n_levels - boundary)
        engine_cfg = "accumulate"  # numerics: per-class channels then psum
    elif repl > 1 and batching:
        # Fig. 7(c): accumulate below the replication boundary, forward above.
        config = "batch"
        boundary = max(1, int(np.ceil(np.log(max(1, n_used)) / np.log(spec.noc_radix))))
        bits = [1] * boundary + [0] * (n_levels - boundary)
        flits = [1.0] * boundary + [1.0] * (n_levels - boundary)
        engine_cfg = "batch"
    else:
        # Fig. 7(a): pure accumulate.
        config = "accumulate"
        bits = [1] * n_levels
        flits = [1.0] * n_levels  # one running-sum flit per router output
        engine_cfg = "accumulate"
    return NoCPlan(
        config=config,
        n_levels=n_levels,
        router_bits=bits,
        n_classes=table.n_outputs,
        replication=repl,
        flits_per_sample_per_level=flits,
        engine_noc_config=engine_cfg,
        reduction_axes=("model",) if engine_cfg != "batch" else (),
    )

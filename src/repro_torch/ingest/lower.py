"""Threshold-grid lowering: ``ImportedEnsemble`` -> binned ``Ensemble``.

The paper's §III-B mapping, run in reverse of the native training path:
instead of quantile-binning data and training on bins, the imported
model's OWN split points become the per-feature grid
(``FeatureQuantizer.from_thresholds``), every float split ``x < v`` is
rewritten as the bin split ``bin < t`` with ``edges[t-1] == v``, and the
result is the exact ``Ensemble`` the X-TIME compiler already ingests.
On an unmerged grid the lowering is bit-exact:

    lowered.raw_margin(quantizer.transform(x)) == imported.raw_margin(x)

for every finite float query ``x`` (same float32 leaf values, same
float64 accumulation order).  When a feature carries more distinct
thresholds than the grid has edges, thresholds are merged
(nearest-edge remap) or the model is rejected — ``IngestReport``
records per-feature occupancy and every merged/remapped split, and
``repro_torch.build`` attaches it to the artifact sidecar.

Per-channel base scores lower exactly: a uniform base becomes
``Ensemble.base_score`` (added once post-reduction by the engine), and
non-uniform bases become one single-leaf bias tree per nonzero channel
— an all-wildcard CAM row that matches every query.

A copy of ``repro.ingest.lower``: the port imports nothing of ``repro``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.quantize import FeatureQuantizer
from repro_torch.core.trees import Ensemble, Tree
from repro_torch.ingest.ir import ImportedEnsemble, IngestError


@dataclass
class IngestReport:
    """Validation record of one lowering — serialized into the artifact
    sidecar so a served model carries its own provenance."""

    source: str  # importer that produced the IR
    source_kind: str  # gbdt | rf | dart
    task: str
    n_trees: int  # trees in the lowered ensemble (incl. bias/replicas)
    n_source_trees: int  # trees in the dump
    n_features: int
    n_bins: int
    exact: bool  # True => binned == float inference bit-for-bit
    merged_thresholds: int  # grid edges dropped to fit n_bins
    remapped_splits: int  # tree splits moved to a nearest kept edge
    bias_rows: int  # wildcard rows realizing per-channel base scores
    # per feature: {"feature", "thresholds", "capacity", "merged"}
    grid: list[dict] = field(default_factory=list)
    notes: list[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "source": self.source,
            "source_kind": self.source_kind,
            "task": self.task,
            "n_trees": self.n_trees,
            "n_source_trees": self.n_source_trees,
            "n_features": self.n_features,
            "n_bins": self.n_bins,
            "exact": self.exact,
            "merged_thresholds": self.merged_thresholds,
            "remapped_splits": self.remapped_splits,
            "bias_rows": self.bias_rows,
            "grid": self.grid,
            "notes": list(self.notes),
        }

    def occupancy_summary(self) -> str:
        used = [g for g in self.grid if g["thresholds"]]
        if not used:
            return "no splits"
        peak = max(g["thresholds"] for g in used)
        return (f"{len(used)}/{self.n_features} features split, "
                f"peak {peak}/{self.n_bins - 1} edges"
                + ("" if self.exact else
                   f", {self.remapped_splits} splits remapped (INEXACT)"))


def lower_to_ensemble(
    imported: ImportedEnsemble,
    n_bins: int = 256,
    on_overflow: str = "merge",
) -> tuple[Ensemble, FeatureQuantizer, IngestReport]:
    """Lower a parsed model onto an ``n_bins`` grid built from its own
    thresholds.  Returns ``(ensemble, quantizer, report)``."""
    thresholds = imported.thresholds_per_feature()
    try:
        quantizer, merged = FeatureQuantizer.from_thresholds(
            thresholds, n_bins=n_bins, on_overflow=on_overflow
        )
    except ValueError as e:
        raise IngestError(f"{imported.source}: {e}") from None

    remapped = 0
    trees: list[Tree] = []
    for tree in imported.trees:
        bin_t = np.zeros(tree.n_nodes, dtype=np.int32)
        for j in np.flatnonzero(tree.feature >= 0):
            t, exact = quantizer.bin_of_threshold(
                int(tree.feature[j]), float(tree.threshold[j])
            )
            bin_t[j] = t
            remapped += not exact
        trees.append(Tree(
            feature=tree.feature.copy(),
            threshold=bin_t,
            left=tree.left.copy(),
            right=tree.right.copy(),
            value=tree.value.astype(np.float32),
        ))
    tree_class = imported.tree_class.copy()

    # base scores: scalar if uniform, wildcard bias rows otherwise
    bias_rows = 0
    if imported.uniform_base:
        base = float(imported.base_score[0])
    else:
        base = 0.0
        from repro_torch.ingest.ir import single_leaf_tree

        bias_classes = []
        for c in range(imported.n_outputs):
            if imported.base_score[c] != 0.0:
                bias = single_leaf_tree(float(imported.base_score[c]))
                trees.append(Tree(
                    feature=bias.feature, threshold=np.zeros(1, np.int32),
                    left=bias.left, right=bias.right,
                    value=bias.value.astype(np.float32),
                ))
                bias_classes.append(c)
                bias_rows += 1
        tree_class = np.concatenate(
            [tree_class, np.asarray(bias_classes, dtype=np.int32)]
        )

    ensemble = Ensemble(
        trees=trees,
        n_features=imported.n_features,
        n_bins=quantizer.n_bins,
        task=imported.task,  # type: ignore[arg-type]
        kind="gbdt",  # imported margins are always sums (ir.py docstring)
        n_classes=imported.n_classes,
        tree_class=tree_class,
        base_score=base,
        leaf_class_mode="tree",
        n_outputs_override=imported.n_outputs,
    )

    cap = quantizer.n_bins - 1
    report = IngestReport(
        source=imported.source,
        source_kind=imported.source_kind,
        task=imported.task,
        n_trees=len(trees),
        n_source_trees=imported.n_trees,
        n_features=imported.n_features,
        n_bins=quantizer.n_bins,
        exact=(remapped == 0),
        merged_thresholds=int(sum(merged)),
        remapped_splits=remapped,
        bias_rows=bias_rows,
        grid=[
            {"feature": f, "thresholds": int(th.shape[0]), "capacity": cap,
             "merged": int(m)}
            for f, (th, m) in enumerate(zip(thresholds, merged))
        ],
        notes=list(imported.notes),
    )
    return ensemble, quantizer, report

"""Synthetic tabular datasets shaped like the paper's benchmarks (Table II)."""

from repro_torch.data.tabular import (  # noqa: F401
    PAPER_DATASETS,
    TabularDataset,
    accuracy_metric,
    make_dataset,
)

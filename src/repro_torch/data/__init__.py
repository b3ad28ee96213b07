"""Data pipelines: synthetic tabular datasets shaped like the paper's
benchmarks (Table II), and the deterministic, resumable synthetic token
and embedding pipelines of the LM half (copies of the JAX package's)."""

from repro_torch.data.tabular import (  # noqa: F401
    PAPER_DATASETS,
    TabularDataset,
    accuracy_metric,
    make_dataset,
)
from repro_torch.data.tokens import EmbeddingPipeline, TokenPipeline  # noqa: F401

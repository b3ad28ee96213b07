"""Partition specs and placement on a mesh: the port of ``repro.sharding``."""

from repro_torch.sharding.partition import (  # noqa: F401
    MeshAxes,
    P,
    attach,
    batch_pspec,
    cache_pspecs,
    param_pspecs,
)

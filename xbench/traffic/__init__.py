"""Traffic drivers, one module a kind, found by the cell's ``traffic.kind``."""

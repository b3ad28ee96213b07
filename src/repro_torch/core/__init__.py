"""Host-side model, compiler and engine of the port (see repro_torch)."""

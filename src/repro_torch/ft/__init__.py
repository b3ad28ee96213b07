"""Fault-tolerance runtime of the port (see ``repro_torch.ft.runtime``)."""

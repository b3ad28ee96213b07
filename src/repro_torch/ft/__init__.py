"""Fault-tolerance runtime of the port: heartbeats, stragglers and the
checkpoint/restart runner (see ``repro_torch.ft.runtime``)."""

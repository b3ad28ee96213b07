"""Measurement and smoke scripts: ``widths`` finds the widest table each
CUDA kernel variant launches, on the card, and ``compress_time`` times the
compression pass on the host at the full width of xtime-tabular (each run
as a file, ``python3 src/repro_torch/tools/<name>.py``);
``paper_scale_smoke`` checks that compression fits a paper-scale ensemble
onto an 8-shard mesh (``python -m repro_torch.tools.paper_scale_smoke``).
Nothing runs at import."""

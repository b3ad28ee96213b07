"""Measurement scripts, each run as a file (``python3 src/repro_torch/tools/<name>.py``):
``widths`` finds the widest table each CUDA kernel variant launches, on the
card; ``compress_time`` times the compression pass on the host at the full
width of xtime-tabular.  Nothing runs at import."""

"""Seconds of ``repro_torch.build`` (the host compile), on the host clock
around the call in the harness."""


def read(rec):
    return rec.timings["build_s"]

"""Seconds of the program's first engine bind, upload included, on the host
clock around the call, ending in a synchronise."""


def read(rec):
    return rec.timings["bind_s"]

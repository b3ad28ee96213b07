"""The benchmark's readers of the port's spans
(``xbench/metrics/{chunk,call}_*``, ``stage_hits.loop``): each on
hand-made ``totals()``, None where the spans are absent, where their
count is not the run's counter, where the run was not traced or the
program has no spans module; and a traced
run of a small bulk and loop cell on the CPU, through the harness, in
which each reads a finite value that its parts do not exceed."""

import math
import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from xbench import harness  # noqa: E402

MS = 1_000_000  # ns


def agg(count, total_ms):
    return {"count": count, "total_ns": int(total_ms * MS), "self_ns": 0, "parents": {}}


BULK = {"score.chunk": agg(4, 20.0), "score.prep": agg(4, 6.0), "score.stage": agg(4, 2.0),
        "score.wait": agg(4, 8.0)}
LOOP = {"api.raw_margin": agg(5, 10.0), "engine.prep": agg(5, 2.0),
        "engine.launch": agg(5, 1.0), "api.fetch": agg(5, 4.0)}
STAGE = {"engine.stage": agg(5, 0.5), "engine.stage_alloc": agg(1, 0.1)}
# metric -> (hand-made totals, driver counter, its value, the spans it reads)
CASES = {
    "chunk_host_ms.bulk": (BULK, "chunks", (20.0 - 8.0) / 4, ("score.chunk", "score.wait")),
    "chunk_prep_ms.bulk": (BULK, "chunks", 6.0 / 4, ("score.prep",)),
    "chunk_stage_ms.bulk": (BULK, "chunks", 2.0 / 4, ("score.stage",)),
    "call_host_ms.loop": (LOOP, "calls", (10.0 - 4.0) / 5, ("api.raw_margin", "api.fetch")),
    "call_prep_ms.loop": (LOOP, "calls", 2.0 / 5, ("engine.prep",)),
    "call_launch_ms.loop": (LOOP, "calls", 1.0 / 5, ("engine.launch",)),
    "stage_hits.loop": (STAGE, "calls", 100.0 * (5 - 1) / 5, ("engine.stage",)),
}


def record(counters, traced=True):
    return harness.Record(cfg={}, cell={}, timings={}, counters=counters,
                          trace=object() if traced else None)


def with_totals(monkeypatch, t):
    import repro_torch.spans

    monkeypatch.setattr(repro_torch.spans, "totals", lambda: t)


@pytest.mark.parametrize("metric", sorted(CASES))
def test_reader_on_hand_made_totals(metric, monkeypatch):
    t, counter, want, _ = CASES[metric]
    n = t[next(iter(t))]["count"]
    with_totals(monkeypatch, t)
    assert harness.reader(metric)(record({counter: n})) == pytest.approx(want)


@pytest.mark.parametrize("fault", ["absent", "count", "untraced", "no_counter", "no_module"])
@pytest.mark.parametrize("metric", sorted(CASES))
def test_reader_finds_nothing(metric, fault, monkeypatch):
    t, counter, _, reads = CASES[metric]
    n = t[next(iter(t))]["count"]
    counters = {counter: n}
    if fault == "absent":  # each span it reads left out in turn
        for name in reads:
            with_totals(monkeypatch, {k: v for k, v in t.items() if k != name})
            assert harness.reader(metric)(record(counters)) is None
        return
    with_totals(monkeypatch, t)
    if fault == "count":
        counters = {counter: n + 1}
    elif fault == "no_counter":
        counters = {}
    elif fault == "no_module":  # a program without spans: the import fails
        monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    assert harness.reader(metric)(record(counters, traced=fault != "untraced")) is None


def test_stage_hits_reads_100_where_no_slot_grew(monkeypatch):
    with_totals(monkeypatch, {"engine.stage": agg(7, 0.7)})
    assert harness.reader("stage_hits.loop")(record({"calls": 7})) == 100.0


TINY = {"name": "tiny", "n_trees": 24, "depth": 4, "n_bins": 256, "kind": "gbdt",
        "leaf_scale": 0.1, "base_score": 0.5, "mode": "direct", "table_dtype": "uint8",
        "kernel_mode": "inclusive", "n_features": 12, "task": "multiclass", "n_classes": 3}
SMALL = {"f130.bulk": {"rows": 3000, "chunk_rows": 512, "sample_rows": 64},
         "f130.loop": {"batch": 64, "pool_batches": 4, "sample_share": 0.3, "sample_max": 64}}
PARTS = {"f130.bulk": ("chunk_host_ms.bulk", "chunk_prep_ms.bulk", "chunk_stage_ms.bulk"),
         "f130.loop": ("call_host_ms.loop", "call_prep_ms.loop", "call_launch_ms.loop")}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_traced_cpu_run_reads_every_span_metric(cell, monkeypatch):
    """The harness's traced run (the profiler over the window) on a small
    cell on the CPU; without a card, its closing synchronise is a no-op."""
    if not torch.cuda.is_available():
        monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    spec = harness.load_cell(cell)
    spec["traffic"].update(SMALL[cell])
    r = harness.run(cell, 2**31 + 91, 0.5, True, device="cpu", t_start=time.perf_counter(),
                    cell=spec, cfg=dict(TINY))
    assert r["correct"]
    whole, *parts = (r["metrics"][m]["value"] for m in PARTS[cell])
    assert all(math.isfinite(v) and v > 0 for v in (whole, *parts))
    assert sum(parts) <= whole
    listed = {m["name"] for m in harness.load_benchmark()["per_layer"]
              if cell in m.get("workloads", ())}
    assert set(PARTS[cell]) <= listed

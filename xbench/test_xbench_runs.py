"""Whole runs of each traffic kind, small and on the CPU: a sound run comes
out correct; a run whose timed path is broken underneath comes out not
correct, once for each fault a cell of that kind can have; and nothing a
run imports or reads is JAX, the JAX package or its harness."""

import json
import subprocess
import sys
import time

import pytest
import torch

from xbench import harness

TINY = {"name": "tiny", "n_trees": 24, "depth": 4, "n_bins": 256, "kind": "gbdt",
        "leaf_scale": 0.1, "base_score": 0.5, "mode": "direct", "table_dtype": "uint8",
        "kernel_mode": "inclusive", "n_features": 12, "task": "multiclass", "n_classes": 3}
SMALL = {
    "bulk": {"rows": 3000, "chunk_rows": 512, "sample_rows": 64},
    "closed_loop": {"batch": 64, "pool_batches": 4, "sample_share": 0.3, "sample_max": 64},
    "open_loop": {"rate_per_s": 200.0, "mean_rows": 4, "max_rows": 64, "pool_rows": 512,
                  "warm_s": 0.2, "sample_requests": 60},
}
KIND_CELL = {"bulk": "f130.bulk", "closed_loop": "f130.loop", "open_loop": "f968.serve"}


def small_run(kind, seed=2**31 + 77, task="multiclass", seconds=0.6):
    name = KIND_CELL[kind]
    cell = harness.load_cell(name)
    cell["traffic"].update(SMALL[kind])
    cfg = {**TINY, "task": task}
    return harness.run(name, seed, seconds, False, device="cpu", t_start=time.perf_counter(),
                       cell=cell, cfg=cfg)


@pytest.mark.parametrize("kind", sorted(SMALL))
def test_sound_run_is_correct(kind):
    r = small_run(kind, task="binary" if kind == "open_loop" else "multiclass")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checked" and r["counters"]["rows_checked"] > 0
    assert r["checked"]["margin_gap"]["value"] < 1e-6
    cell = KIND_CELL[kind]
    want = {m["name"] for m in harness.reported(harness.load_benchmark(), cell, False)}
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())


def half_batch(out):
    out = out.clone()
    out[out.shape[0] // 2:] = 0.0  # half of the batch left out
    return out


def altered(out):
    out = out.clone()
    out[:, 0] += 0.05  # an answer altered where it is produced: one leaf's worth
    return out


@pytest.mark.parametrize("fault", [half_batch, altered], ids=["half_batch", "altered"])
@pytest.mark.parametrize("kind", sorted(SMALL))
def test_broken_timed_path_is_not_correct(kind, fault, monkeypatch):
    from repro_torch.core.engine import XTimeEngine

    sound = XTimeEngine._margin_padded
    monkeypatch.setattr(XTimeEngine, "_margin_padded", lambda self, q: fault(sound(self, q)))
    r = small_run(kind)
    assert not r["correct"]
    assert r["checked"]["margin_gap"]["value"] > r["checked"]["margin_gap"]["limit"]


def test_control_fails_every_limit_and_the_program_passes():
    """The control (the reference with bfloat16 leaves) reads above each
    cell's limit, and the program's plain version below it, on each cell's
    own configuration with its trees cut to 64 for the CPU."""
    import repro_torch
    from repro_torch.core.deploy import DeployConfig

    from xbench import control, correct
    from xbench.ensemble import make_rows, make_trees
    from xbench.reference.traverse import margins

    for w in harness.load_benchmark()["workloads"]:
        cell = harness.load_cell(w["name"])
        cfg = {**harness.load_config(cell["config"]), "n_trees": 64}
        limit = cell["limits"]["margin_gap"]
        for seed in (2**31 + 1, 2**31 + 2, 2**31 + 3):
            assert control.control_gap(cfg, seed, 512, "cpu") > 3 * limit
        trees = make_trees(cfg, 2**31 + 1, "cpu")
        rows = make_rows(cfg, 2**31 + 1, 256, "cpu")
        cm = repro_torch.build(harness.port_ensemble(trees, cfg),
                               deploy=DeployConfig(mode=cfg["mode"]))
        prog = cm.raw_margin(rows.numpy(), device="cpu")
        ref, mag = margins(trees, rows)
        assert correct.gap(prog, ref.numpy(), mag.numpy()) < limit / 3


PROBE = r"""
import json, sys, time
from pathlib import Path
root = Path(sys.argv[1])
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" and args and isinstance(args[0], (str, bytes)) else None)
sys.path[:0] = [str(root / "src"), str(root)]
import xbench.test_xbench_runs as t
for kind in sorted(t.SMALL):
    t.small_run(kind, task="binary" if kind == "open_loop" else "multiclass", seconds=0.3)
from xbench import harness
for m in harness.load_benchmark()["per_layer"]:
    harness.reader(m["name"])
import xbench.control, xbench.sweep
files = [getattr(m, "__file__", None) or "" for m in list(sys.modules.values())]
print(json.dumps({"forbidden": harness.forbidden_modules(), "files": files + opened}))
"""


def test_run_loads_no_jax_and_reads_nothing_of_the_jax_package():
    root = harness.ROOT
    out = subprocess.run([sys.executable, "-c", PROBE, str(root)], capture_output=True,
                         text=True, timeout=600, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    seen = json.loads(out.stdout.strip().splitlines()[-1])
    assert seen["forbidden"] == []
    bad = [f for f in seen["files"]
           if f.startswith(str(root / "benchmarks")) or f.startswith(str(root / "src" / "repro") + "/")]
    assert bad == []
    assert any(f.startswith(str(root / "src" / "repro_torch")) for f in seen["files"])


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    out = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload",
                          "f130.loop", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""

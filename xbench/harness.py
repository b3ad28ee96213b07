"""One run of one cell: set-up, the measured window, the check, the result.

Everything a cell is made of is found by name: its file
``xbench/cells/<cell>.json`` (configuration, traffic parameters, limits,
and optionally ``host_threads``: the process's intra-op thread count, as
the deployment it stands for would set it),
the configuration ``xbench/configs/<config>.json``, the traffic driver
``xbench/traffic/<kind>.py`` and each per-layer metric's reader
``xbench/metrics/<metric>.py``; which metrics a cell reports comes from
``BENCHMARK.json``. Adding a configuration, a cell or a metric adds files
and entries and edits none.

A driver module defines ``Driver(ctx)`` with ``bind()`` (the program's
first engine bind, timed as ``bind_s``), ``prepare()`` (inputs and warm-up),
``window(seconds, tracer)`` (returns the end-to-end values, the attempted
and failed counts and the counters the readers use), ``answers()`` (pairs
of query rows and the program's margins for them, kept from the window)
and ``close()``. A reader module defines ``read(rec) -> float | None``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from xbench import correct
from xbench.ensemble import Trees, make_trees, stream_seed
from xbench.trace import Tracer

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "xbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_config(name: str) -> dict:
    return read_json(HERE / "configs" / f"{name}.json")


def load_cell(name: str) -> dict:
    return read_json(HERE / "cells" / f"{name}.json")


def load_benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def driver_class(kind: str):
    return importlib.import_module(f"xbench.traffic.{kind}").Driver


def reader(metric: str):
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"xbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def reported(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics ``cell`` reports: its end-to-end ones, or with ``trace``
    its per-layer ones (a metric without ``workloads`` goes in every cell
    that reports the end-to-end metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names else [])]


@dataclass
class Context:
    cell: dict
    cfg: dict
    seed: int
    device: torch.device
    cm: object = None

    @property
    def sample_seed(self) -> int:
        """Seeds what a run keeps for the reference."""
        return stream_seed(self.seed, "sample")


@dataclass
class Record:
    """What a per-layer reader reads."""

    cfg: dict
    cell: dict
    timings: dict
    counters: dict
    trace: object = None  # trace.TraceSummary of a traced run
    peak: dict | None = None  # workcount.peaks() of the card


class GcPauses:
    """The interpreter's garbage-collection pauses during the window (a
    stall of every thread of the process), for the counters."""

    def __enter__(self) -> "GcPauses":
        self.pauses: list[float] = []
        self._t0 = 0.0
        gc.callbacks.append(self._cb)
        return self

    def _cb(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.pauses.append(time.perf_counter() - self._t0)

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._cb)

    def counters(self) -> dict:
        p = np.asarray(self.pauses) * 1e3
        return {"gc_pauses": int(p.size), "gc_max_ms": float(p.max()) if p.size else 0.0,
                "gc_total_ms": float(p.sum())}


def port_ensemble(trees: Trees, cfg: dict):
    """The benchmark's trees as the program's ``Ensemble`` (numpy on the host)."""
    from repro_torch.core.trees import Ensemble, Tree

    feat = trees.feature.cpu().numpy().astype(np.int32)
    thr = trees.threshold.cpu().numpy().astype(np.int32)
    leaf = trees.leaf.cpu().numpy()
    t, inner = feat.shape
    n_nodes = 2 * inner + 1
    feature = np.full((t, n_nodes), -1, dtype=np.int32)
    feature[:, :inner] = feat
    threshold = np.zeros((t, n_nodes), dtype=np.int32)
    threshold[:, :inner] = thr
    value = np.zeros((t, n_nodes), dtype=np.float32)
    value[:, inner:] = leaf
    left = np.full(n_nodes, -1, dtype=np.int32)
    left[:inner] = 2 * np.arange(inner, dtype=np.int32) + 1
    right = np.where(left >= 0, left + 1, -1).astype(np.int32)
    task = cfg["task"]
    return Ensemble(
        trees=[Tree(feature=feature[i], threshold=threshold[i], left=left, right=right,
                    value=value[i]) for i in range(t)],
        n_features=int(cfg["n_features"]), n_bins=int(cfg["n_bins"]), task=task, kind="gbdt",
        n_classes=int(cfg["n_classes"]) if task == "multiclass" else 2,
        tree_class=trees.tree_class.cpu().numpy().astype(np.int32),
        base_score=float(cfg["base_score"]), leaf_class_mode="tree",
    )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(name: str, seed: int, seconds: float, trace: bool, *, device, t_start: float,
        cell: dict | None = None, cfg: dict | None = None, bench: dict | None = None) -> dict:
    """One run of cell ``name``; returns the result line as a dict, with the
    numbers compared under ``checked``. ``cell``/``cfg``/``bench`` replace
    the files of that name (the tests run small cells on the CPU)."""
    import repro_torch
    from repro_torch.core.deploy import DeployConfig

    from xbench import workcount

    device = torch.device(device)
    cell = cell or load_cell(name)
    cfg = cfg or load_config(cell["config"])
    bench = bench or load_benchmark()
    on_card = device.type == "cuda"
    if "host_threads" in cell:
        torch.set_num_threads(int(cell["host_threads"]))
    if on_card:
        torch.cuda.set_device(device)
        torch.empty(1, device=device)  # the allocator exists before its stats are reset
        torch.cuda.reset_peak_memory_stats(device)
    ctx = Context(cell=cell, cfg=cfg, seed=int(seed), device=device)
    trees = make_trees(cfg, seed, device)

    t0 = time.perf_counter()
    ctx.cm = repro_torch.build(port_ensemble(trees, cfg), deploy=DeployConfig(mode=cfg["mode"]))
    build_s = time.perf_counter() - t0

    driver = driver_class(cell["traffic"]["kind"])(ctx)
    t0 = time.perf_counter()
    driver.bind()
    _sync(device)
    bind_s = time.perf_counter() - t0
    eng = ctx.cm.engine(device)
    if (eng.table_dtype, eng.kernel_mode) != (cfg["table_dtype"], cfg["kernel_mode"]):
        raise RuntimeError(f"bound {eng.table_dtype}/{eng.kernel_mode}, the configuration "
                           f"states {cfg['table_dtype']}/{cfg['kernel_mode']}")
    del eng
    driver.prepare()
    _sync(device)
    # set-up's garbage is collected in set-up, so that no run starts its
    # window owing the interpreter a full collection of it
    gc.collect()
    setup_s = time.perf_counter() - t_start

    with Tracer(trace) as tracer, GcPauses() as pauses:
        win = driver.window(seconds, tracer)
    win["counters"].update(pauses.counters())
    summary = tracer.summary()
    mem = int(torch.cuda.max_memory_allocated(device)) if on_card else 0

    driver.close()
    answers = list(driver.answers())
    ctx.cm = driver = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checked, n_checked = correct.judge(trees, answers, device, cell["limits"])
    ok = n_checked > 0 and all(v["value"] <= v["limit"] for v in checked.values())

    metrics = {}
    rec = Record(cfg=cfg, cell=cell, timings={"build_s": build_s, "bind_s": bind_s},
                 counters=win["counters"], trace=summary,
                 peak=workcount.peaks(torch.cuda.get_device_name(device)) if on_card else None)
    for m in reported(bench, name, trace):
        if trace:
            value = reader(m["name"])(rec)
        else:
            value = setup_s if m["name"] == "setup_s" else win["e2e"][m["name"]]
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    result = {
        "correct": bool(ok), "attempted": int(win["attempted"]), "failed": int(win["failed"]),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else device.type,
            "kind": torch.cuda.get_device_name(device) if on_card else device.type,
            "count": 1, "memory_peak_bytes": mem,
        },
    }
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = {"device_ops": summary.device_ops(), "idle_gaps": summary.idle_gaps}
    result["counters"] = {**win["counters"], "build_s": build_s, "bind_s": bind_s,
                          "rows_checked": n_checked}
    result["checked"] = checked
    return result

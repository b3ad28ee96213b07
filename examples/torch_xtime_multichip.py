"""Multi-chip scale-out walkthrough on the PyTorch/CUDA port: the NoC plan
as a shard program, step for step as ``examples/xtime_multichip.py``.

The paper's throughput comes from 4096 CAM cores behind an H-tree NoC
(§III-D).  On a mesh of devices that structure is the mesh engine
(DESIGN.md §8): CAM rows shard across devices like trees across cores,
and each NoC router program runs as an explicit shard program —

    accumulate (Fig. 7a)  partial margins of every row shard, added in
                          row-shard order (the JAX package's psum)
    batch      (Fig. 7c)  replicated tables, query stream split over
                          every axis, no cross-device traffic
    hybrid     (2-D)      queries gathered along the row axis, margins
                          reduce-scattered back

One card is enough: the (2, 4) mesh holds 8 logical shards of the device
(the JAX package's fake host devices), so this shows the program and its
bits, not scale-out.

Run:  PYTHONPATH=src python examples/torch_xtime_multichip.py [--device cpu]

The mesh runs on the card unless ``--device cpu`` is given.  Exits
non-zero when a program's predictions differ from the single-device
engine's, or 'gspmd' and 'shard_map' margins differ.
"""

import argparse
import sys
import time

import numpy as np

from repro_torch import DeployConfig, build
from repro_torch.core.engine import resolve_device
from repro_torch.core.noc import ENGINE_COLLECTIVES
from repro_torch.core.quantize import FeatureQuantizer
from repro_torch.core.trees import GBDTParams, train_gbdt
from repro_torch.data.tabular import make_dataset
from repro_torch.launch.mesh import Mesh


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the device the mesh's 8 logical shards share (default: the card)")
    device = resolve_device(ap.parse_args(argv).device)
    devices = [device] * 8
    print(f"[mesh]    {len(devices)} logical shards of {device}")

    # 1. train + compile once — the artifact is mesh-agnostic
    ds = make_dataset("eye")
    quant = FeatureQuantizer.fit(ds.x_train, n_bins=256)
    xb = quant.transform(ds.x_test)[:512].astype(np.int32)
    ens = train_gbdt(
        quant.transform(ds.x_train), ds.y_train, task="multiclass",
        n_bins=256, n_classes=ds.n_classes,
        params=GBDTParams(n_rounds=20, max_leaves=64),
    )
    cm = build(ens, deploy=DeployConfig(backend="jnp"))
    print(f"[build]   {cm.table.n_rows} CAM rows, {cm.table.n_outputs} classes, "
          f"NoC '{cm.noc.config}'")

    # 2. single-device reference — the correctness anchor
    ref_engine = cm.engine(device)
    ref_margin = ref_engine.raw_margin(xb).cpu().numpy()
    ref_pred = ref_engine.predict(xb).cpu().numpy()

    # 3. a (data=2, model=4) mesh: `model` plays the role of CAM core
    #    groups, `data` of independent query streams
    mesh = Mesh(np.array(devices, dtype=object).reshape(2, 4), ("data", "model"))
    print(f"[mesh]    axes {mesh.shape}")

    # 4. every NoC program, bound lazily off the same artifact.
    #    spmd='auto' resolves to shard_map on a mesh; spmd='gspmd' runs
    #    the same shard program (PyTorch has no implicit partitioner)
    ok = True
    for noc in ("accumulate", "batch", "hybrid"):
        engine = cm.engine(mesh=mesh, noc_config=noc)
        margin = engine.raw_margin(xb).cpu().numpy()
        pred = engine.predict(xb).cpu().numpy()
        t0 = time.perf_counter()
        for _ in range(5):
            engine.raw_margin(xb).cpu()
        us = (time.perf_counter() - t0) / 5 * 1e6
        same = bool((pred == ref_pred).all())
        ok &= same
        print(f"[{noc:>10}] spmd={engine.spmd}  "
              f"collective: {ENGINE_COLLECTIVES[noc]:<26} "
              f"max|Δmargin| {np.abs(margin - ref_margin).max():.1e}  "
              f"pred equal: {same}  {us:7.0f} us/batch (host clock, {device})")

    # 5. the two partitioning modes run one program: identical bits
    g = cm.engine(mesh=mesh, spmd="gspmd")
    s = cm.engine(mesh=mesh, spmd="shard_map")
    same = bool((g.raw_margin(xb).cpu().numpy() == s.raw_margin(xb).cpu().numpy()).all())
    ok &= same
    print(f"[check]   gspmd vs shard_map margins bit-identical: {same}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

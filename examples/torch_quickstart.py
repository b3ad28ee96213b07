"""Quickstart on the PyTorch/CUDA port: the complete X-TIME pipeline from
the paper (Fig. 7d), step for step as ``examples/quickstart.py``.

    dataset -> train GBDT -> 8-bit quantize -> repro_torch.build (compile to
    CAM rows + place on cores + program the NoC + chip report) ->
    save/load the portable artifact -> bind the engine -> predictions

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The engine runs on the card unless ``--device cpu`` is given.  Exits
non-zero when the reloaded artifact's engine differs from the traversal.
"""

import argparse
import sys
import tempfile
from pathlib import Path

from repro_torch import CompiledModel, DeployConfig, TraversalBaseline, build
from repro_torch.core.perfmodel import gpu_perf_model
from repro_torch.core.quantize import FeatureQuantizer
from repro_torch.core.trees import GBDTParams, train_gbdt
from repro_torch.data.tabular import accuracy_metric, make_dataset


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the engine runs (default: the card)")
    device = ap.parse_args(argv).device

    # 1. data + 8-bit feature grid (256 bins/feature, §III-B)
    ds = make_dataset("churn")
    quant = FeatureQuantizer.fit(ds.x_train, n_bins=256)
    xb_train, xb_test = quant.transform(ds.x_train), quant.transform(ds.x_test)

    # 2. train a gradient-boosted ensemble under the paper's HW constraints
    ens = train_gbdt(
        xb_train, ds.y_train, task="binary", n_bins=256,
        params=GBDTParams(n_rounds=50, max_leaves=256, max_depth=8),
    )
    acc = accuracy_metric("binary", ds.y_test, ens.predict(xb_test))
    print(f"[train]   {ens.n_trees} trees, max {ens.max_leaves} leaves, "
          f"test acc {acc:.4f}")

    # 3. compile ONCE into the deployable artifact: CAM rows, core
    #    placement, NoC router program, analytic chip report, exec config
    #    (batching=True: replicate the small model across cores, §III-D)
    cm = build(ens, deploy=DeployConfig(batching=True))
    print(f"[build]   {cm.table.n_rows} CAM rows x {cm.table.n_features} "
          f"features, {cm.table.dont_care_fraction():.0%} don't-care cells")
    print(f"[place]   {cm.placement.n_cores_used} cores, "
          f"{cm.placement.max_trees_per_core} trees/core max, "
          f"replication x{cm.placement.replication}, NoC '{cm.noc.config}'")

    # 4. the artifact is the unit of deployment: npz + JSON sidecar,
    #    reloadable on any host with no trainer and no recompilation
    with tempfile.TemporaryDirectory() as tmp:
        sidecar = cm.save(Path(tmp) / "churn")
        loaded = CompiledModel.load(sidecar)
        print(f"[save]    {sidecar.name} + churn.npz "
              f"({sidecar.stat().st_size} B sidecar)")

        # 5. inference: one associative match replaces D dependent gathers
        engine = loaded.engine(device)  # binds the device on demand
        pred = engine.predict(xb_test).cpu().numpy()
        ref = TraversalBaseline(ens, device=device).predict(xb_test)
        same = bool((pred == ref).all())
        print(f"[engine]  reloaded-artifact engine == traversal on "
              f"{len(pred)} samples: {same} ({engine.device})")

    # 6. chip performance model (Eq. 4/5, Fig. 8 constants) rides along
    rep = cm.perf
    gpu = gpu_perf_model(n_trees=ens.n_trees, depth=8)
    print(f"[chip]    latency {rep.latency_ns:.0f} ns, throughput "
          f"{rep.throughput_msps:,.0f} MS/s, {rep.power_w:.1f} W, "
          f"{rep.energy_nj_per_dec:.2f} nJ/decision")
    print(f"[vs GPU]  latency x{gpu.latency_ns/rep.latency_ns:,.0f} lower, "
          f"throughput x{rep.throughput_msps/gpu.throughput_msps:,.0f} higher")
    if not same:
        print("FAIL: the engine's predictions differ from the traversal", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

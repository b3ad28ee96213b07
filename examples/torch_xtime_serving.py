"""X-TIME as an inference SERVICE on the PyTorch/CUDA port, step for step
as ``examples/xtime_serving.py``: three models are compiled once into
portable ``CompiledModel`` artifacts (``repro_torch.build``), written to
disk, and a fresh ``TableRegistry`` cold-starts from those files — no
trainer in the serve process, no recompilation.  Single-row requests
stream through the micro-batching ``ServeLoop``, and the measured p50/p99
latency is reported next to the paper's analytic chip numbers.  The
defect study (Fig. 9b) becomes a hot-swap demo: defective tables are
swapped in under the same model name while the loop keeps serving.

Run:  PYTHONPATH=src python examples/torch_xtime_serving.py [--device cpu]

Serves on the card unless ``--device cpu`` is given.  Exits non-zero when
a served result differs from ``CompiledModel.predict`` on the same rows.
"""

import argparse
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

from repro_torch import CompiledModel, DeployConfig, ServeLoop, TableRegistry, build
from repro_torch.core.defects import inject_table_defects, relative_accuracy
from repro_torch.core.quantize import FeatureQuantizer
from repro_torch.core.trees import GBDTParams, train_gbdt
from repro_torch.data.tabular import accuracy_metric, make_dataset


def _train(name: str, n_rounds: int = 30):
    ds = make_dataset(name)
    quant = FeatureQuantizer.fit(ds.x_train, 256)
    ens = train_gbdt(
        quant.transform(ds.x_train), ds.y_train, task=ds.task, n_bins=256,
        n_classes=ds.n_classes,
        params=GBDTParams(n_rounds=n_rounds, max_leaves=64),
    )
    return ds, quant, ens


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the registry serves (default: the card)")
    device = ap.parse_args(argv).device
    failures = []

    # --- "trainer" process: compile each model once, ship the artifact ---
    tmp = Path(tempfile.mkdtemp(prefix="xtime-artifacts-"))
    try:
        datasets = {}
        for name, batching in (("rossmann", False), ("eye", False), ("telco", True)):
            ds, quant, ens = _train(name)
            cm = build(ens, deploy=DeployConfig(batching=batching))
            cm.save(tmp / name)
            datasets[name] = (ds, quant)
            print(f"[build]    {name:10s} {cm.table.n_rows} CAM rows, "
                  f"{cm.noc.config} NoC "
                  f"router_bits={''.join(map(str, cm.noc.router_bits))} "
                  f"-> {name}.npz+.json")

        # --- serve process: cold-start the registry from disk artifacts ---
        registry = TableRegistry(device=device)
        loop = ServeLoop(registry, window_s=0.001, flush_rows=256)
        for name in datasets:
            entry = registry.register(name, CompiledModel.load(tmp / name))
            print(f"[register] {name:10s} v{entry.version} from artifact "
                  f"(zero recompilation, {registry.device})")

        # single-row request traffic, round-robin over the three models
        streams = {
            name: quant.transform(ds.x_test).astype(np.int32)
            for name, (ds, quant) in datasets.items()
        }
        handles: dict[str, list] = {name: [] for name in streams}
        n_req = min(512, min(len(x) for x in streams.values()))
        for i in range(n_req):
            for name, xb in streams.items():
                handles[name].append(loop.submit(name, xb[i]))
        loop.drain()

        print(f"\n[serve] {3 * n_req} single-row requests:")
        for name, (ds, quant) in datasets.items():
            pred = np.concatenate([loop.result(h) for h in handles[name]])
            want = registry.artifact(name).predict(streams[name][:n_req], device=registry.device)
            if not np.array_equal(pred, want):
                failures.append(f"{name}: served results differ from cm.predict")
            acc = accuracy_metric(ds.task, ds.y_test[:n_req], pred)
            rep = loop.report(name)
            m, c = rep["measured"], rep["xtime_chip_model"]
            print(f"  {name:10s} acc={acc:.4f} p50={m['p50_ms']:.2f}ms "
                  f"p99={m['p99_ms']:.2f}ms {m['requests_per_s']:,.0f} req/s "
                  f"({m['flushes']} flushes) | chip model: "
                  f"{c['latency_ns']:.0f} ns, {c['throughput_msps']:,.0f} MS/s, "
                  f"{c['energy_nj_per_dec']:.2f} nJ/dec [{c['bottleneck']}]")

        # defect robustness as hot-swap: serve the eye model with memristor
        # flips injected, swapping tables under live traffic (Fig. 9b)
        ds, quant = datasets["eye"]
        xb = quant.transform(ds.x_test).astype(np.int32)
        clean_table = registry.get("eye").table
        h = loop.submit("eye", xb[:256])
        loop.drain()
        ideal = accuracy_metric("multiclass", ds.y_test[:256], loop.result(h))
        print("\n[hot-swap] defect robustness on the live 'eye' service:")
        for frac in (0.002, 0.02, 0.1):
            accs = []
            for r in range(5):
                t2 = inject_table_defects(clean_table, frac, np.random.default_rng(r))
                entry = registry.swap("eye", t2)
                h = loop.submit("eye", xb[:256])
                loop.drain()
                pred = loop.result(h)
                if not np.array_equal(pred, entry.artifact.predict(xb[:256],
                                                                   device=registry.device)):
                    failures.append(f"eye v{entry.version}: served results differ "
                                    "from the swapped-in artifact's predict")
                accs.append(accuracy_metric("multiclass", ds.y_test[:256], pred))
            mean, std = relative_accuracy(ideal, accs)
            print(f"  {frac:5.1%} defects -> relative accuracy "
                  f"{mean:.4f} +/- {std:.4f} (now v{entry.version})")
        registry.swap("eye", clean_table)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for f in failures:
        print(f"FAIL: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())

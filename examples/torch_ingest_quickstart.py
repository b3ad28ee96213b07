"""Ingestion quickstart on the PyTorch/CUDA port: serve a model this repo
never trained, step for step as ``examples/ingest_quickstart.py``.

The paper's deployment story (§II-D) starts from ensembles trained in
standard libraries.  This example plays the model owner AND the serving
side with no xgboost installed anywhere:

    1. write an XGBoost-JSON dump (here: exported from a native model,
       standing in for any real ``Booster.save_model('m.json')`` file)
    2. ingest it: parse -> threshold-grid lowering -> compile -> place
       (``repro_torch.build`` accepts the dump path directly)
    3. save the CompiledModel artifact, cold-start a TableRegistry from
       it, and serve FLOAT queries in one call — ``served.predict(x)``
       bins with the artifact's own grid and dispatches the
       batch-hinted engine internally

Run:  PYTHONPATH=src python examples/torch_ingest_quickstart.py [--device cpu]

Serves on the card unless ``--device cpu`` is given.  Exits non-zero when
a served prediction differs from the native model's.
"""

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

from repro_torch import CompiledModel, TableRegistry, build
from repro_torch.core.quantize import FeatureQuantizer
from repro_torch.core.trees import GBDTParams, train_gbdt
from repro_torch.data.tabular import make_dataset
from repro_torch.ingest import load_model, to_xgboost_json


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="where the registry serves (default: the card)")
    device = ap.parse_args(argv).device

    with tempfile.TemporaryDirectory() as td:
        # 1. the "model owner": any XGBoost-JSON dump works here
        ds = make_dataset("churn")
        quant = FeatureQuantizer.fit(ds.x_train, n_bins=256)
        ens = train_gbdt(
            quant.transform(ds.x_train), ds.y_train, task="binary",
            n_bins=256, params=GBDTParams(n_rounds=30, max_leaves=64),
        )
        dump = Path(td) / "model.json"
        dump.write_text(json.dumps(to_xgboost_json(ens, quant)))
        print(f"[dump]    {dump.name}: {dump.stat().st_size // 1024} KiB "
              "XGBoost-JSON (no xgboost involved)")

        # 2. ingest + compile in one call; the sidecar records the grid
        imported = load_model(dump)  # or: build(str(dump)) directly
        cm = build(imported)
        rep = cm.ingest
        print(f"[ingest]  {rep['source']}: {rep['n_source_trees']} trees, "
              f"{cm.table.n_rows} CAM rows, exact={rep['exact']}")
        print(f"[grid]    {sum(1 for g in rep['grid'] if g['thresholds'])}"
              f"/{rep['n_features']} features split, "
              f"n_bins={rep['n_bins']}")

        # 3. artifact -> disk -> registry cold start -> predictions
        cm.save(Path(td) / "artifacts" / "churn")
        served = CompiledModel.load(Path(td) / "artifacts" / "churn")
        reg = TableRegistry(device=device)
        reg.register("churn", served)

        x = ds.x_test[:256]  # FLOAT queries: the artifact bins them
        pred = served.predict(x, device=reg.device)
        native = ens.predict(quant.transform(x))
        print(f"[serve]   {len(x)} float queries -> "
              f"{int((pred == native).sum())}/{len(x)} predictions "
              f"identical to the native model ({reg.device})")
    if not bool(np.all(pred == native)):
        print("FAIL: served predictions differ from the native model", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

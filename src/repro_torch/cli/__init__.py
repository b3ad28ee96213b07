"""The port's command lines: the ``scripts/ingest.py`` and
``scripts/score.py`` of the JAX package, on ``repro_torch``.

    PYTHONPATH=src python -m repro_torch.cli.ingest model.json --out artifacts/m
    PYTHONPATH=src python -m repro_torch.cli.score artifacts/m rows.npy --out preds.npy

Each takes the JAX command's arguments and prints its lines, plus
``--device`` (default: the card; ``cpu`` runs the plain version); the
ingest command also takes ``--autotune BATCHES``.  ``_common`` holds what
both share: artifact loading and the ``--expected`` golden-record check.
"""

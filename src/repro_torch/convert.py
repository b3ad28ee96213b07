"""Artifact state <-> the port's ``CompiledModel``.

The JAX package stores an artifact as NumPy arrays (the ``.npz``) plus a
JSON sidecar dict.  ``from_state`` assembles the port's objects from that
state and ``to_state`` writes it back, field for field, so an artifact
goes from one package to the other and back with identical arrays and a
byte-identical sidecar.

The arrays are ``low``, ``high``, ``leaf``, ``tree_id``, ``class_id`` and,
when present, ``feature_ids``, ``col_perm`` and the quantizer's
``q_edges``/``q_offsets``, as stored at rest: a packed table's
``low``/``high`` in its narrow ``table_dtype`` with INCLUSIVE upper
bounds.  ``to_state`` reads only attributes both packages share, so it
also turns ``repro``'s in-memory ``CompiledModel`` into this state.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np

from repro_torch.api import (
    FORMAT,
    SCHEMA_VERSION,
    SUPPORTED_SCHEMAS,
    TABLE_ARRAYS,
    TABLE_META,
    CompiledModel,
)
from repro_torch.core.compile import CAMTable, ChipSpec, CorePlacement
from repro_torch.core.deploy import DeployConfig
from repro_torch.core.noc import NoCPlan
from repro_torch.core.perfmodel import PerfReport
from repro_torch.core.quantize import FeatureQuantizer


def from_state(
    arrays: Mapping[str, np.ndarray], sidecar: Mapping, *, source: str = "artifact"
) -> CompiledModel:
    """Build the port's ``CompiledModel`` from an artifact's arrays and
    sidecar dict (``source`` names it in error messages)."""
    if sidecar.get("format") != FORMAT:
        raise ValueError(
            f"{source}: not a {FORMAT} artifact (format={sidecar.get('format')!r})"
        )
    version = sidecar.get("schema_version")
    if version not in SUPPORTED_SCHEMAS:
        raise ValueError(
            f"{source}: artifact schema_version={version!r} is not in the "
            f"supported versions {SUPPORTED_SCHEMAS}; rebuild it"
        )
    table_meta = dict(sidecar["table"])
    cols = {name: np.asarray(arrays[name]) for name in TABLE_ARRAYS}
    if table_meta.get("table_dtype", "int32") != "int32":
        # packed at rest: inclusive high in a narrow dtype; restore the
        # canonical int32 exclusive-high form
        cols["low"] = cols["low"].astype(np.int32)
        cols["high"] = cols["high"].astype(np.int32) + 1
    for name in ("feature_ids", "col_perm"):
        if name in arrays:
            cols[name] = np.asarray(arrays[name]).astype(np.int32)
    quantizer = None
    if "quantizer" in sidecar and "q_offsets" in arrays:
        flat, off = arrays["q_edges"], arrays["q_offsets"]
        quantizer = FeatureQuantizer(
            edges=[flat[off[i]:off[i + 1]].astype(np.float64)
                   for i in range(off.shape[0] - 1)],
            n_bins=int(sidecar["quantizer"]["n_bins"]),
        )
    table = CAMTable(**cols, **table_meta)
    chip = ChipSpec(**sidecar["chip"])
    placement = CorePlacement(spec=chip, **sidecar["placement"])
    noc_d = dict(sidecar["noc"])
    noc_d["reduction_axes"] = tuple(noc_d["reduction_axes"])
    return CompiledModel(
        table=table, placement=placement, noc=NoCPlan(**noc_d),
        perf=PerfReport(**sidecar["perf"]),
        deploy=DeployConfig.from_dict(sidecar["deploy"]),
        quantizer=quantizer,
        ingest=sidecar.get("ingest"),
        tuning=sidecar.get("tuning"),
        compression=sidecar.get("compression"),
    )


def to_state(cm: CompiledModel) -> tuple[dict[str, np.ndarray], dict]:
    """The (arrays, sidecar) pair ``repro.api.CompiledModel.save`` writes
    for the same artifact: packed-at-rest arrays and the JSON-ready dict."""
    t = cm.table
    arrays = {name: getattr(t, name) for name in TABLE_ARRAYS}
    if t.table_dtype != "int32":
        # at-rest compaction mirrors the kernel layout: packed dtype,
        # INCLUSIVE upper bound; anything that would wrap must fail here
        dt = np.dtype(t.table_dtype)
        top = np.iinfo(dt).max
        if t.high.size and (
            int(t.high.min()) < 1 or int(t.high.max()) - 1 > top
            or int(t.low.min()) < 0 or int(t.low.max()) > top
        ):
            raise ValueError(
                f"table bounds do not fit table_dtype {t.table_dtype!r} "
                "as inclusive ranges; rebuild with table_dtype='int32'"
            )
        arrays["low"] = t.low.astype(dt)
        arrays["high"] = (t.high - 1).astype(dt)
    if t.feature_ids is not None:
        arrays["feature_ids"] = np.asarray(t.feature_ids, dtype=np.int32)
    if t.col_perm is not None:
        arrays["col_perm"] = np.asarray(t.col_perm, dtype=np.int32)
    if cm.quantizer is not None:
        edges = cm.quantizer.edges  # ragged per-feature edges: flat + offsets
        arrays["q_edges"] = (np.concatenate(edges) if edges
                             else np.zeros(0, dtype=np.float64))
        arrays["q_offsets"] = np.cumsum(
            [0] + [e.shape[0] for e in edges]
        ).astype(np.int64)
    sidecar = {
        "format": FORMAT,
        # only column-collapsed or column-permuted tables NEED the v3
        # reader; everything else stays v2 so older readers keep loading it
        "schema_version": (
            SCHEMA_VERSION
            if (t.feature_ids is not None or t.col_perm is not None)
            else 2
        ),
        "table": {k: getattr(t, k) for k in TABLE_META},
        "chip": dataclasses.asdict(cm.chip),
        "placement": {
            "core_trees": cm.placement.core_trees,
            "core_rows_used": cm.placement.core_rows_used,
            "n_feature_segments": cm.placement.n_feature_segments,
            "replication": cm.placement.replication,
        },
        "noc": dataclasses.asdict(cm.noc),
        "perf": dataclasses.asdict(cm.perf),
        "deploy": cm.deploy.to_dict(),
    }
    if cm.quantizer is not None:
        sidecar["quantizer"] = {"n_bins": cm.quantizer.n_bins}
    if cm.ingest is not None:
        sidecar["ingest"] = cm.ingest
    if cm.tuning is not None:
        sidecar["tuning"] = cm.tuning
    if cm.compression is not None:
        sidecar["compression"] = cm.compression
    return arrays, sidecar

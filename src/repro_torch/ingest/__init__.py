"""Ingestion frontend: serialized model dumps -> the X-TIME pipeline.

Zero-dependency importers for the three dump formats real tabular
models ship in — none of the source libraries is needed at runtime:

  * :func:`import_xgboost_json`  — ``xgb.Booster.save_model('m.json')``
    (gbtree + dart, reg/binary/multiclass objectives, base_score)
  * :func:`import_lightgbm_text` — ``lgb.Booster.save_model('m.txt')``
    (numerical + categorical splits, the latter lowered to threshold
    interval chains)
  * :func:`import_sklearn_dict`  — the documented ``sklearn-forest``
    JSON schema over the public ``tree_`` arrays (RF averaging and
    GBDT summing)

Each importer yields the float-threshold :class:`ImportedEnsemble` IR;
:func:`lower_to_ensemble` maps it bit-exactly onto a binned ``Ensemble``
via a grid built from the model's own split points (§III-B), ready for
``repro_torch.build`` — which also accepts the IR or a dump path
directly.

A copy of ``repro.ingest``: the port imports nothing of ``repro``, and
both packages must lower a dump to identical trees and grids.
"""

from __future__ import annotations

import json
from pathlib import Path

from repro_torch.ingest.ir import ImportedEnsemble, ImportedTree, IngestError
from repro_torch.ingest.lightgbm_text import import_lightgbm_text
from repro_torch.ingest.lower import IngestReport, lower_to_ensemble
from repro_torch.ingest.sklearn_dict import import_sklearn_dict
from repro_torch.ingest.xgboost_json import import_xgboost_json, to_xgboost_json

__all__ = [
    "ImportedEnsemble",
    "ImportedTree",
    "IngestError",
    "IngestReport",
    "detect_format",
    "import_lightgbm_text",
    "import_sklearn_dict",
    "import_xgboost_json",
    "load_model",
    "lower_to_ensemble",
    "to_xgboost_json",
]

FORMATS = ("xgboost-json", "lightgbm-text", "sklearn-dict")

_IMPORTERS = {
    "xgboost-json": import_xgboost_json,
    "lightgbm-text": import_lightgbm_text,
    "sklearn-dict": import_sklearn_dict,
}


def _detect(text: str, where: str) -> tuple[str, dict | str]:
    """(format, parsed-or-raw payload) from dump content.

    Content decides, not the extension: a JSON booster saved as ``.txt``
    still routes to the JSON parsers.  Returns the parsed dict for JSON
    formats so callers parse the (possibly huge) dump exactly once.
    """
    head = text[:4096].lstrip()
    if head.startswith("{"):
        try:
            doc = json.loads(text)
        except json.JSONDecodeError as e:
            raise IngestError(f"{where}: not valid JSON ({e})") from None
        if "learner" in doc:
            return "xgboost-json", doc
        if doc.get("format") == "sklearn-forest":
            return "sklearn-dict", doc
        raise IngestError(
            f"{where}: JSON dump is neither xgboost-json (no 'learner') "
            "nor sklearn-forest (no matching 'format')"
        )
    if head.startswith("tree"):
        return "lightgbm-text", text
    raise IngestError(f"{where}: unrecognized dump format")


def detect_format(path: str | Path) -> str:
    """Sniff a dump's format from its content."""
    p = Path(path)
    return _detect(p.read_text(errors="replace"), str(p))[0]


def load_model(path: str | Path, format: str = "auto") -> ImportedEnsemble:
    """Parse a model dump into the ingestion IR (format auto-detected).

    The file is read (and, for JSON formats, parsed) exactly once.
    """
    p = Path(path)
    if not p.exists():
        raise IngestError(f"model dump not found: {p}")
    if format != "auto" and format not in _IMPORTERS:
        raise IngestError(
            f"unknown format {format!r}; expected one of {FORMATS} or 'auto'"
        )
    text = p.read_text(errors="replace")
    if format == "auto":
        fmt, payload = _detect(text, str(p))
    else:  # an explicit format is a contract; skip the sniffer entirely
        fmt = format
        if fmt == "lightgbm-text":
            payload: dict | str = text
        else:
            try:
                payload = json.loads(text)
            except json.JSONDecodeError as e:
                raise IngestError(f"{p}: not valid JSON ({e})") from None
    return _IMPORTERS[fmt](payload)

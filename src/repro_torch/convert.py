"""Artifact state <-> the port's ``CompiledModel``, and LM parameters
<-> the JAX package's ``init_params`` pytree.

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

LM parameters cross as nested dicts of numpy arrays in the JAX layout
(``lm_params_from_numpy`` / ``lm_params_to_numpy``), for every LM family
through its parameters' ``jax_layout()``: the NamedTuples (``AttnParams``,
``FFNParams``, ``MoEParams``, ``MLAParams``, ``Mamba2Params``,
``RWKV6Params``, ...) as their ``_asdict()`` with None kept, a stack's
leaves on a leading layer axis (the hybrid's mamba leaves two deep, (G, P,
...)).  Both directions are exact, bfloat16 included.
``seeded_numpy_params`` makes such a tree from a numpy seed, so both
packages can be given the same weights without either's initialiser.
The training state crosses the same way: gradients, a compression
residual and the AdamW moments (``lm_tree_{from,to}_numpy``,
``lm_opt_state_{from,to}_numpy``) in the layout of the parameters, and
``lm_decay_mask`` is the decay mask taken on that layout, the JAX
package's ``_decay_mask`` leaf for leaf.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import hashlib

import numpy as np
import torch

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
from repro_torch.core.engine import resolve_device
from repro_torch.core.noc import NoCPlan
from repro_torch.core.perfmodel import PerfReport
from repro_torch.core.quantize import FeatureQuantizer
from repro_torch.models.common import (
    Stack,
    first_leaf,
    layout_leaves,
    layout_shape,
    tree_map,
)
from repro_torch.models.registry import lm_model
from repro_torch.optim.adamw import _decay_mask


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


# ---------------------------------------------------------------------------
# LM parameters
# ---------------------------------------------------------------------------


def _tensor_of(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor with ``arr``'s bits (numpy's bfloat16 from ml_dtypes
    arrives as its 16-bit words)."""
    arr = np.require(arr, requirements=["C", "W"])  # a copy when read-only
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _numpy_of(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bfloat16; needed only for bfloat16 leaves

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _copy_into(dest, src: torch.Tensor) -> None:
    if isinstance(dest, list):  # a stack: one tensor per index of the leading axis
        for i, d in enumerate(dest):
            _copy_into(d, src[i])
    else:
        dest.copy_(src)


def _fill(layout, tree, path: str) -> None:
    if layout is None or tree is None:
        if layout is not None or tree is not None:
            raise ValueError(f"{path}: None on one side only")
        return
    if isinstance(layout, dict):
        if not isinstance(tree, dict) or set(tree) != set(layout):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{path}: keys {got} != {sorted(layout)}")
        for k in layout:
            _fill(layout[k], tree[k], f"{path}[{k!r}]")
        return
    src = _tensor_of(np.asarray(tree))
    want, dtype = layout_shape(layout), first_leaf(layout).dtype
    if tuple(src.shape) != want or src.dtype != dtype:
        raise ValueError(f"{path}: got {tuple(src.shape)} {src.dtype}, want {want} {dtype}")
    with torch.no_grad():
        _copy_into(layout, src)


def lm_params_from_numpy(cfg, tree: Mapping, *, device=None):
    """The port's parameters of ``cfg`` (any LM family) on ``device`` (None:
    the card) from the JAX package's ``init_params`` pytree as nested dicts
    of numpy arrays.  Every leaf must have the port's shape and dtype; the
    stacked leaves become the per-layer modules."""
    params = lm_model(cfg, device=resolve_device(device)).empty_params()
    _fill(params.jax_layout(), tree, "params")
    return params


def lm_params_to_numpy(params) -> dict:
    """The inverse of ``lm_params_from_numpy``: the JAX layout as nested
    dicts of numpy arrays (bfloat16 as ml_dtypes' bfloat16)."""
    return lm_tree_to_numpy(params.jax_layout())


def lm_tree_to_numpy(tree) -> dict:
    """A tree in the JAX layout (parameters, gradients, moments) as nested
    dicts of numpy arrays, each ``Stack`` stacked."""
    def conv(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, list):
            return np.stack([conv(t) for t in node])
        return _numpy_of(node) if isinstance(node, torch.Tensor) else np.asarray(node)

    return conv(tree)


def _unstacked(src: torch.Tensor, leaf):
    """``src`` split along its stacked axes as ``leaf`` is (a ``Stack`` of
    per-layer tensors)."""
    if isinstance(leaf, list):
        return Stack(_unstacked(src[i], x) for i, x in enumerate(leaf))
    return src


def lm_tree_from_numpy(cfg, tree: Mapping, *, device=None):
    """A tree in the JAX layout of ``cfg``'s parameters (``Stack``s of
    per-layer tensors) holding ``tree``'s numpy leaves on ``device`` (None:
    the card), each in its array's dtype: gradients, a compression
    residual, optimizer moments."""
    dev = resolve_device(device)
    layout = lm_model(cfg, device="meta").empty_params().jax_layout()
    want = {path: layout_shape(leaf) for path, leaf in layout_leaves(layout)}
    got = {path: np.shape(leaf) for path, leaf in layout_leaves(tree)}
    if got != want:
        raise ValueError(f"tree: leaves {got} != the layout's {want}")
    return tree_map(lambda lay, arr: _unstacked(_tensor_of(np.asarray(arr)).to(dev), lay),
                    layout, tree)


def lm_opt_state_to_numpy(state: Mapping) -> dict:
    """An ``AdamW`` state of the port as the JAX package's: {'m', 'v'} in the
    parameters' JAX layout, 'step' an int32 scalar."""
    return {"m": lm_tree_to_numpy(state["m"]), "v": lm_tree_to_numpy(state["v"]),
            "step": np.asarray(int(state["step"]), np.int32)}


def lm_opt_state_from_numpy(cfg, state: Mapping, *, device=None) -> dict:
    """The inverse of ``lm_opt_state_to_numpy`` on ``device`` (None: the
    card); the moments keep their arrays' dtype."""
    dev = resolve_device(device)
    return {"m": lm_tree_from_numpy(cfg, state["m"], device=dev),
            "v": lm_tree_from_numpy(cfg, state["v"], device=dev),
            "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32,
                                 device=dev)}


def lm_decay_mask(params) -> dict:
    """The weight-decay mask of a port model (1.0 on the leaves of ndim >= 2
    in the JAX layout, where per-layer norm scales are stacked to 2-D)
    as nested dicts of float32 numpy scalars."""
    return lm_tree_to_numpy(tree_map(np.float32, _decay_mask(params)))


_NORM_KEYS = frozenset({"ln1", "ln2", "post_ln1", "post_ln2", "final_norm", "q_norm",
                        "k_norm", "q_ln", "kv_ln", "ln", "norm", "mamba_ln", "ln_x",
                        "enc_norm"})


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


# the recurrent families' leaves that are not weight matrices, from z
_SPECIAL = {
    # mamba2: A = -exp(a_log) in (-16, -1), as the init's log U(1, 16)
    "a_log": lambda z: np.log(1.0 + 15.0 * _sigmoid(z)),
    # inverse softplus of a step in (1e-3, 0.1), as the init's
    "dt_bias": lambda z: np.log(np.expm1(1e-3 + 0.099 * _sigmoid(z))),
    "d_skip": lambda z: 1.0 + 0.1 * z,
    # rwkv6: token-shift mixes in (0, 1); base decay around e^-2 (so
    # w = exp(-exp(w0 + lora)) in (e^-4, 1) after the cap)
    **{k: _sigmoid for k in ("mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "mu_ck", "mu_cr")},
    "w0": lambda z: -2.0 + 0.5 * z,
    "ln_scale": lambda z: 1.0 + 0.1 * z,
    "ln_in": lambda z: 1.0 + 0.1 * z,
    # biases and the rwkv bonus
    **{k: lambda z: 0.1 * z for k in ("conv_b", "u", "ln_bias", "ln_in_b", "b1", "b2")},
}


def seeded_numpy_params(cfg, seed: int) -> dict:
    """Weights for ``cfg`` (any LM family) in the JAX layout from
    ``np.random.default_rng(seed)``: one ``standard_normal`` draw z per
    leaf, leaves in sorted path order, cast to each leaf's dtype.  Norm
    scales are 0.1 z, ``embed`` z / sqrt(d_model), a weight matrix z /
    sqrt(shape[-2]) (its fan-in).  The recurrent families' other leaves
    (``_SPECIAL``) keep their init's range, so the models stay stable:
    mamba2's ``a_log`` = log(1 + 15 σ(z)), ``dt_bias`` the inverse softplus
    of 1e-3 + 0.099 σ(z), ``d_skip`` 1 + 0.1 z; rwkv6's ``mu_*`` σ(z), ``w0``
    -2 + 0.5 z, ``ln_scale``/``ln_in`` 1 + 0.1 z; biases (``conv_b``,
    ``ln_bias``, ``ln_in_b``, ``b1``, ``b2``) and rwkv6's bonus ``u`` 0.1 z.
    The transformer families have none of those leaves, so their draws
    are those of the rule before it was extended."""
    layout = lm_model(cfg, device="meta").empty_params().jax_layout()
    rng = np.random.default_rng(seed)
    drawn = {}
    for path, leaf in layout_leaves(layout):
        shape = layout_shape(leaf)
        w = rng.standard_normal(shape)
        key = path[-1]
        if key in _NORM_KEYS:
            w = 0.1 * w
        elif key in _SPECIAL:
            w = _SPECIAL[key](w)
        else:
            w = w / np.sqrt(shape[-1] if key == "embed" else shape[-2])
        drawn[path] = _numpy_of(torch.from_numpy(w.astype(np.float32)).to(
            first_leaf(leaf).dtype))

    def tree(node, path):
        if node is None or not isinstance(node, dict):
            return None if node is None else drawn[path]
        return {k: tree(v, path + (k,)) for k, v in node.items()}

    return tree(layout, ())


def leaf_checksums(tree: Mapping) -> dict[str, str]:
    """sha256 of each leaf's bytes, keyed by its '/'-joined path."""
    return {"/".join(path): hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()
            for path, a in layout_leaves(tree)}

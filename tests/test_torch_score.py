"""The port's streaming scoring against the JAX package's, on the CPU.

Artifacts are built by ``repro``, saved, and loaded by the port.  The
contract: for any chunking — sizes that do not divide the row count,
1-row tails, double buffering on or off — the streamed outputs are
BIT-IDENTICAL to one engine call over the whole input (dyadic leaves,
so also equal to the JAX package's ``score_file``); float rows bin chunk
by chunk with the artifact's grid; and the committed ``xgb_deep`` golden,
ingested and saved by ``repro`` and scored by the port with no mesh,
reproduces its recorded margins within ``rtol=1e-5, atol=1e-6`` (the
JAX package's own tolerance for that record).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.api as japi
import repro_torch
from repro.core.deploy import DeployConfig as JDeploy
from repro.core.quantize import FeatureQuantizer
from repro.core.trees import random_deep_ensemble as j_random_deep_ensemble
from repro.score import score_file as j_score_file
from repro_torch.score import (
    NpySource,
    ParquetSource,
    PredictionWriter,
    ScoreResult,
    open_columnar,
    score_file,
)

FIXTURES = Path(__file__).resolve().parent / "fixtures"


def _port(jcm, path):
    jcm.save(path)
    return repro_torch.CompiledModel.load(path)


@pytest.fixture(scope="module")
def binary(tmp_path_factory):
    """Gridless binary model (k/16 leaves), pre-binned queries, one-shot
    outputs of the port and the JAX artifact."""
    jcm = japi.build(j_random_deep_ensemble(n_trees=12, depth=4, n_features=9, n_bins=32, seed=3))
    cm = _port(jcm, tmp_path_factory.mktemp("binary") / "art")
    q = np.random.default_rng(0).integers(0, 32, size=(301, 9)).astype(np.int32)
    return jcm, cm, q, cm.raw_margin(q, device="cpu"), cm.predict(q, device="cpu")


@pytest.fixture(scope="module")
def multiclass(tmp_path_factory):
    jcm = japi.build(j_random_deep_ensemble(n_trees=9, depth=3, n_features=6, n_bins=16,
                                            task="multiclass", n_classes=3, seed=11))
    cm = _port(jcm, tmp_path_factory.mktemp("multiclass") / "art")
    q = np.random.default_rng(1).integers(0, 16, size=(157, 6)).astype(np.int32)
    return jcm, cm, q, cm.raw_margin(q, device="cpu"), cm.predict(q, device="cpu")


# -- streamed == one-shot ----------------------------------------------------------


@pytest.mark.parametrize("chunk_rows", [1, 7, 33, 100, 128, 300, 301, 400])
def test_chunked_bit_equal_one_shot_and_jax(binary, chunk_rows):
    jcm, cm, q, ref_m, ref_p = binary
    r = score_file(cm, q, kind="margin", chunk_rows=chunk_rows, device="cpu")
    np.testing.assert_array_equal(r.values, ref_m)
    assert r.values.dtype == ref_m.dtype
    assert r.n_chunks == -(-301 // chunk_rows)
    if chunk_rows in (7, 128, 301):  # and the JAX package's, at a few sizes
        np.testing.assert_array_equal(
            r.values, j_score_file(jcm, q, kind="margin", chunk_rows=chunk_rows).values)
    r = score_file(cm, q, kind="predict", chunk_rows=chunk_rows, device="cpu")
    np.testing.assert_array_equal(r.values, ref_p)


def test_double_buffer_off_same_bits(binary):
    _, cm, q, ref_m, _ = binary
    on = score_file(cm, q, kind="margin", chunk_rows=33, double_buffer=True, device="cpu")
    off = score_file(cm, q, kind="margin", chunk_rows=33, double_buffer=False, device="cpu")
    np.testing.assert_array_equal(on.values, ref_m)
    np.testing.assert_array_equal(off.values, on.values)
    assert on.double_buffered and not off.double_buffered


def test_multichannel_margins_stream_bit_equal(multiclass):
    jcm, cm, q, ref_m, ref_p = multiclass
    assert ref_m.shape[1] == 3
    for chunk in (13, 64, 157):
        r = score_file(cm, q, kind="margin", chunk_rows=chunk, device="cpu")
        np.testing.assert_array_equal(r.values, ref_m)
    r = score_file(cm, q, kind="predict", chunk_rows=50, device="cpu")
    np.testing.assert_array_equal(r.values, ref_p)
    np.testing.assert_array_equal(r.values, j_score_file(jcm, q, kind="predict", chunk_rows=50).values)
    assert r.values.dtype == np.int32


def test_soft_artifact_streams_bit_equal(tmp_path):
    """A soft artifact at tau = 0 (scores 0 or 1): chunked == one-shot."""
    ens = j_random_deep_ensemble(n_trees=6, depth=3, n_features=5, n_bins=16, seed=9)
    cm = _port(japi.build(ens, deploy=JDeploy(mode="soft", tau=0.0)), tmp_path / "soft")
    q = np.random.default_rng(2).integers(0, 16, size=(70, 5)).astype(np.int32)
    r = score_file(cm, q, kind="margin", chunk_rows=16, device="cpu")
    assert r.engine["kernel"] == "soft" and r.engine["table_dtype"] == "float32"
    np.testing.assert_array_equal(r.values, cm.raw_margin(q, device="cpu"))


def test_empty_and_one_row_tails(binary, multiclass):
    _, cm, q, ref_m, ref_p = binary
    r0 = score_file(cm, q[:0], kind="margin", device="cpu")
    assert r0.values.shape == (0, ref_m.shape[1]) and r0.n_chunks == 0 and r0.rows_per_s == 0.0
    _, mc, mq, _, _ = multiclass
    assert score_file(mc, mq[:0], kind="margin", device="cpu").values.shape == (0, 3)
    r1 = score_file(cm, q[:1], kind="predict", chunk_rows=64, device="cpu")
    np.testing.assert_array_equal(r1.values, ref_p[:1])
    r = score_file(cm, q, kind="margin", chunk_rows=q.shape[0] - 1, device="cpu")
    np.testing.assert_array_equal(r.values, ref_m)
    assert r.n_chunks == 2


def test_float_input_binned_chunkwise_bit_equal(tmp_path):
    rng = np.random.default_rng(7)
    xf = rng.normal(size=(203, 5))
    fq = FeatureQuantizer.fit(xf, n_bins=32)
    ens = j_random_deep_ensemble(n_trees=8, depth=4, n_features=5, n_bins=32, seed=5)
    jcm = japi.build(ens, quantizer=fq)
    cm = _port(jcm, tmp_path / "grid")
    assert cm.quantizer is not None
    ref = cm.raw_margin(fq.transform(xf), device="cpu")
    r = score_file(cm, xf, kind="margin", chunk_rows=48, device="cpu")
    assert r.binned
    np.testing.assert_array_equal(r.values, ref)
    np.testing.assert_array_equal(r.values, j_score_file(jcm, xf, kind="margin", chunk_rows=48).values)


# -- files ---------------------------------------------------------------------------


def test_npy_in_npy_out_round_trip(binary, tmp_path):
    _, cm, q, ref_m, _ = binary
    np.save(tmp_path / "rows.npy", q)
    r = score_file(cm, tmp_path / "rows.npy", kind="margin", chunk_rows=50,
                   out=tmp_path / "preds", device="cpu")
    assert r.path == tmp_path / "preds.npy"  # suffix appended
    np.testing.assert_array_equal(np.load(r.path), ref_m)
    np.testing.assert_array_equal(r.values, ref_m)


def test_artifact_path_accepted(binary, tmp_path):
    jcm, _, q, ref_m, _ = binary
    jcm.save(tmp_path / "art")
    r = score_file(tmp_path / "art", q, kind="margin", chunk_rows=100, device="cpu")
    np.testing.assert_array_equal(r.values, ref_m)


def test_parquet_source_streams(binary, tmp_path):
    pa = pytest.importorskip("pyarrow")
    import pyarrow.parquet as pq

    _, cm, q, ref_m, _ = binary
    pq.write_table(pa.table({f"f{i}": q[:, i] for i in range(q.shape[1])}),
                   tmp_path / "rows.parquet", row_group_size=64)
    r = score_file(cm, tmp_path / "rows.parquet", kind="margin", chunk_rows=37, device="cpu")
    np.testing.assert_array_equal(r.values, ref_m)
    r2 = score_file(cm, tmp_path / "rows.parquet", kind="margin", device="cpu",
                    columns=[f"f{i}" for i in range(q.shape[1])])
    np.testing.assert_array_equal(r2.values, ref_m)


def test_parquet_without_pyarrow_is_a_clean_import_error(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    (tmp_path / "rows.parquet").write_bytes(b"")
    with pytest.raises(ImportError, match="pyarrow"):
        ParquetSource(tmp_path / "rows.parquet")


# -- errors ------------------------------------------------------------------------


def test_error_surface(binary):
    _, cm, q, _, _ = binary
    with pytest.raises(ValueError, match="feature grid"):
        score_file(cm, q.astype(np.float64), device="cpu")
    with pytest.raises(ValueError, match="feature columns"):
        score_file(cm, q[:, :4], device="cpu")
    with pytest.raises(ValueError, match="kind"):
        score_file(cm, q, kind="margins", device="cpu")
    with pytest.raises(ValueError, match="chunk_rows"):
        score_file(cm, q, chunk_rows=0, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        score_file(cm, q, mesh=object())
    with pytest.raises(TypeError, match="CompiledModel"):
        score_file(object(), q, device="cpu")


def test_open_columnar_rejects_unknown_input(tmp_path):
    p = tmp_path / "rows.csv"
    p.write_text("1,2\n")
    with pytest.raises(ValueError, match="unsupported columnar input"):
        open_columnar(p)
    with pytest.raises(FileNotFoundError):
        open_columnar(tmp_path / "nope.npy")
    with pytest.raises(ValueError, match="2-D"):
        open_columnar(np.zeros(5))
    with pytest.raises(TypeError):
        open_columnar(3)


def test_writer_enforces_sequential_order():
    w = PredictionWriter(10)
    w.write(0, np.zeros((4, 2), np.float32))
    with pytest.raises(ValueError, match="out-of-order"):
        w.write(8, np.zeros((2, 2), np.float32))
    w.write(4, np.zeros((6, 2), np.float32))
    assert w.finalize().shape == (10, 2)
    with pytest.raises(ValueError, match="overruns"):
        PredictionWriter(2).write(0, np.zeros((3,), np.float32))
    with pytest.raises(ValueError, match="finalize"):
        PredictionWriter(3).finalize()


def test_npy_source_is_memory_mapped(tmp_path):
    q = np.arange(20, dtype=np.int32).reshape(10, 2)
    np.save(tmp_path / "r.npy", q)
    src = open_columnar(tmp_path / "r.npy")
    assert isinstance(src, NpySource) and isinstance(src.array, np.memmap)
    chunks = list(src.iter_chunks(4))
    assert [s for s, _ in chunks] == [0, 4, 8]
    assert not any(isinstance(c, np.memmap) for _, c in chunks)  # real copies
    np.testing.assert_array_equal(np.concatenate([c for _, c in chunks]), q)
    src.close()


# -- the golden record ---------------------------------------------------------------


def test_xgb_deep_golden_scored_by_the_port(tmp_path):
    """Ingested, built and saved by repro; loaded and scored by the port
    (no mesh) from the committed .npy; held to the frozen record."""
    exp = json.loads((FIXTURES / "ingest" / "xgb_deep.expected.json").read_text())
    japi.build(str(FIXTURES / "ingest" / "xgb_deep.json")).save(tmp_path / "art")
    cm = repro_torch.CompiledModel.load(tmp_path / "art")
    x = FIXTURES / "score" / "xgb_deep_x.npy"
    r = score_file(cm, x, kind="margin", chunk_rows=10, device="cpu")
    np.testing.assert_allclose(r.values, np.asarray(exp["raw_margin"], dtype=np.float32),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(r.values, cm.raw_margin(np.load(x), device="cpu"))
    rp = score_file(cm, x, kind="predict", chunk_rows=10, device="cpu")
    np.testing.assert_allclose(rp.values, np.asarray(exp["predict"]), rtol=1e-5, atol=1e-6)
    assert r.binned and r.n_chunks == 4


def test_score_result_reports_throughput(binary):
    _, cm, q, _, _ = binary
    r = score_file(cm, q, kind="predict", chunk_rows=100, device="cpu")
    assert isinstance(r, ScoreResult)
    assert r.n_rows == q.shape[0] and r.n_chunks == 4 and r.bucket == 128
    assert r.elapsed_s > 0 and r.rows_per_s > 0
    assert r.engine == {"backend": "jnp", "table_dtype": "uint8", "kernel": "v2",
                        "spmd": "gspmd", "noc_config": "accumulate", "devices": 1,
                        "device": "cpu"}

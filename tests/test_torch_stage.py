"""The engine's query staging slot (``XTimeEngine._stage``).

On the CPU: its host half, ``kops.write_queries`` over the engine's
column index, against ``pad_to_bucket(engine.select_features(q), ...)``
bit for bit in every table dtype, for integer inputs of three widths, on
tables that drop and permute columns, with the batch growing and
shrinking in one buffer, on read-only and strided inputs, and with the
same error for out-of-range bins; which inputs the engine stages.

On a card (marked ``gpu``; this file imports no JAX): the staged
``raw_margin`` / ``predict`` / ``margin_and_moments`` against the
``pad_queries`` block bit for bit, narrower batches after wider ones,
calls enqueued with no synchronise, two threads on two streams, and the
``engine.stage`` / ``engine.stage_alloc`` span counts under a profiler:

    python -m pytest -m gpu tests/test_torch_stage.py
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import repro_torch
from repro_torch import spans
from repro_torch.core.deploy import DeployConfig
from repro_torch.core.engine import XTimeEngine, _host_bins
from repro_torch.core.trees import random_deep_ensemble
from repro_torch.kernels import ops as kops

KINDS = ("plain", "feature_ids", "col_perm", "both")
DEPLOYS = {  # table dtype -> the binding that packs it
    "uint8": DeployConfig(table_dtype="uint8", mode="inclusive"),
    "uint16": DeployConfig(table_dtype="uint16", mode="inclusive"),
    "int32": DeployConfig(table_dtype="int32"),
    "float32": DeployConfig(mode="soft", tau=0.1),
}
N_BINS = 256


def _table(kind: str):
    """A 64-feature table: plain, with dropped columns (``feature_ids``),
    clustered (``col_perm``), or both (its dropped-column table given a
    permutation of its own)."""
    ens = random_deep_ensemble(n_trees=6, depth=3, n_features=64, n_bins=N_BINS,
                               task="multiclass", n_classes=3, seed=5)
    if kind == "plain":
        return repro_torch.build(ens).table
    if kind == "col_perm":
        return repro_torch.build(ens, cluster_columns=True).table
    table = repro_torch.build(ens, compress="full").table
    if kind == "both":
        perm = np.random.default_rng(1).permutation(table.n_cols).astype(np.int32)
        table = dataclasses.replace(table, col_perm=perm)
    return table


@pytest.fixture(scope="module")
def cpu_engines():
    tables = {kind: _table(kind) for kind in KINDS}
    engines = {(kind, dt): XTimeEngine(t, config=cfg, device="cpu")
               for kind, t in tables.items() for dt, cfg in DEPLOYS.items()}
    assert all(e.table_dtype == dt for (_, dt), e in engines.items())
    assert tables["plain"].feature_ids is None and tables["plain"].col_perm is None
    assert tables["feature_ids"].feature_ids is not None and tables["col_perm"].col_perm is not None
    assert tables["both"].feature_ids is not None and tables["both"].col_perm is not None
    return engines


def _padded(eng, q, b):
    """What ``pad_queries`` gives the kernel: ``b`` rows of the selected bins."""
    return kops.pad_to_bucket(eng.select_features(q), b, eng.arrays.f_pad,
                              dtype=eng.table_dtype, device="cpu").numpy()


def _written(eng, q, out):
    """The staging slot's host half on ``out``."""
    return kops.write_queries(_host_bins(q), out, eng.table_dtype, eng._column_index(q))


def _buffer(eng, rows=64):
    return np.zeros((rows, eng.arrays.f_pad), dtype=np.dtype(eng.table_dtype))


@pytest.mark.parametrize("qdtype", ["uint8", "int32", "int64"])
@pytest.mark.parametrize("dtype", sorted(DEPLOYS))
@pytest.mark.parametrize("kind", KINDS)
def test_write_queries_bit_equal_to_pad_to_bucket(cpu_engines, kind, dtype, qdtype):
    eng = cpu_engines[kind, dtype]
    rng = np.random.default_rng(7)
    out = _buffer(eng)
    for b in (5, 33, 64, 2):  # the batch grows, then shrinks, in one buffer
        q = rng.integers(0, N_BINS, size=(b, 64)).astype(qdtype)
        width = _written(eng, q, out)
        want = _padded(eng, q, b)
        assert out.dtype == want.dtype
        assert width == eng.select_features(q).shape[1]
        np.testing.assert_array_equal(out[:b], want)
        assert not out[:, width:].any()  # the padding columns stay zero


def _layout(q: np.ndarray, how: str):
    if how == "readonly":
        q = q.copy()
        q.setflags(write=False)
        return q
    if how == "strided":  # every other column of a wider block
        wide = np.zeros((q.shape[0], 2 * q.shape[1]), q.dtype)
        wide[:, ::2] = q
        return wide[:, ::2]
    if how == "fortran":
        return np.asfortranarray(q)
    if how == "tensor":
        return torch.from_numpy(q.copy())
    if how == "tensor_transposed":  # a CPU tensor view with swapped strides
        return torch.from_numpy(np.ascontiguousarray(q.T)).T
    raise ValueError(how)


@pytest.mark.parametrize("how", ["readonly", "strided", "fortran", "tensor",
                                 "tensor_transposed"])
@pytest.mark.parametrize("kind", KINDS)
def test_write_queries_odd_layouts(cpu_engines, kind, how):
    eng = cpu_engines[kind, "uint16"]
    q = np.random.default_rng(8).integers(0, N_BINS, size=(19, 64)).astype(np.int32)
    q_in = _layout(q, how)
    out = _buffer(eng)
    _written(eng, q_in, out)
    np.testing.assert_array_equal(out[:19], _padded(eng, q, 19))


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:
        return ("raised", str(e))


@pytest.mark.parametrize("case", ["over", "negative", "dropped_column"])
@pytest.mark.parametrize("dtype", ["uint8", "uint16"])
@pytest.mark.parametrize("kind", KINDS)
def test_out_of_range_bins_raise_the_same_error(cpu_engines, kind, dtype, case):
    eng = cpu_engines[kind, dtype]
    q = np.random.default_rng(9).integers(0, N_BINS, size=(6, 64)).astype(np.int64)
    kept = np.arange(64) if eng.feature_ids is None else eng.feature_ids
    dropped = np.setdiff1d(np.arange(64), kept)
    bad = np.iinfo(dtype).max + 1 if case != "negative" else -1
    col = dropped[0] if case == "dropped_column" and dropped.size else kept[3]
    q[2, col] = bad
    out = _buffer(eng)
    staged = _outcome(lambda: (_written(eng, q, out), out[:6].copy())[1])
    padded = _outcome(lambda: _padded(eng, q, 6))
    if isinstance(padded, tuple):
        assert staged == padded and "do not fit table dtype" in padded[1]
    else:  # only a dropped column held the bad bin: neither path raises
        assert case == "dropped_column" and dropped.size
        np.testing.assert_array_equal(staged, padded)


HOST_INPUTS = {  # input -> whether the engine stages it
    "numpy_uint8": (lambda: np.zeros((3, 4), np.uint8), True),
    "numpy_int64": (lambda: np.zeros((3, 4), np.int64), True),
    "tensor_int32": (lambda: torch.zeros((3, 4), dtype=torch.int32), True),
    "numpy_float": (lambda: np.zeros((3, 4), np.float32), False),
    "tensor_float": (lambda: torch.zeros((3, 4)), False),
    "tensor_bool": (lambda: torch.zeros((3, 4), dtype=torch.bool), False),
    "one_row_1d": (lambda: np.zeros(4, np.int32), False),
    "list": (lambda: [[0, 1], [2, 3]], False),
}


@pytest.mark.parametrize("name", sorted(HOST_INPUTS))
def test_host_bins_takes_integer_blocks_on_the_host(name):
    make, staged = HOST_INPUTS[name]
    q = make()
    got = _host_bins(q)
    assert (got is not None) == staged
    if staged:  # a view of the caller's bins, no copy
        assert isinstance(got, np.ndarray) and got.shape == tuple(q.shape)
        assert np.shares_memory(got, q.numpy() if isinstance(q, torch.Tensor) else q)


def test_cpu_engine_prepares_a_fresh_block(cpu_engines):
    eng = cpu_engines["both", "uint8"]
    q = np.random.default_rng(10).integers(0, N_BINS, size=(9, 64)).astype(np.uint8)
    a, b = eng._prep_queries(q), eng._prep_queries(q)
    assert a.data_ptr() != b.data_ptr()
    np.testing.assert_array_equal(a.numpy(), _padded(eng, q, 9))


# -- on the card ------------------------------------------------------------------------

CARD_DEPLOYS = {
    "uint8": DeployConfig(table_dtype="uint8", mode="inclusive"),
    "uint16": DeployConfig(table_dtype="uint16", mode="inclusive"),
    "int32": DeployConfig(table_dtype="int32"),
    "soft0": DeployConfig(mode="soft", tau=0.0),
    "soft0.1": DeployConfig(mode="soft", tau=0.1),
}
CARD_BATCHES = (1, 33, 1024, 37)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_model():
    ens = random_deep_ensemble(n_trees=40, depth=6, n_features=30, n_bins=N_BINS,
                               task="multiclass", n_classes=5, seed=3)
    return repro_torch.build(ens)


def _reference(eng, q):
    """The ``pad_queries`` block of ``q`` on the card."""
    return kops.pad_queries(eng.select_features(q), eng.arrays.f_pad,
                            dtype=eng.table_dtype, device=eng.device)


def _queries(seed, b, f=30, dtype=np.uint8):
    return np.random.default_rng(seed).integers(0, N_BINS, size=(b, f)).astype(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", sorted(CARD_DEPLOYS))
def test_staged_calls_bit_equal_to_pad_queries(card, card_model, variant):
    eng = XTimeEngine(card_model.table, config=CARD_DEPLOYS[variant], device=card)
    qdtype = np.int64 if variant == "int32" else np.uint8
    for i, b in enumerate(CARD_BATCHES):
        q = _queries(i, b, dtype=qdtype)
        ref = _reference(eng, q)
        assert torch.equal(eng._prep_queries(q), ref)
        m_ref = eng._margin_padded(ref)[:b]
        assert torch.equal(eng.raw_margin(q), m_ref)
        assert torch.equal(eng.predict(q), eng._predict_from_margin(m_ref))
        if eng.kernel_mode == "soft":
            margin, moments = eng.margin_and_moments(q)
            mom_ref = eng._reduced(ref, moments=True)[:b, : 3 * eng.table.n_outputs]
            assert torch.equal(margin, m_ref)
            assert torch.equal(moments, mom_ref)


@pytest.mark.gpu
def test_staged_columns_on_the_card(card):
    eng = XTimeEngine(_table("both"), config=CARD_DEPLOYS["uint8"], device=card)
    for i, b in enumerate(CARD_BATCHES):
        q = _queries(20 + i, b, f=64, dtype=np.int32)
        ref = _reference(eng, q)
        assert torch.equal(eng._prep_queries(q), ref)
        assert torch.equal(eng.raw_margin(q), eng._margin_padded(ref)[:b])


@pytest.mark.gpu
def test_narrower_batch_clears_the_columns_it_left(card, card_model):
    """Queries narrower than the table take zero columns past their width,
    however wide the slot's previous batch was."""
    eng = XTimeEngine(card_model.table, config=CARD_DEPLOYS["uint8"], device=card)
    for i, f in enumerate((30, 12, 30, 1)):
        q = _queries(50 + i, 64, f=f)
        ref = _reference(eng, q)
        assert torch.equal(eng._prep_queries(q), ref)
        assert torch.equal(eng.raw_margin(q), eng._margin_padded(ref)[:64])


@pytest.mark.gpu
def test_calls_enqueued_without_a_synchronise(card, card_model):
    eng = XTimeEngine(card_model.table, config=CARD_DEPLOYS["uint8"], device=card)
    qs = [_queries(100 + i, 1024 if i % 3 else 200) for i in range(8)]
    outs = [eng.raw_margin(q) for q in qs]  # no synchronise between the calls
    for q, out in zip(qs, outs):
        assert torch.equal(out, eng._margin_padded(_reference(eng, q))[: q.shape[0]])


@pytest.mark.gpu
def test_two_threads_on_two_streams(card, card_model):
    eng = XTimeEngine(card_model.table, config=CARD_DEPLOYS["uint8"], device=card)
    got, errors = {}, []

    def client(k):
        try:
            stream = torch.cuda.Stream(card)
            with torch.cuda.stream(stream):
                for i in range(20):
                    q = _queries(1000 * k + i, 1024 if i % 2 else 77)
                    got[k, i] = (q, eng.raw_margin(q).cpu())
        except Exception as e:  # noqa: BLE001 - reported on the main thread
            errors.append(e)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(got) == 40
    for q, out in got.values():
        assert torch.equal(out, eng._margin_padded(_reference(eng, q))[: q.shape[0]].cpu())


@pytest.mark.gpu
def test_stage_spans_count_calls_and_growths(card, card_model):
    eng = XTimeEngine(card_model.table, config=CARD_DEPLOYS["uint8"], device=card)
    batches = (1, 33, 1024, 37, 1024, 2)  # capacity 1, 64, 1024: three slots made
    with spans.span("outside"):  # a span with the profiler off: the window starts afresh
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        for i, b in enumerate(batches):
            eng.raw_margin(_queries(i, b))
        torch.cuda.synchronize(card)
    t = spans.totals()
    assert t["engine.stage"]["count"] == len(batches)
    assert t["engine.stage"]["parents"] == {"engine.prep": len(batches)}
    assert t["engine.stage_alloc"]["count"] == 3
    assert t["engine.stage_alloc"]["parents"] == {"engine.stage": 3}

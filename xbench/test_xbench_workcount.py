"""The work count against a hand count, and the trace reduction on a
hand-made trace."""

import pytest

from xbench import trace, workcount

HAND = {"n_trees": 3, "depth": 2, "n_features": 5, "n_bins": 16, "task": "binary",
        "n_classes": 2}


def test_whole_bytes():
    assert [workcount.whole_bytes(n) for n in (2, 256, 257, 968, 65536, 65537)] == [1, 1, 2, 2, 2, 4]


def test_hand_count():
    # a tree of depth 2: 2 compares + 1 leaf add a row; 3 inner nodes of
    # (1-byte feature + 1-byte threshold) and 4 float32 leaves
    assert workcount.ops_per_row(HAND) == 3 * 3
    assert workcount.model_bytes(HAND) == 3 * (3 * 2 + 4 * 4)
    assert workcount.row_bytes(HAND) == 5 * 1 + 1 * 4
    peak = {"ops_per_s": 9.0, "bytes_per_s": 10.0}
    # 2 rows in 1 launch: 18 ops (2 s) against 66 + 18 bytes (8.4 s)
    assert workcount.least_seconds(HAND, 2, 1, peak) == pytest.approx(8.4)
    # the same rows in 2 launches read the model twice
    assert workcount.least_seconds(HAND, 2, 2, peak) == pytest.approx(15.0)
    assert workcount.least_seconds(HAND, 2, 1, {"ops_per_s": 1.0, "bytes_per_s": 1e9}) == 18.0


def test_counts_read_only_sizes():
    multi = {**HAND, "task": "multiclass", "n_classes": 8, "n_features": 968, "n_bins": 1024}
    assert workcount.row_bytes(multi) == 968 * 2 + 8 * 4
    assert workcount.model_bytes(multi) == 3 * (3 * (2 + 2) + 4 * 4)


def test_peaks_table():
    assert workcount.peaks("NVIDIA H100 80GB HBM3") == {"ops_per_s": 1.979e15,
                                                        "bytes_per_s": 3.35e12}
    assert workcount.peaks("some other card") is None


def ev(name, dev, a, b):
    return trace.Event(name, dev, a, b)


def test_trace_reduction():
    events = [
        ev(trace.WINDOW, False, 0, 100),
        ev("score_file", False, 0, 100),
        ev("aten::copy_", False, 60, 90),
        ev("void cam_match_u8_kernel<128, true>(BPArgs<unsigned char>)", True, 10, 40),
        ev("reduce_splits_kernel(float const*, float const*)", True, 30, 50),
        ev("Memcpy HtoD (Pageable -> Device)", True, 95, 120),
        ev("void cam_match_u8_kernel<128, true>(BPArgs<unsigned char>)", True, -5, 5),
    ]
    s = trace.reduce(events)
    assert s.window_s == pytest.approx(100e-9)
    assert s.busy_s == pytest.approx((5 + 40 + 5) * 1e-9)  # [0,5] [10,50] [95,100]
    assert s.launches_of(r"cam_match\w*_kernel") == 2
    assert s.seconds_of(r"cam_match|reduce_splits") == pytest.approx((30 + 5 + 20) * 1e-9)
    assert s.kernel_n == {"cam_match_u8_kernel<128, true>": 2, "reduce_splits_kernel": 1,
                          "Memcpy HtoD": 1}
    # gaps [5,10], [50,95]: the longest is named by the innermost host span over it
    assert s.idle_gaps[0] == ["aten::copy_", pytest.approx(45e-9)]
    assert s.idle_gaps[1] == ["score_file", pytest.approx(5e-9)]
    with pytest.raises(ValueError):
        trace.reduce(events[1:])

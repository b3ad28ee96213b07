"""First use from many threads at once: the kernel library is built and
loaded once, an artifact's engine is bound once.

The build runs here with a stub in place of ``nvcc`` (a script that
writes its ``-o`` file, refuses to overwrite one, and logs each call), so
the test needs no card and no CUDA toolkit.  Every thread starts at one
barrier and is joined with a timeout.
"""

import ctypes
import os
import stat
import sys
import threading
import time
import types

import numpy as np
import pytest

import repro_torch
from repro_torch.core import engine as engine_mod
from repro_torch.core.trees import random_deep_ensemble
from repro_torch.kernels import cam_match as K

N_THREADS = 8

STUB = """#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
if os.path.exists(out):
    sys.exit("clobbered " + out)
with open({log!r}, "a") as f:
    f.write(("link" if "-shared" in sys.argv else "compile") + " " + out + "\\n")
time.sleep(0.2)
with open(out, "w") as f:
    f.write("stub")
"""


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """``_nvcc`` -> the stub, ``BUILD_DIR`` -> a fresh directory, and no
    library loaded yet.  Yields the stub's call log."""
    log = tmp_path / "nvcc.log"
    stub = tmp_path / "nvcc"
    stub.write_text(STUB.format(python=sys.executable, log=str(log)))
    stub.chmod(stub.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(K, "_nvcc", lambda: str(stub))
    monkeypatch.setattr(K, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(K, "_LIB", None)
    return log


def _at_once(fn, n=N_THREADS, timeout=60.0):
    """Run ``fn()`` on ``n`` threads released together; return the results."""
    barrier = threading.Barrier(n)
    results, errors = [None] * n, []

    def work(i):
        try:
            barrier.wait(timeout=timeout)
            results[i] = fn()
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=timeout)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    return results


def _calls(log):
    return log.read_text().splitlines()


def test_concurrent_build_runs_nvcc_once(stub_nvcc):
    infos = _at_once(K.build)
    calls = _calls(stub_nvcc)
    assert sorted(c.split()[0] for c in calls) == ["compile"] * len(K.SOURCES) + ["link"]
    assert len({info.path for info in infos}) == 1
    assert sum(info.seconds > 0 for info in infos) == 1  # the others found it built
    built = sorted(os.listdir(K.BUILD_DIR))
    lib = infos[0].path
    assert built == sorted([lib.name, lib.with_suffix(".log").name])  # no stray .o / .tmp.so
    assert lib.read_text() == "stub"


def test_concurrent_library_loads_once(stub_nvcc, monkeypatch):
    loaded = []

    def fake_cdll(path):
        loaded.append(path)
        time.sleep(0.05)  # keep the window open for a second loader
        return types.SimpleNamespace(
            xtime_cam_match=types.SimpleNamespace(),
            xtime_cam_match_soft=types.SimpleNamespace(),
            xtime_error_string=types.SimpleNamespace(),
        )

    monkeypatch.setattr(ctypes, "CDLL", fake_cdll)
    libs = _at_once(K._library)
    assert len(loaded) == 1
    assert all(lib is libs[0] for lib in libs)
    assert libs[0].xtime_cam_match.restype is ctypes.c_int  # bound once, fully
    assert len(_calls(stub_nvcc)) == len(K.SOURCES) + 1


def test_concurrent_engine_binds_once(monkeypatch):
    ens = random_deep_ensemble(n_trees=6, depth=3, n_features=7, n_bins=32, seed=2)
    cm = repro_torch.build(ens)
    real = engine_mod.XTimeEngine.from_config
    binds = []

    def slow_bind(*args, **kwargs):
        binds.append(1)
        time.sleep(0.05)  # a full-width bind takes seconds
        return real(*args, **kwargs)

    monkeypatch.setattr(engine_mod.XTimeEngine, "from_config", slow_bind)
    engines = _at_once(lambda: cm.engine("cpu"))
    assert len(binds) == 1
    assert all(e is engines[0] for e in engines)
    x = np.random.default_rng(0).integers(0, 32, size=(9, 7))
    np.testing.assert_array_equal(engines[0].predict(x).numpy(), ens.predict(x))
    # other overrides still bind their own engine, once
    _at_once(lambda: cm.engine("cpu", table_dtype="int32"))
    assert len(binds) == 2

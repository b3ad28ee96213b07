"""The port's import boundary and its default device.

(a) importing every ``repro_torch`` module loads no ``jax`` and nothing
of ``repro``; (h) entry points called without ``device`` run on the card,
so with no card they raise instead of falling back to the CPU.
"""

import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.engine import XTimeEngine
from repro_torch.core.trees import random_deep_ensemble

SRC = Path(__file__).resolve().parents[1] / "src"
ROOT = SRC.parent


def _all_modules() -> list[str]:
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return sorted(names)


def test_every_module_is_listed():
    mods = _all_modules()
    for want in ("repro_torch.api", "repro_torch.convert", "repro_torch.core.engine",
                 "repro_torch.kernels.cam_match", "repro_torch.kernels.ops",
                 "repro_torch.kernels.ref", "repro_torch.core.precision",
                 "repro_torch.core.defects"):
        assert want in mods


@pytest.mark.parametrize("entry", ["package", "chip_smoke"])
def test_no_jax_and_no_repro_loaded(entry):
    """A fresh interpreter imports every port module (or chip_smoke.py)
    and then holds no ``jax*`` and no ``repro``/``repro.*`` module — the
    ``repro_torch`` prefix is not ``repro``."""
    if entry == "package":
        body = "\n".join(f"import {m}" for m in _all_modules())
    else:
        body = (
            "import importlib.util\n"
            f"spec = importlib.util.spec_from_file_location('chip_smoke', {str(ROOT / 'chip_smoke.py')!r})\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
        )
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(SRC)!r})\n"
        f"{body}\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'jaxlib' or m.startswith('jaxlib.')\n"
        "             or m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _small_model():
    ens = random_deep_ensemble(n_trees=4, depth=3, n_features=5, n_bins=32,
                               task="regression", seed=0)
    return ens, repro_torch.build(ens)


def test_default_device_is_the_card(monkeypatch):
    """Without ``device`` every entry point binds CUDA; with no card it
    raises a clear error and never continues on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ens, cm = _small_model()
    x = np.zeros((3, 5), dtype=np.uint8)
    for call in (lambda: cm.predict(x), lambda: cm.raw_margin(x),
                 lambda: cm.engine(), lambda: XTimeEngine(cm.table)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the CPU is used only when asked for
    np.testing.assert_array_equal(cm.predict(x, device="cpu"), ens.predict(x))


def test_cuda_tensor_never_takes_the_plain_version(monkeypatch):
    """``ops.cam_match`` on a CUDA tensor goes to the kernel wrapper (which
    here, with no card and no nvcc, raises) — never to the plain version."""
    from repro_torch.kernels import cam_match as K
    from repro_torch.kernels import ops

    calls = []

    def fake_kernel(*args, **kwargs):
        calls.append(kwargs["mode"])
        raise RuntimeError("kernel unavailable")

    class FakeCuda:
        is_cuda = True

    monkeypatch.setattr(K, "cam_match_cuda", fake_kernel)
    with pytest.raises(RuntimeError, match="kernel unavailable"):
        ops.cam_match(FakeCuda(), None, None, None, None, out_b=1, out_c=1, mode="direct")
    assert calls == ["direct"]


def test_cuda_tensor_in_soft_mode_goes_to_the_soft_kernel(monkeypatch):
    """``mode='soft'`` on a CUDA tensor goes to the soft kernel wrapper with
    its temperature — never to the hard kernel or the plain version."""
    from repro_torch.kernels import cam_match as K
    from repro_torch.kernels import ops

    calls = []

    def fake_soft(*args, **kwargs):
        calls.append(kwargs["tau"])
        raise RuntimeError("soft kernel unavailable")

    def fake_hard(*args, **kwargs):
        raise AssertionError("the hard kernel got a soft call")

    class FakeCuda:
        is_cuda = True

    monkeypatch.setattr(K, "cam_match_soft_cuda", fake_soft)
    monkeypatch.setattr(K, "cam_match_cuda", fake_hard)
    with pytest.raises(RuntimeError, match="soft kernel unavailable"):
        ops.cam_match(FakeCuda(), None, None, None, None, out_b=1, out_c=1, mode="soft",
                      tau=0.25)
    assert calls == [0.25]

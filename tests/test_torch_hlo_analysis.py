"""The port's HLO text parser (``repro_torch.launch.hlo_analysis``) against
the JAX package's, on HLO text JAX emits inside the test.

One subprocess with its own 8-fake-device ``XLA_FLAGS`` (as
``tests/test_roofline.py`` runs) compiles ``tests/test_roofline.py``'s
three programs — the scanned and the unrolled stack on a (2, 4) mesh, and
the scan whose weights are sharded on `model` (collectives) — and prints
their ``compiled.as_text()``.  Both packages' ``analyze`` must give
``HLOCost``s equal field for field on each text.  Then the port's
roofline terms on the H100's closed forms.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.launch import hlo_analysis as jhlo
from repro_torch.launch import hlo_analysis as thlo

SRC = Path(__file__).resolve().parents[1] / "src"

_EMIT = r"""
import json
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_host_mesh

mesh = make_host_mesh(2, 4)

def body(x, w):
    return jnp.tanh(x @ w), None

def fn_scan(x, ws):
    y, _ = jax.lax.scan(body, x, ws)
    return y.sum()

def fn_unroll(x, ws):
    for i in range(ws.shape[0]):
        x, _ = body(x, ws[i])
    return x.sum()

def sds(shape, spec):
    return jax.ShapeDtypeStruct(shape, jnp.float32, sharding=NamedSharding(mesh, spec))

x = sds((32, 256), P("data", None))
ws12 = sds((12, 256, 256), P(None, None, "model"))
ws10 = sds((10, 256, 256), P(None, None, "model"))
print(json.dumps({
    "scan": jax.jit(fn_scan).lower(x, ws12).compile().as_text(),
    "unroll": jax.jit(fn_unroll).lower(x, ws12).compile().as_text(),
    "collective": jax.jit(fn_scan).lower(x, ws10).compile().as_text(),
}))
"""


@pytest.fixture(scope="module")
def hlo_texts() -> dict:
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(SRC)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", _EMIT], capture_output=True, text=True,
                         env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("program", ["scan", "unroll", "collective"])
def test_analyze_equals_the_reference_field_for_field(hlo_texts, program):
    text = hlo_texts[program]
    want = dataclasses.asdict(jhlo.analyze(text))
    got = dataclasses.asdict(thlo.analyze(text))
    assert got == want
    # and the texts are the programs test_roofline.py holds to closed forms
    if program == "scan":
        assert got["trip_counts"] == [12]
        np.testing.assert_allclose(got["dot_flops"], 12 * 16 * 256 * 64 * 2, rtol=0.02)
    if program == "collective":
        assert got["collective_bytes"] > 0


def test_parse_hlo_equals_the_reference(hlo_texts):
    """The parsed computations, instruction by instruction."""
    for text in hlo_texts.values():
        want, got = jhlo.parse_hlo(text), thlo.parse_hlo(text)
        assert list(got) == list(want)
        for name in want:
            assert ([dataclasses.astuple(i) for i in got[name].instructions]
                    == [dataclasses.astuple(i) for i in want[name].instructions])


def test_roofline_terms_on_h100_closed_forms():
    cost = thlo.HLOCost(dot_flops=989e12, fusion_boundary_bytes=3.35e12,
                        collective_bytes=450e9)
    t = thlo.roofline_from_cost(cost, model_flops_per_dev=494.5e12)
    np.testing.assert_allclose([t.compute_s, t.memory_s, t.collective_s], [1.0, 1.0, 1.0])
    assert abs(t.useful_flop_ratio - 0.5) < 1e-12
    # each term alone dominates where it is the largest
    for field, dominant, seconds in (("dot_flops", "compute", 2 * 989e12 / 989e12),
                                     ("fusion_boundary_bytes", "memory", 2.0),
                                     ("collective_bytes", "collective", 2.0)):
        c = dataclasses.replace(cost, **{field: 2 * getattr(cost, field)})
        t = thlo.roofline_from_cost(c)
        assert t.dominant == dominant
        np.testing.assert_allclose(t.bound_s, seconds)
        assert t.useful_flop_ratio == 0.0
    row = thlo.roofline_from_cost(cost, model_flops_per_dev=989e12).as_row()
    assert row["model_flops_ratio"] == 1.0 and row["hlo_flops_per_dev"] == 989e12
    assert (thlo.PEAK_FLOPS, thlo.HBM_BW, thlo.NVLINK_BW) == (989e12, 3.35e12, 450e9)

"""The port's all-to-all MoE (``make_shardmap_moe``) on a (2, 4) mesh of
logical CPU shards, and the MoE hooks.

No drops (capacity factor 16): the output, aux and gradients against
``moe_forward`` of both packages.  Drops: the output and aux against the
JAX package's ``make_shardmap_moe``, run in a subprocess with its own
8-fake-device ``XLA_FLAGS`` (this process sets none), and each device's
dropped assignments compared bit for bit.  ``set_impl``/``set_shard_hooks``
installed and removed."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ffn as jffn
from repro.models import moe as jmoe
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe as tmoe
from repro_torch.models.moe_shardmap import make_shardmap_moe

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
D, F, E, K = 32, 64, 8, 2
X_SHAPE = (4, 16, D)


def _arrays(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    n = lambda *s, scale=0.2: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    return {"router": n(D, E, scale=1.0), "w_gate": n(E, D, F), "w_up": n(E, D, F),
            "w_down": n(E, F, D), "x": n(*X_SHAPE, scale=1.0),
            "shared": {"w_gate": n(D, F), "w_up": n(D, F), "w_down": n(F, D)}}


def _port_params(arr) -> tmoe.MoEParams:
    p = tmoe.MoEParams(D, F, E, 1, torch.float32, device="cpu")
    with torch.no_grad():
        for name in ("router", "w_gate", "w_up", "w_down"):
            getattr(p, name).copy_(torch.from_numpy(arr[name]))
        for name, a in arr["shared"].items():
            getattr(p.shared, name).copy_(torch.from_numpy(a))
    return p


def _jax_params(arr) -> jmoe.MoEParams:
    return jmoe.MoEParams(router=arr["router"], w_gate=arr["w_gate"], w_up=arr["w_up"],
                          w_down=arr["w_down"], shared=jffn.FFNParams(**arr["shared"]))


def _mesh():
    return make_host_mesh(2, 4, devices=["cpu"] * 8)


def _grads(fn, p, x):
    """d/d(x, every weight) of sum(y^2) + 0.01 aux."""
    y, aux = fn(p, x, top_k=K, capacity_factor=16.0)
    return torch.autograd.grad((y * y).sum() + 0.01 * aux, [x, *p.parameters()])


def test_no_drops_equals_moe_forward_of_both_packages():
    arr = _arrays(0)
    p = _port_params(arr)
    x = torch.from_numpy(arr["x"]).requires_grad_(True)
    sm = make_shardmap_moe(_mesh())
    out, aux = sm(p, x, top_k=K, capacity_factor=16.0)
    assert int(sm.dropped) == 0
    ref, raux = tmoe.moe_forward(p, x, top_k=K, capacity_factor=16.0)
    jref, jaux = jmoe.moe_forward(_jax_params(arr), jnp.asarray(arr["x"]), top_k=K,
                                  capacity_factor=16.0)
    scale = max(1.0, float(ref.detach().abs().max()))
    assert float((out - ref).abs().max()) < 1e-4 * scale
    assert np.abs(out.detach().numpy() - np.asarray(jref)).max() < 1e-4 * scale
    assert abs(float(aux) - float(raux)) < 1e-5 and abs(float(aux) - float(jaux)) < 1e-5
    for g, r in zip(_grads(sm, p, x), _grads(tmoe.moe_forward, p, x), strict=True):
        assert float((g - r).abs().max()) < 1e-4 * max(1.0, float(r.abs().max()))
        assert float(g.abs().sum()) > 0


_JAX_SHARDMAP = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_host_mesh
from repro.models.ffn import FFNParams
from repro.models.moe import MoEParams
from repro.models.moe_shardmap import make_shardmap_moe
from jax.experimental.shard_map import shard_map


def keep_of(cf):
    # each device's keep mask: the routing lines of the reference's
    # _local_moe, in the same shard_map layout
    def local(xb, router):
        t_dev, d = xb.shape[0] * xb.shape[1], xb.shape[2]
        e, k = router.shape[1], 2
        probs = jax.nn.softmax(xb.reshape(t_dev, d).astype(jnp.float32) @ router, axis=-1)
        _, gate_idx = jax.lax.top_k(probs, k)
        onehot = jax.nn.one_hot(gate_idx, e, dtype=jnp.float32)
        flat = gate_idx.reshape(t_dev * k)
        cum = jnp.cumsum(onehot.reshape(t_dev * k, e).astype(jnp.int32), axis=0)
        rank = jnp.take_along_axis(cum, flat[:, None], axis=1)[:, 0] - 1
        c_dev = int(max(1, round(t_dev * k / e * cf)))
        return (rank < c_dev).reshape(1, 1, t_dev * k)
    return shard_map(local, mesh=mesh, in_specs=(P("data", "model", None), P(None, None)),
                     out_specs=P("data", "model", None), check_rep=False)

src, dst, cfs = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
z = np.load(src)
mesh = make_host_mesh(2, 4)
p = MoEParams(router=z["router"], w_gate=z["w_gate"], w_up=z["w_up"], w_down=z["w_down"],
              shared=FFNParams(z["s_gate"], z["s_up"], z["s_down"]))
ps = jax.device_put(p, jax.tree.map(
    lambda a: NamedSharding(mesh, P("model", None, None) if a.ndim == 3
              else P(*([None] * a.ndim))), p))
xs = jax.device_put(jnp.asarray(z["x"]), NamedSharding(mesh, P("data", "model", None)))
sm = make_shardmap_moe(mesh)
out = {}
for cf in cfs:
    y, aux = jax.jit(lambda pp, xx: sm(pp, xx, top_k=2, capacity_factor=cf))(ps, xs)
    out[f"y{cf}"], out[f"aux{cf}"] = np.asarray(y), np.asarray(aux)
    out[f"keep{cf}"] = np.asarray(jax.jit(keep_of(cf))(xs, p.router))
np.savez(dst, **out)
print(json.dumps({"n_dev": len(jax.devices())}))
"""


def _jax_shardmap(arr, tmp_path, cfs) -> dict:
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, x=arr["x"], router=arr["router"], w_gate=arr["w_gate"], w_up=arr["w_up"],
             w_down=arr["w_down"], **{f"s_{k[2:]}": v for k, v in arr["shared"].items()})
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"}
    run = subprocess.run([sys.executable, "-c", _JAX_SHARDMAP, str(src), str(dst),
                          json.dumps(cfs)], capture_output=True, text=True, env=env,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    assert json.loads(run.stdout.strip().splitlines()[-1])["n_dev"] == 8
    with np.load(dst) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("cf", [1.0, 0.5])
def test_drops_equal_the_jax_shardmap_moe(tmp_path, cf):
    """Per-device capacity: the output and aux within 1e-5 x scale of the
    JAX package's, and each device's keep mask bit-equal to the one the
    reference's routing lines give in its shard_map layout (the output
    check binds them to its program: a token that drops elsewhere moves
    its output by its gated expert output)."""
    arr = _arrays(1)
    ref = _jax_shardmap(arr, tmp_path, [cf])
    p = _port_params(arr)
    x = torch.from_numpy(arr["x"])
    sm = make_shardmap_moe(_mesh())
    with torch.no_grad():
        out, aux = sm(p, x, top_k=K, capacity_factor=cf)
    assert int(sm.dropped) > 0
    scale = max(1.0, float(np.abs(ref[f"y{cf}"]).max()))
    assert np.abs(out.numpy() - ref[f"y{cf}"]).max() < 1e-5 * scale
    assert abs(float(aux) - float(ref[f"aux{cf}"])) < 1e-5
    keep = np.stack([k.numpy() for k in sm.keep]).reshape(ref[f"keep{cf}"].shape)
    np.testing.assert_array_equal(keep, ref[f"keep{cf}"])


def test_set_impl_and_shard_hooks_install_and_remove():
    arr = _arrays(2)
    p = _port_params(arr)
    x = torch.from_numpy(arr["x"])
    with torch.no_grad():
        plain, plain_aux = tmoe.moe_forward(p, x, top_k=K, capacity_factor=1.0)
        sm = make_shardmap_moe(_mesh())
        try:
            tmoe.set_impl(sm)
            via, _ = tmoe.moe_forward(p, x, top_k=K, capacity_factor=1.0)
            assert torch.equal(via, sm(p, x, top_k=K, capacity_factor=1.0)[0])
            assert not torch.equal(via, plain)  # per-device capacity drops others
        finally:
            tmoe.set_impl(None)
        seen = {"tokens": 0, "experts": 0, "weights": 0}

        def hook(kind):
            def fn(t):
                seen[kind] += 1
                return t
            return fn

        try:
            tmoe.set_shard_hooks(hook("tokens"), hook("experts"), hook("weights"))
            hooked, hooked_aux = tmoe.moe_forward(p, x, top_k=K, capacity_factor=1.0)
        finally:
            tmoe.set_shard_hooks(None, None)
        assert seen == {"tokens": 4, "experts": 2, "weights": 3}
        again, again_aux = tmoe.moe_forward(p, x, top_k=K, capacity_factor=1.0)
    for got, got_aux in ((hooked, hooked_aux), (again, again_aux)):
        assert torch.equal(got, plain) and torch.equal(got_aux, plain_aux)
    assert tmoe._HOOKS["impl"] is None
    assert all(tmoe._HOOKS[k] is tmoe._identity for k in ("tokens", "experts", "weights"))

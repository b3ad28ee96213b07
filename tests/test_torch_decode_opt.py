"""The port's flash-decode merge against the JAX package's
``decode_attention`` on the same numpy inputs, on a (2, 4) mesh of
logical CPU shards (no XLA flag): the KV cache's sequence split over
`model`, each shard's partial softmax merged by max then scaled sums."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import decode_attention as jdecode
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.attention import decode_attention as tdecode
from repro_torch.models.decode_opt import flash_decode_shardmap
from repro_torch.sharding.partition import P
from repro_torch.sharding.placement import Sharded


def _inputs(seed, b, s, h, kv, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((b, 1, h, d), (b, s, kv, d), (b, s, kv, d))]


@pytest.mark.parametrize("kv", [1, 2])
@pytest.mark.parametrize("pos", [0, 15, 37, 63])
def test_flash_decode_matches_decode_attention(kv, pos):
    """Within 1e-5 x scale of both packages' ``decode_attention``, the
    positions past ``pos`` masked (pos 0: three shards hold no valid
    position; pos 15: one shard's last; 63: the whole cache)."""
    q, k, v = _inputs(pos + kv, 2, 64, 8, kv, 16)
    mesh = make_host_mesh(2, 4, devices=["cpu"] * 8)
    out = flash_decode_shardmap(mesh, *map(torch.from_numpy, (q, k, v)), pos).numpy()
    ref = np.asarray(jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos)))
    port = tdecode(*map(torch.from_numpy, (q, k, v)), pos).numpy()
    scale = max(1.0, float(np.abs(ref).max()))
    assert np.abs(out - ref).max() < 1e-5 * scale
    assert np.abs(out - port).max() < 1e-5 * scale


def test_flash_decode_on_a_sharded_cache_and_refusals():
    """A cache already ``Sharded`` on `model` (each shard's own slice) gives
    the whole cache's answer bit for bit; a sequence the shards do not
    divide raises."""
    q, k, v = map(torch.from_numpy, _inputs(5, 2, 64, 4, 1, 16))
    mesh = make_host_mesh(2, 4, devices=["cpu"] * 8)
    spec = P(None, "model", None, None)
    placed = flash_decode_shardmap(mesh, q, Sharded.place(mesh, spec, k),
                                   Sharded.place(mesh, spec, v), 40)
    assert torch.equal(placed, flash_decode_shardmap(mesh, q, k, v, 40))
    with pytest.raises(ValueError, match="does not split"):
        flash_decode_shardmap(mesh, q, k[:, :62], v[:, :62], 40)
    assert flash_decode_shardmap(mesh, q.to(torch.bfloat16), k, v, 40).dtype == torch.bfloat16

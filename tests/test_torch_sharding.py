"""The port's partition specs against the JAX package's, on the CPU.

``param_pspecs`` and ``cache_pspecs`` of every LM config at full size,
leaf for leaf in the reference's flatten order: the port's meta-device
shapes against the reference's ``eval_shape``, on stand-ins of the
production mesh (16 x 16, the multi-pod 2 x 16 x 16) that need no
devices, with FSDP on and off.  Then ``batch_pspec``, ``fit``'s prefix
rule for composite axes, ``activation_sharder``'s specs, and ``attach``.
No XLA flag: the reference's sharder is read by catching its
``with_sharding_constraint``."""

import jax
import numpy as np
import pytest
import torch

from repro.config import get_config as jget
from repro.configs import ASSIGNED_ARCHS
from repro.models.registry import build_model as jbuild
from repro.sharding import partition as jpart
from repro_torch.config import get_config as tget
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.registry import build_model as tbuild
from repro_torch.sharding import partition as tpart


class FakeMesh:
    axis_names = ("data", "model")
    devices = np.empty((16, 16), dtype=object)


class FakePodMesh:
    axis_names = ("pod", "data", "model")
    devices = np.empty((2, 16, 16), dtype=object)


MESHES = [(FakeMesh(), True), (FakePodMesh(), True), (FakeMesh(), False)]
IS_SPEC = dict(is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def _ref_specs(tree) -> list[tuple]:
    return [tuple(s) for s in jax.tree_util.tree_leaves(tree, **IS_SPEC)]


def _port_specs(tree) -> list[tuple]:
    return [tuple(s) for _, s in tpart.leaves_with_path(tree)]


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_and_cache_pspecs_equal_the_reference(arch):
    jcfg, tcfg = jget(arch), tget(arch)
    jb, tb = jbuild(jcfg), tbuild(tcfg, device="meta")
    jshapes, tshapes = jb.params_shape(), tb.params_shape()
    names = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jshapes)[0]]
    for mesh, fsdp in MESHES:
        jaxes, taxes = jpart.MeshAxes(mesh, fsdp=fsdp), tpart.MeshAxes(mesh, fsdp=fsdp)
        want = _ref_specs(jpart.param_pspecs(jshapes, jcfg, jaxes))
        got = _port_specs(tpart.param_pspecs(tshapes, tcfg, taxes))
        assert len(got) == len(want) == len(names)
        for name, g, w in zip(names, got, want):
            assert g == w, (arch, mesh.axis_names, fsdp, name, g, w)
        for b, s in ((8, 4096), (1, 512)):
            want = _ref_specs(jpart.cache_pspecs(jb.cache_shape(b, s), jcfg, jaxes))
            got = _port_specs(tpart.cache_pspecs(tb.cache_shape(b, s), tcfg, taxes))
            assert got == want, (arch, mesh.axis_names, fsdp, b, s)


def test_param_pspecs_leaf_shapes_equal_the_reference():
    """The specs are taken on the same shapes: the port's layout leaves
    (a ``Stack``'s stacked shape) equal ``eval_shape``'s leaf for leaf."""
    for arch in ASSIGNED_ARCHS:
        jshapes = jbuild(jget(arch)).params_shape()
        tshapes = tbuild(tget(arch), device="meta").params_shape().jax_layout()
        want = [tuple(x.shape) for x in jax.tree_util.tree_leaves(jshapes)]
        got = [tpart._shape(leaf) for _, leaf in tpart.leaves_with_path(tshapes)]
        assert got == want, arch


@pytest.mark.parametrize("mesh", [FakeMesh(), FakePodMesh()], ids=["data-model", "pod"])
def test_batch_pspec_and_fit_prefix_rule(mesh):
    jaxes, taxes = jpart.MeshAxes(mesh), tpart.MeshAxes(mesh)
    assert tuple(tpart.batch_pspec(taxes)) == tuple(jpart.batch_pspec(jaxes))
    assert taxes.batch_axes() == jaxes.batch_axes()
    cases = [
        (("data", "model"), (32, 48)),
        (("data", "model"), (24, 8)),
        ((("pod", "data"), None), (64, 3)),
        ((("pod", "data"), "model"), (6, 32)),  # 6 % 32: the prefix ('pod',) survives
        ((("pod", "data"), None), (3, 3)),  # no prefix divides: None
        (("model", ("pod", "data")), (16, 2)),
        ((None, "data", None), (4, 48, 5)),
    ]
    for spec, shape in cases:
        if any(isinstance(a, tuple) and "pod" not in mesh.axis_names for a in spec):
            continue
        assert tuple(taxes.fit(spec, shape)) == tuple(jaxes.fit(spec, shape)), (spec, shape)
    for axis in (None, "data", "model", ("data", "model")):
        assert taxes.axis_size(axis) == jaxes.axis_size(axis)


@pytest.mark.parametrize("mesh", [FakeMesh(), FakePodMesh()], ids=["data-model", "pod"])
def test_activation_sharder_specs_equal_the_reference(monkeypatch, mesh):
    """The reference's ``shard_x`` constrains to ``NamedSharding(mesh,
    spec)``: both are caught here, so its spec reads without devices."""
    caught = []
    monkeypatch.setattr(jpart, "NamedSharding", lambda m, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda t, spec: caught.append(tuple(spec)) or t)
    jshard = jpart.activation_sharder(mesh)
    tshard = tpart.activation_sharder(mesh)
    for shape in [(32, 512, 64), (32, 1, 64), (32, 100, 64), (6, 16, 8), (32, 64), (7, 64),
                  (3,)]:
        x = np.zeros(shape, np.float32)
        caught.clear()
        jshard(x)
        want = caught[0] if caught else None
        got = tshard.spec(shape)
        assert (None if got is None else tuple(got)) == want, shape
        t = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
        assert tshard(t) is t  # a value identity, as the constraint


def test_attach_local_shapes():
    """``attach``'s stand-ins: each leaf's spec and the shard a device
    holds by it (the bytes a dry run reads), on a host mesh."""
    mesh = make_host_mesh(4, 2, devices=["cpu"] * 8)
    cfg = tget("llama3.2-3b")
    shapes = tbuild(cfg, device="meta").params_shape()
    specs = tpart.param_pspecs(shapes, cfg, tpart.MeshAxes(mesh))
    placed = tpart.attach(mesh, shapes, specs)
    leaves = tpart.leaves_with_path(placed)
    assert [s.spec for _, s in leaves] == [s for _, s in tpart.leaves_with_path(specs)]
    by_name = {path[-1]: s for path, s in leaves}
    assert by_name["embed"].spec == tpart.P("model", "data")
    assert by_name["embed"].local_shape() == (cfg.vocab_size // 2, cfg.d_model // 4)
    assert by_name["final_norm"].local_shape() == (cfg.d_model,)
    assert by_name["wq"].local_shape()[0] == cfg.n_layers
    total = sum(s.local_bytes() for _, s in leaves)
    whole = sum(int(np.prod(s.shape)) * 2 for _, s in leaves)  # bfloat16
    assert whole / 8 <= total < whole / 8 * 1.01  # only norms are replicated

"""The port's dry run (``repro_torch.launch.dryrun`` and its counter
``launch.op_count``) and the engine's dry-run hooks, on the CPU at small
sizes; nothing is traced at full width here.

  * the counter against closed forms (one ``mm``; L identical layers give L
    times one; peak temps) and against ``FlopCounterMode`` on a real CPU
    train step of each LM family's smoke config (equal), and the meta
    prefill's dot FLOPs against the JAX package's ``analyze`` of the same
    smoke config's prefill, lowered in process on one CPU device;
  * the argument bytes of every assigned arch x {train_4k, decode_32k} on
    both production meshes against the local bytes of the JAX package's
    own specs, reckoned in numpy on a stand-in mesh;
  * every assigned arch's smoke config through ``run_cell`` on the CPU test
    grid (the four shape cells, their sequences cut), the skip rule, the
    command line's three lines, the X-TIME cell's closed forms;
  * the MoE counts' repair (``moe.expert_counts`` == ``bincount``; the
    two MoE smoke configs trace on meta);
  * the engine's hooks: their specs against the reference's (one
    subprocess with 8 fake XLA devices), their ``fn`` against
    ``raw_margin`` on logical CPU shards.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from _torch_lm import smoke_pair
from repro.config import SHAPES as JSHAPES
from repro.config import ShapeCell as JCell
from repro.config import get_config as jget
from repro.configs import ASSIGNED_ARCHS
from repro.launch.hlo_analysis import analyze as janalyze
from repro.models.registry import build_model as jbuild
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.sharding import partition as jpart
from repro_torch.api import build
from repro_torch.config import SHAPES, ShapeCell
from repro_torch.core.trees import random_deep_ensemble
from repro_torch.launch import dryrun
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.launch.op_count import OpCounter, count
from repro_torch.models import moe as tmoe
from repro_torch.models import moe_shardmap as tmoe_shardmap
from repro_torch.models.common import tree_tensors
from repro_torch.models.registry import build_model as tbuild
from repro_torch.optim.adamw import AdamW, AdamWConfig
from repro_torch.sharding.collectives import recording
from repro_torch.sharding import split as tsplit

SRC = Path(__file__).resolve().parents[1] / "src"
META = torch.device("meta")
# one smoke config a family: dense, moe (both MoE configs), hybrid, ssm, vlm, audio
FAMILIES = ["llama3.2-3b", "deepseek-v3-671b", "arctic-480b", "zamba2-2.7b", "rwkv6-1.6b",
            "llava-next-mistral-7b", "whisper-tiny"]
CPU1 = ["cpu"]


# -- the counter against closed forms -------------------------------------------------


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_one_mm_closed_form(device):
    m, k, n = 48, 80, 24
    a = torch.zeros((m, k), dtype=torch.bfloat16, device=device)
    b = torch.zeros((k, n), dtype=torch.bfloat16, device=device)
    out, cost = count(torch.mm, a, b)
    assert cost.dot_flops == 2 * m * k * n
    assert cost.op_bytes == (m * k + k * n + m * n) * 2
    assert cost.temp_bytes == cost.end_bytes == m * n * 2
    assert cost.n_ops == 1
    del out


def _layers(x, w, n):
    for _ in range(n):
        x = torch.tanh(x @ w)
    return x


@pytest.mark.parametrize("n", [1, 2, 5])
def test_identical_layers_count_n_times_one(n):
    """L calls of one layer: L x one layer's FLOPs, bytes and ops; the
    peak holds the layer's input, its product and its output (the
    arguments excluded), whatever L."""
    b, d = 16, 32
    x = torch.empty((b, d), device=META)
    w = torch.empty((d, d), device=META)
    _, one = count(_layers, x, w, 1)
    _, cost = count(_layers, x, w, n)
    assert (cost.dot_flops, cost.op_bytes, cost.n_ops) == (
        n * one.dot_flops, n * one.op_bytes, n * one.n_ops)
    assert one.dot_flops == 2 * b * d * d
    assert one.op_bytes == (b * d + d * d + b * d) * 4 + 2 * b * d * 4  # mm, then tanh
    assert cost.temp_bytes == (2 if n == 1 else 3) * b * d * 4
    assert cost.end_bytes == b * d * 4


def test_views_and_in_place_ops_allocate_nothing():
    x = torch.empty((64, 64), device=META)

    def fn(x):
        y = x * 2  # 16 KiB
        v = y.view(-1)[:10]  # a view keeps y's storage alive
        del y
        v.add_(1.0)  # in place: no new storage
        return v

    out, cost = count(fn, x)
    assert cost.temp_bytes == cost.end_bytes == 64 * 64 * 4
    assert cost.n_ops == 4  # mul, view, slice, add_: the views move no data
    assert cost.op_bytes == 2 * 64 * 64 * 4 + 2 * 10 * 4
    del out


def test_an_allocation_is_a_temp_that_moves_no_bytes():
    x = torch.empty((32, 32), dtype=torch.bfloat16, device=META)

    def fn(x):
        buf = torch.empty((32, 32), dtype=torch.float32, device=META)
        return buf.copy_(x)  # in place into the new storage

    out, cost = count(fn, x)
    assert cost.temp_bytes == cost.end_bytes == 32 * 32 * 4
    assert cost.op_bytes == 32 * 32 * (2 + 4 + 4)  # copy_: x and buf in, buf out
    del out


# -- the counter against FlopCounterMode and the JAX package ------------------------------


def _batch(cfg, specs, seed=0) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in specs.items():
        if v.dtype.is_floating_point:
            out[k] = torch.as_tensor(rng.standard_normal(tuple(v.shape)).astype(np.float32)
                                     ).to(v.dtype)
        else:
            out[k] = torch.as_tensor(rng.integers(0, cfg.vocab_size, tuple(v.shape))
                                     .astype(np.int32))
    return out


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_dot_flops_equal_flop_counter_on_a_real_cpu_step(arch):
    """The dry run's meta trace of a train step (loss_fn + backward + the
    AdamW update, on a (1, 1) mesh) counts the dot FLOPs FlopCounterMode
    counts over the same step on real CPU tensors, exactly."""
    _, cfg = smoke_pair(arch)
    cell = ShapeCell("train", 64, 2, "train")
    cost, _ = dryrun.reckon_lm(cfg, cell, make_host_mesh(1, 1, devices=CPU1), flash_blk=32)
    bundle = tbuild(cfg, 32, device="cpu")
    params = bundle.init_params(0)
    opt = AdamW(AdamWConfig(moment_dtype=dryrun._moe_moment_dtype(cfg)))
    state = opt.init(params)
    with FlopCounterMode(display=False) as fcm:
        _, _, grads = ttrain.loss_and_grads(bundle, params, _batch(cfg, bundle.input_specs(cell)))
        opt.update(grads, state, params)
    assert cost.dot_flops == fcm.get_total_flops() > 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_prefill_dot_flops_equal_the_jax_analyze(arch):
    """The meta prefill's dot FLOPs against the JAX package's ``analyze``
    of the same smoke config's prefill (jit-compiled on one CPU device).
    Tolerance: 0 — measured equal for every family (2 x 64 and 2 x 128
    tokens, flash blocks of 32: both packages run the same products block
    for block); a gap would name its cause."""
    jcfg, tcfg = smoke_pair(arch)
    cell = ShapeCell("prefill", 64, 2, "prefill")
    cost, _ = dryrun.reckon_lm(tcfg, cell, make_host_mesh(1, 1, devices=CPU1), flash_blk=32)
    jb = jbuild(jcfg, flash_blk=32)
    text = jax.jit(jb.prefill).lower(
        jb.params_shape(), jb.input_specs(JCell("prefill", 64, 2, "prefill"))).compile().as_text()
    assert cost.dot_flops == janalyze(text).dot_flops > 0


# -- argument bytes against the JAX package's specs ---------------------------------------


class FakeMesh:
    axis_names = ("data", "model")
    devices = np.empty((16, 16), dtype=object)


class FakePodMesh:
    axis_names = ("pod", "data", "model")
    devices = np.empty((2, 16, 16), dtype=object)


def _jax_local_bytes(tree, specs, axes) -> int:
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    total = 0
    for x, spec in zip(leaves, spec_leaves):
        spec = tuple(spec) + (None,) * (len(x.shape) - len(spec))
        local = [d // axes.axis_size(a) for d, a in zip(x.shape, spec)]
        total += int(np.prod(local, dtype=np.int64)) * np.dtype(x.dtype).itemsize
    return total


def _jax_argument_bytes(arch: str, shape: str, mesh) -> int:
    """The reference's dry-run arguments (``lower_cell``), their bytes a
    device, in numpy from its specs on a stand-in mesh."""
    cfg, cell = jget(arch), JSHAPES[shape]
    axes = jpart.MeshAxes(mesh)
    bundle = jbuild(cfg)
    params = bundle.params_shape()
    pspecs = jpart.param_pspecs(params, cfg, axes)
    total = _jax_local_bytes(params, pspecs, axes)
    specs = bundle.input_specs(cell)
    bspec = tuple(jpart.batch_pspec(axes))
    if cell.kind == "train":
        mdt = "bfloat16" if cfg.n_experts >= 128 else "float32"  # the reference's rule
        opt = jax.eval_shape(JAdamW(JAdamWConfig(moment_dtype=mdt)).init, params)
        total += 2 * _jax_local_bytes(opt["m"], pspecs, axes) + 4  # m, v, int32 step
    if cell.kind == "decode":
        total += _jax_local_bytes(specs["cache"], jpart.cache_pspecs(specs["cache"], cfg, axes),
                                  axes)
        tok = specs["token"]
        total += _jax_local_bytes([tok], [axes.fit(bspec, tok.shape)], axes) + 4
    else:
        for x in specs.values():
            spec = (axes.fit(bspec + (None,) * (len(x.shape) - 1), x.shape)
                    if x.shape and x.shape[0] == cell.global_batch else ())
            total += _jax_local_bytes([x], [jax.sharding.PartitionSpec(*spec)], axes)
    return total


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_argument_bytes_equal_the_jax_specs(arch):
    for shape in ("train_4k", "decode_32k"):
        for multi_pod, fake in ((False, FakeMesh()), (True, FakePodMesh())):
            got = dryrun.argument_bytes(dryrun.get_config(arch), SHAPES[shape],
                                        dryrun.meta_mesh(multi_pod))
            assert got == _jax_argument_bytes(arch, shape, fake), (shape, multi_pod)


def test_argument_bytes_equal_the_placed_state():
    """On a (2, 2) mesh of logical CPU shards: what ``place_params``,
    ``AdamW.init`` and ``place_batch`` put on device (0, 0) is what the
    dry run reckons."""
    _, cfg = smoke_pair("deepseek-v3-671b")
    cell = ShapeCell("train", 64, 4, "train")
    mesh = make_host_mesh(2, 2, devices=["cpu"] * 4)
    bundle = tbuild(cfg, device="cpu")
    params = ttrain.place_params(mesh, cfg, bundle.init_params(0))
    opt = AdamW(AdamWConfig(moment_dtype=dryrun._moe_moment_dtype(cfg))).init(params)
    batch = ttrain.place_batch(mesh, _batch(cfg, bundle.input_specs(cell)))
    held = opt["step"].nbytes + sum(t.local(0).nbytes for t in batch.values())
    for tree in (params, opt["m"], opt["v"]):
        held += sum(t.local(0).nbytes for t in tree_tensors(tree))
    assert dryrun.argument_bytes(cfg, cell, mesh) == held


def test_all_gather_bytes_equal_what_the_mesh_step_gathers(monkeypatch):
    """What the dry run reckons device (0, M - 1) receives, by kind, is what
    one ``MeshStep`` on a (2, 2) mesh of logical CPU shards moves into
    position (0, 1): the collectives' bytes into it (the FSDP gathers and
    their backward, the split program's activations, the gradient sums of
    its blocks), and its group's batch rows, copied to it from (0, 0)."""
    _, cfg = smoke_pair("llama3.2-3b")
    cell = ShapeCell("train", 32, 4, "train")
    mesh = make_host_mesh(2, 2, devices=["cpu"] * 4)
    _, r = dryrun.reckon_lm(cfg, cell, mesh)
    rows = []
    real = tsplit.Split.whole

    def spy(self, t):
        if self.group == 0:
            rows.append(t.nbytes)
        return real(self, t)

    monkeypatch.setattr(tsplit.Split, "whole", spy)
    bundle = tbuild(cfg, device="cpu")
    params = ttrain.place_params(mesh, cfg, bundle.init_params(0))
    opt = AdamW(AdamWConfig())
    batch = ttrain.place_batch(mesh, _batch(cfg, bundle.input_specs(cell)))
    with recording() as rec:
        ttrain.make_train_step(bundle, opt, mesh)(params, opt.init(params), None, batch)
    got = {kind: n for (key, kind), n in rec.items() if key == (0, 1)}
    got["all-gather"] += sum(rows)
    assert sum(rows) > 0
    assert r["transfer"] == got
    assert set(got) == {"all-gather", "reduce-scatter", "all-reduce", "all-to-all"}


# -- cells: the grid, the skip rule, the command line, X-TIME ---------------------------------


# the CPU test grid: the four shape cells, sequences cut (decode reads a
# cache, so its length costs the trace nothing)
GRID = {"train_4k": 128, "prefill_32k": 256, "decode_32k": 32768, "long_500k": 524288}


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_smoke_grid_runs_every_cell(arch, monkeypatch, tmp_path):
    monkeypatch.setattr(dryrun, "get_config", lambda a: smoke_pair(a)[1])
    monkeypatch.setattr(dryrun, "SHAPES", {
        k: dataclasses.replace(c, seq_len=GRID[k]) for k, c in SHAPES.items()})
    cfg = smoke_pair(arch)[1]
    for shape in SHAPES:
        res = dryrun.run_cell(arch, shape, shape == "decode_32k", str(tmp_path))
        want = "skip" if shape == "long_500k" and not cfg.supports_long_context else "ok"
        assert res["status"] == want, (shape, res.get("error"))
        mesh_name = "multi" if shape == "decode_32k" else "single"
        on_disk = json.loads((tmp_path / f"{arch}__{shape}__{mesh_name}.json").read_text())
        assert on_disk["status"] == want
        if want == "ok":
            assert res["memory"]["argument_bytes"] > 0 and res["counted"]["dot_flops_per_dev"] > 0
            assert res["cost_analysis_raw"] is None and res["memory"]["code_bytes"] is None
            assert res["roofline"]["bound_s"] == max(
                res["roofline"][k] for k in ("compute_s", "memory_s", "collective_s"))
            kinds = {"all-gather"}
            split = cfg.family in ttrain.SPLIT_FAMILIES
            decode = shape in ("decode_32k", "long_500k")
            if cfg.family in ("hybrid", "ssm"):  # heads regrouped (all-to-all) besides;
                # reduce-scatters of row-parallel partials over the sequence and of the
                # hybrid's attention merge, all-reduces of the hybrid's norm sums and of
                # the decode's partials
                kinds |= {"all-to-all"}
                kinds |= {"reduce-scatter"} if not decode or cfg.family == "hybrid" else set()
                kinds |= {"all-reduce"} if shape != "prefill_32k" or cfg.family == "hybrid" \
                    else set()
            elif shape == "train_4k":  # the split program's own collectives besides
                kinds |= ({"reduce-scatter", "all-reduce", "all-to-all"}
                          if split else {"reduce-scatter"})
            elif split and shape == "prefill_32k":  # MLA's v all-reduced
                kinds |= {"reduce-scatter", "all-to-all"} | ({"all-reduce"} if cfg.use_mla
                                                              else set())
            elif split:  # the decode merge's and the row-parallel sums
                kinds |= {"reduce-scatter", "all-reduce"}
            assert set(res["counted"]["collective_breakdown"]) == kinds
            assert (res["n_compute_devices"] == res["n_devices"]) == split


@pytest.mark.parametrize("arch,shape", [("zamba2-2.7b", "decode_32k"), ("rwkv6-1.6b", "train_4k")])
def test_recurrent_cells_trace_the_split_program(arch, shape, monkeypatch, tmp_path):
    """A zamba2 decode cell and an rwkv6 train cell (smoke configs, the
    grid's lengths) on the 16 x 16 mesh trace device (0, 15) of the split
    program: every device computes (``n_compute_devices`` 256 where the
    gathered program has 16), with the same argument bytes, fewer dot FLOPs
    and fewer gathered bytes than the gathered program's compute device
    (its whole parameters)."""
    _check_split_against_gathered(arch, shape, monkeypatch, tmp_path)


def _check_split_against_gathered(arch, shape, monkeypatch, tmp_path):
    monkeypatch.setattr(dryrun, "get_config", lambda a: smoke_pair(a)[1])
    monkeypatch.setattr(dryrun, "SHAPES", {
        k: dataclasses.replace(c, seq_len=GRID[k]) for k, c in SHAPES.items()})
    split = dryrun.run_cell(arch, shape, False, str(tmp_path / "split"))
    monkeypatch.setattr(dryrun, "SPLIT_FAMILIES", ("dense", "moe", "vlm"))
    gathered = dryrun.run_cell(arch, shape, False, str(tmp_path / "gathered"))
    assert split["status"] == gathered["status"] == "ok", (split.get("error"),
                                                          gathered.get("error"))
    assert (split["n_compute_devices"], gathered["n_compute_devices"]) == (256, 16)
    assert split["memory"]["argument_bytes"] == gathered["memory"]["argument_bytes"]
    assert split["memory"]["gathered_bytes"] < gathered["memory"]["gathered_bytes"]
    assert 0 < split["counted"]["dot_flops_per_dev"] < gathered["counted"]["dot_flops_per_dev"]


@pytest.mark.parametrize("shape", ["decode_32k", "train_4k"])
def test_whisper_cells_trace_the_split_program(shape, monkeypatch, tmp_path):
    """whisper-tiny's decode and train cells (the smoke config, the grid's
    lengths) on the 16 x 16 mesh trace device (0, 15) of the split program
    (its encoder over the frames and decoder over the tokens, the self and
    cross caches in ``cache_pspecs``'s layout): 256 compute devices where
    the gathered program has 16, the same argument bytes, fewer dot FLOPs
    and fewer gathered bytes than the gathered program's compute device."""
    _check_split_against_gathered("whisper-tiny", shape, monkeypatch, tmp_path)


def test_long_500k_is_skipped_on_a_full_attention_arch(tmp_path):
    res = dryrun.run_cell("llama3.2-3b", "long_500k", False, str(tmp_path))
    assert res["status"] == "skip"
    assert res["reason"] == ("llama3.2-3b is pure full-attention; long_500k skipped per "
                             "assignment rule (see DESIGN.md §Arch-applicability)")


def test_command_line_prints_the_reference_three_lines(tmp_path, capsys, monkeypatch):
    """``main`` (``python -m repro_torch.launch.dryrun``) prints the brief,
    ``memory_analysis:`` and ``roofline:`` and sets no environment
    variable (torch's own compile machinery names its cache directory in
    TORCHINDUCTOR_CACHE_DIR when a meta kernel first asks for it: set
    here beforehand)."""
    monkeypatch.setenv("TORCHINDUCTOR_CACHE_DIR",
                       os.environ.get("TORCHINDUCTOR_CACHE_DIR", str(tmp_path / "inductor")))
    before = dict(os.environ)
    dryrun.main(["--arch", "whisper-tiny", "--shape", "decode_32k", "--out-dir", str(tmp_path)])
    assert dict(os.environ) == before
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    brief = json.loads(lines[0])
    assert brief["status"] == "ok" and brief["mesh"] == "16x16"
    assert lines[1].startswith("memory_analysis: ") and lines[2].startswith("roofline: ")
    res = json.loads((tmp_path / "whisper-tiny__decode_32k__single.json").read_text())
    assert json.loads(lines[1].split(": ", 1)[1]) == res["memory"]
    assert json.loads(lines[2].split(": ", 1)[1]) == res["roofline"]
    assert res["memory"]["fits_h100_80gib"] is True


@pytest.mark.parametrize("multi_pod", [False, True])
def test_xtime_cell_closed_forms(multi_pod):
    cost, meta = dryrun.lower_cell("xtime-tabular", "serve_32k", multi_pod)
    cfg = dryrun.get_config("xtime-tabular")
    batch, rows, f_pad, c_pad = 32768, cfg.n_trees * cfg.max_leaves, 256, 8
    n_b, n_m = (32 if multi_pod else 16), 16
    assert meta["model_flops_total"] == 2.0 * batch * rows * c_pad
    assert meta["compare_ops_total"] == 2.0 * batch * rows * cfg.n_features
    assert cost.dot_flops == 2.0 * (batch // n_b) * (rows // n_m) * c_pad
    assert meta["memory"]["argument_bytes"] == (batch // n_b) * f_pad + 2 * (rows // n_m) * f_pad \
        + (rows // n_m) * c_pad * 2
    assert meta["transfer"] == {"reduce": float((n_m - 1) * (batch // n_b) * c_pad * 4)}
    res = dryrun.result_of(cost, meta)
    assert res["roofline"]["model_flops_ratio"] == pytest.approx(1.0)


# -- the MoE counts' repair -----------------------------------------------------------------


def test_expert_counts_equal_bincount():
    rng = np.random.default_rng(5)
    for shape, e in (((64, 2), 8), ((5, 3), 16), ((1, 1), 4), ((0, 2), 6)):
        idx = torch.as_tensor(rng.integers(0, max(1, e // 2), shape))  # ties, empty experts
        want = torch.bincount(idx.reshape(-1), minlength=e)
        got = tmoe.expert_counts(idx, e)
        assert got.dtype == want.dtype and torch.equal(got, want)
    meta = tmoe.expert_counts(torch.empty((7, 2), dtype=torch.int64, device=META), 9)
    assert meta.shape == (9,) and meta.device == META


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "arctic-480b"])
def test_moe_smoke_configs_trace_loss_and_backward_on_meta(arch):
    _, cfg = smoke_pair(arch)
    bundle = tbuild(cfg, device="meta")
    params = bundle.model.empty_params(device=META)
    batch = bundle.input_specs(ShapeCell("train", 64, 2, "train"))
    with OpCounter() as c:
        loss, _, grads = ttrain.loss_and_grads(bundle, params, batch)
    assert loss.device == META and c.cost().dot_flops > 0
    # and the mesh step's routing pass, whose counts ran bincount too
    cost, _ = dryrun.reckon_lm(cfg, ShapeCell("train", 64, 4, "train"),
                               make_host_mesh(2, 1, devices=["cpu"] * 2))
    assert cost.dot_flops > 0


def test_shardmap_env_selects_the_all_to_all_moe(monkeypatch):
    """REPRO_MOE_IMPL=shardmap traces a transformer prefill cell on the
    gathered forward (without it: the split program), its MoE layers
    through ``make_shardmap_moe`` over one group's `model` devices (the
    same expert products as the plain gathered forward here, as no token
    drops, in more ops); the hooks are restored after the trace."""
    _, cfg = smoke_pair("deepseek-v3-671b")
    cell = ShapeCell("prefill", 64, 4, "prefill")
    mesh = make_host_mesh(2, 2, devices=["cpu"] * 4)
    _, split = dryrun.reckon_lm(cfg, cell, mesh)
    assert split["n_compute"] == 4  # without it, the split program
    bundle = tbuild(cfg, 1024, device="meta")  # the gathered forward of a group's rows
    with torch.inference_mode():
        _, plain = count(bundle.prefill, bundle.model.empty_params(device=META),
                         bundle.input_specs(ShapeCell("prefill", 64, 2, "prefill")))
    calls = []
    real = tmoe_shardmap.ShardMapMoE.__call__
    monkeypatch.setattr(tmoe_shardmap.ShardMapMoE, "__call__",
                        lambda self, *a, **kw: calls.append(self.n_model) or real(self, *a, **kw))
    monkeypatch.setenv("REPRO_MOE_IMPL", "shardmap")
    cost, r = dryrun.reckon_lm(cfg, cell, mesh)
    assert calls and set(calls) == {2} and r["n_compute"] == 2
    assert cost.dot_flops == plain.dot_flops and cost.n_ops > plain.n_ops
    assert tmoe._HOOKS["impl"] is None


# -- the engine's dry-run hooks ---------------------------------------------------------------


MESHES = [((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]
NOCS = ("accumulate", "batch", "hybrid")

_JAX_SPECS = r"""
import json
import numpy as np
import jax
from jax.sharding import Mesh
import repro.api as japi
from repro.core.trees import random_deep_ensemble

cm = japi.build(random_deep_ensemble(n_trees=16, depth=4, n_features=20, n_bins=256,
                                     task="multiclass", n_classes=3, seed=4))
out = {}
for shape, axes in %s:
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), axes)
    for noc in %s:
        eng = cm.engine(mesh=mesh, noc_config=noc)
        _, ins, o = eng.serve_step_for_dryrun()
        spec = lambda s: [list(a) if isinstance(a, tuple) else a for a in tuple(s.spec)]
        out[f"{len(shape)}/{noc}"] = {"in": [spec(s) for s in ins], "out": spec(o),
                                      "input": [list(eng.input_specs(256).shape),
                                                str(eng.input_specs(256).dtype)]}
print(json.dumps(out))
""" % (MESHES, NOCS)


def _spec(s) -> list:
    return [list(a) if isinstance(a, tuple) else a for a in tuple(s)]


@pytest.fixture(scope="module")
def hook_model():
    return build(random_deep_ensemble(n_trees=16, depth=4, n_features=20, n_bins=256,
                                      task="multiclass", n_classes=3, seed=4))


def test_engine_hook_specs_equal_the_reference(hook_model):
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["PYTHONPATH"] = str(SRC)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, "-c", _JAX_SPECS], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    want = json.loads(out.stdout.strip().splitlines()[-1])
    for shape, axes in MESHES:
        mesh = Mesh(np.array(["cpu"] * 8, dtype=object).reshape(shape), axes)
        for noc in NOCS:
            eng = hook_model.engine(mesh=mesh, noc_config=noc)
            _, ins, o = eng.serve_step_for_dryrun()
            w = want[f"{len(shape)}/{noc}"]
            assert [_spec(s) for s in ins] == w["in"] and _spec(o) == w["out"], (shape, noc)
            q = eng.input_specs(256)
            assert [list(q.shape), str(q.dtype).replace("torch.", "")] == w["input"]
            assert q.device == META


@pytest.mark.parametrize("noc", NOCS)
def test_engine_hook_fn_equals_raw_margin(hook_model, noc):
    mesh = make_host_mesh(2, 4, devices=["cpu"] * 8)
    eng = hook_model.engine(mesh=mesh, noc_config=noc)
    fn, _, _ = eng.serve_step_for_dryrun()
    spec = eng.input_specs(256)
    x = np.random.default_rng(9).integers(0, 256, size=(256, 20)).astype(np.int32)
    q = eng._prep_queries(x)
    assert q.shape == spec.shape and q.dtype == spec.dtype
    a = eng.arrays
    got = fn(q, a.low, a.high, a.leaf, a.cells)
    assert torch.equal(got[:256], eng.raw_margin(x))
    with pytest.raises(ValueError, match="engine.arrays"):
        fn(q, a.low.clone(), a.high, a.leaf, a.cells)


def test_engine_hooks_need_a_mesh(hook_model):
    eng = hook_model.engine(device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        eng.serve_step_for_dryrun()

"""The port's import boundary and its default device.

(a) importing every ``repro_torch`` module, ``chip_smoke.py`` or the
``examples/torch_*.py`` loads no ``jax`` and nothing of ``repro``; (h)
entry points called without ``device`` — the command lines,
``autotune_kernel`` and the LM half's ``build_model``/``init_params``,
``lm_params_from_numpy``, ``launch.serve``, the training mesh and the
serving example too — run on the card, so with no card they raise
instead of falling back to the CPU.
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
                 "repro_torch.core.defects", "repro_torch.core.baselines",
                 "repro_torch.core.tune", "repro_torch.ft.runtime",
                 "repro_torch.serve.batching", "repro_torch.serve.registry",
                 "repro_torch.serve.traffic", "repro_torch.serve.loop",
                 "repro_torch.serve.cluster", "repro_torch.score.reader",
                 "repro_torch.score.writer", "repro_torch.score.pipeline",
                 "repro_torch.ingest", "repro_torch.ingest.ir",
                 "repro_torch.ingest.xgboost_json", "repro_torch.ingest.lightgbm_text",
                 "repro_torch.ingest.sklearn_dict", "repro_torch.ingest.lower",
                 "repro_torch.core.compress", "repro_torch.core.trees",
                 "repro_torch.core.perfmodel", "repro_torch.data",
                 "repro_torch.data.tabular", "repro_torch.tools.widths",
                 "repro_torch.tools.compress_time", "repro_torch.cli",
                 "repro_torch.cli._common", "repro_torch.cli.ingest",
                 "repro_torch.cli.score", "repro_torch.launch", "repro_torch.launch.mesh",
                 "repro_torch.checkpoint", "repro_torch.checkpoint.ckpt",
                 "repro_torch.tools.paper_scale_smoke", "repro_torch.tools.cluster_probe",
                 "repro_torch.config",
                 "repro_torch.configs", "repro_torch.configs.arctic_480b",
                 "repro_torch.configs.deepseek_v3", "repro_torch.configs.gemma3_1b",
                 "repro_torch.configs.granite_20b", "repro_torch.configs.llama32_3b",
                 "repro_torch.configs.llava_next_mistral", "repro_torch.configs.phi3_mini",
                 "repro_torch.configs.rwkv6_1p6b", "repro_torch.configs.whisper_tiny",
                 "repro_torch.configs.xtime_tabular", "repro_torch.configs.zamba2_2p7b",
                 "repro_torch.models", "repro_torch.models.common", "repro_torch.models.ffn",
                 "repro_torch.models.attention", "repro_torch.models.moe",
                 "repro_torch.models.mla", "repro_torch.models.transformer",
                 "repro_torch.models.registry", "repro_torch.models.mamba2",
                 "repro_torch.models.hybrid", "repro_torch.models.rwkv6",
                 "repro_torch.models.rwkv_model", "repro_torch.models.encdec",
                 "repro_torch.launch.model_flops", "repro_torch.launch.serve",
                 "repro_torch.launch.train", "repro_torch.data.tokens",
                 "repro_torch.optim", "repro_torch.optim.adamw",
                 "repro_torch.optim.compress", "repro_torch.sharding",
                 "repro_torch.sharding.partition", "repro_torch.sharding.placement",
                 "repro_torch.sharding.collectives", "repro_torch.sharding.split",
                 "repro_torch.models.decode_opt", "repro_torch.models.moe_shardmap",
                 "repro_torch.launch.dryrun", "repro_torch.launch.hlo_analysis",
                 "repro_torch.launch.op_count"):
        assert want in mods


EXAMPLES = ("torch_quickstart", "torch_ingest_quickstart", "torch_xtime_serving",
            "torch_xtime_cluster", "torch_xtime_multichip", "torch_train_lm",
            "torch_elastic_restart", "torch_serve_lm")


def _exec_file(path: Path) -> str:
    """Interpreter lines that import ``path`` as a module (its ``__main__``
    guard keeps it from running)."""
    return (
        "import importlib.util\n"
        f"spec = importlib.util.spec_from_file_location({path.stem!r}, {str(path)!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
    )


@pytest.mark.parametrize("entry", ["package", "chip_smoke", "examples"])
def test_no_jax_and_no_repro_loaded(entry):
    """A fresh interpreter imports every port module (or chip_smoke.py, or
    the port's examples) and then holds no ``jax*`` and no
    ``repro``/``repro.*`` module — the ``repro_torch`` prefix is not
    ``repro``."""
    if entry == "package":
        body = "\n".join(f"import {m}" for m in _all_modules())
    elif entry == "chip_smoke":
        body = _exec_file(ROOT / "chip_smoke.py")
    else:
        body = "".join(_exec_file(ROOT / "examples" / f"{name}.py") for name in EXAMPLES)
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
    from repro_torch.config import get_config
    from repro_torch.configs import llama32_3b
    from repro_torch.convert import lm_params_from_numpy, seeded_numpy_params
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import build_model
    from repro_torch.serve import ClusterServer, TableRegistry
    from repro_torch.tools import paper_scale_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ens, cm = _small_model()
    x = np.zeros((3, 5), dtype=np.uint8)
    lm = llama32_3b.smoke()
    for call in (lambda: cm.predict(x), lambda: cm.raw_margin(x),
                 lambda: cm.engine(), lambda: XTimeEngine(cm.table),
                 lambda: TableRegistry(), lambda: ClusterServer(n_replicas=1),
                 lambda: repro_torch.score_file(cm, x),
                 lambda: repro_torch.TraversalBaseline(ens), lambda: make_host_mesh(),
                 lambda: paper_scale_smoke.main([]),
                 lambda: build_model(get_config("llama3.2-3b")).init_params(0),
                 lambda: lm_params_from_numpy(lm, seeded_numpy_params(lm, 0)),
                 lambda: serve.main(["--batch", "1", "--prompt-len", "4", "--max-new", "2"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    # the CPU is used only when asked for
    np.testing.assert_array_equal(cm.predict(x, device="cpu"), ens.predict(x))
    assert build_model(lm, device="cpu").init_params(0).embed.device.type == "cpu"


@pytest.mark.parametrize("module", ["zamba2_2p7b", "rwkv6_1p6b", "whisper_tiny"])
def test_new_lm_families_default_to_the_card(monkeypatch, module):
    """zamba2, rwkv6 and whisper build on the card unless asked for the
    CPU: with no card, ``build_model`` and ``lm_params_from_numpy`` raise."""
    import importlib

    from repro_torch.convert import lm_params_from_numpy, seeded_numpy_params
    from repro_torch.models import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    configs = importlib.import_module(f"repro_torch.configs.{module}")
    cfg = configs.smoke()
    for call in (lambda: build_model(configs.CONFIG),
                 lambda: build_model(cfg).init_params(0),
                 lambda: lm_params_from_numpy(cfg, seeded_numpy_params(cfg, 0))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert build_model(cfg, device="cpu").init_params(0).embed.device.type == "cpu"


def test_lm_training_defaults_to_the_card(monkeypatch, tmp_path):
    """``train``, its command line and the two training examples bind the
    card without ``device``; with no card they raise before any step and
    write nothing."""
    import importlib.util

    from repro_torch.configs import llama32_3b
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = llama32_3b.smoke().replace(dtype="float32")
    examples = []
    for name in ("torch_train_lm", "torch_elastic_restart"):
        spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        examples.append(mod)
    for call in (lambda: train.train(cfg, steps=2, global_batch=2, seq_len=16,
                                     run_dir=str(tmp_path / "a")),
                 lambda: train.main(["--arch", "llama3.2-3b", "--scale", "0.05", "--steps",
                                     "1", "--run-dir", str(tmp_path / "b")]),
                 lambda: examples[0].main(["--steps", "1", "--run-dir", str(tmp_path / "c")]),
                 lambda: examples[1].main([])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not list(tmp_path.iterdir())


def test_serve_example_and_the_mesh_command_line_default_to_the_card(monkeypatch, tmp_path):
    """``examples/torch_serve_lm.py`` serves and passes its greedy check on
    the CPU when asked; without ``--device`` it, and ``--use-mesh``
    without ``--device``, raise with no card, writing nothing."""
    import importlib.util

    from repro_torch.launch import train

    spec = importlib.util.spec_from_file_location(
        "torch_serve_lm", ROOT / "examples" / "torch_serve_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.main(["--device", "cpu"]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: mod.main([]),
                 lambda: train.main(["--arch", "llama3.2-3b", "--scale", "0.05", "--steps",
                                     "1", "--use-mesh", "--run-dir", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not list(tmp_path.iterdir())


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


def test_cli_and_autotune_default_to_the_card(monkeypatch, tmp_path):
    """The command lines' ``--expected``/``--autotune`` and
    ``autotune_kernel`` without a device bind CUDA, and with no card they
    raise; ingesting alone uses no device."""
    from repro_torch.cli import ingest, score
    from repro_torch.core.tune import autotune_kernel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cm = _small_model()
    dump = ROOT / "tests" / "fixtures" / "ingest" / "xgb_deep.json"
    golden = dump.parent / "xgb_deep.expected.json"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        autotune_kernel(cm, batch=4, b_blks=(4,), r_blks=(8,))
    for argv in ([str(dump), "--out", str(tmp_path / "a"), "--expected", str(golden)],
                 [str(dump), "--out", str(tmp_path / "b"), "--autotune", "1,4"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ingest.main(argv)
    assert ingest.main([str(dump), "--out", str(tmp_path / "c")]) == 0  # no device used
    for extra in ([], ["--expected", str(golden)]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            score.main([str(tmp_path / "c"), str(ROOT / "tests" / "fixtures" / "score" /
                                                 "xgb_deep_x.npy"), *extra])
    # the CPU only when asked for
    assert autotune_kernel(cm, device="cpu", batch=4, b_blks=(4,), r_blks=(8,),
                           iters=1).env["platform"] == "cpu"

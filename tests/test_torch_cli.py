"""The port's command lines and tabular examples, on the CPU, against the
JAX package's ``scripts/`` commands.

For each golden dump the port's ``ingest`` passes ``--expected`` and writes
the ``.npz`` and ``.json`` of ``scripts/ingest.py`` byte for byte; the
``score`` command's ``--out`` equals ``scripts/score.py``'s; the subprocess
round trip ingest -> score ``--expected`` mirrors
``tests/test_score.py::test_score_cli_expected_round_trip``; ``--autotune``
saves a plan ``tune_plan()`` reads back; the quick examples run to exit 0.
Also the parity gaps ``precision.macro_cell_count`` and
``compile.padded_table``.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.api as japi
import repro.core.compile as jcompile
import repro.core.precision as jprecision
import repro_torch
from repro.core.trees import random_deep_ensemble as j_random_deep_ensemble
from repro_torch.cli import _common, ingest, score
from repro_torch.core import compile as tcompile
from repro_torch.core import precision as tprecision

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"
FIXTURES = ROOT / "tests" / "fixtures"
GOLDENS = sorted(p.name for p in (FIXTURES / "ingest").iterdir()
                 if p.suffix in (".json", ".txt") and ".expected" not in p.name)


def _script(name: str):
    """Load one of the JAX package's ``scripts/`` commands as a module."""
    spec = importlib.util.spec_from_file_location(f"xtime_script_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _env() -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), env.get("PYTHONPATH", "")])
    return env


def test_goldens_listed():
    assert len(GOLDENS) == 8


@pytest.mark.parametrize("dump", GOLDENS)
def test_ingest_passes_expected_and_writes_the_jax_bytes(dump, tmp_path, capsys):
    src = FIXTURES / "ingest" / dump
    expected = src.parent / (src.name.rsplit(".", 1)[0] + ".expected.json")
    args = [str(src), "--expected", str(expected)]
    assert ingest.main([*args, "--out", str(tmp_path / "t"), "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    assert _script("ingest").main([*args, "--out", str(tmp_path / "j")]) == 0
    jax_out = capsys.readouterr().out
    for suffix in (".npz", ".json"):
        assert (tmp_path / f"t{suffix}").read_bytes() == (tmp_path / f"j{suffix}").read_bytes()
    # the same lines, the saved path aside
    assert port_out.replace(str(tmp_path / "t"), "BASE") == jax_out.replace(
        str(tmp_path / "j"), "BASE")
    assert "[verify]  OK" in port_out


def test_ingest_score_round_trip_in_subprocesses(tmp_path):
    """ingest -> score --expected --chunk-rows 10 --device cpu, as
    ``python -m`` commands."""
    ing = subprocess.run(
        [sys.executable, "-m", "repro_torch.cli.ingest",
         str(FIXTURES / "ingest" / "xgb_deep.json"), "--out", str(tmp_path / "art")],
        capture_output=True, text=True, env=_env(), timeout=300,
    )
    assert ing.returncode == 0, ing.stderr
    sc = subprocess.run(
        [sys.executable, "-m", "repro_torch.cli.score", str(tmp_path / "art"),
         str(FIXTURES / "score" / "xgb_deep_x.npy"),
         "--expected", str(FIXTURES / "ingest" / "xgb_deep.expected.json"),
         "--chunk-rows", "10", "--device", "cpu"],
        capture_output=True, text=True, env=_env(), timeout=300,
    )
    assert sc.returncode == 0, sc.stdout + sc.stderr
    assert "[verify]  OK" in sc.stdout and "streamed" in sc.stdout


@pytest.mark.parametrize("kind", ["predict", "margin"])
def test_score_out_equals_the_jax_command(kind, tmp_path, capsys):
    art = tmp_path / "art"
    assert _script("ingest").main([str(FIXTURES / "ingest" / "xgb_multi.json"),
                                   "--out", str(art)]) == 0
    x = np.random.default_rng(3).normal(size=(300, 5)) * 2.0
    rows = tmp_path / "rows.npy"
    np.save(rows, x)
    common = [str(art), str(rows), "--kind", kind, "--chunk-rows", "64"]
    assert score.main([*common, "--out", str(tmp_path / "t.npy"), "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    assert _script("score").main([*common, "--out", str(tmp_path / "j.npy")]) == 0
    jax_out = capsys.readouterr().out
    got, want = np.load(tmp_path / "t.npy"), np.load(tmp_path / "j.npy")
    assert got.dtype == want.dtype and got.shape == want.shape
    if kind == "predict":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    for tag in ("[score]", "[engine]"):
        line = [ln for ln in port_out.splitlines() if ln.startswith(tag)]
        assert line == [ln for ln in jax_out.splitlines() if ln.startswith(tag)]


def test_missing_artifact_gives_the_jax_message(tmp_path):
    jcli = _script("_cli")
    with pytest.raises(SystemExit) as port:
        _common.load_artifact(tmp_path / "nothing")
    with pytest.raises(SystemExit) as jax:
        jcli.load_artifact(tmp_path / "nothing")
    assert str(port.value) == str(jax.value) and "[load]    ERROR" in str(port.value)
    with pytest.raises(SystemExit) as cli:
        score.main([str(tmp_path / "nothing"), "rows.npy", "--device", "cpu"])
    assert str(cli.value) == str(jax.value)


def test_autotune_flag_saves_a_plan(tmp_path, capsys):
    out = tmp_path / "tuned"
    assert ingest.main([str(FIXTURES / "ingest" / "xgb_binary.json"), "--out", str(out),
                        "--device", "cpu", "--autotune", "1,64"]) == 0
    assert "[tune]" in capsys.readouterr().out
    cm = repro_torch.CompiledModel.load(out)
    plan = cm.tune_plan()
    assert plan.batch == 1 and [e["batch"] for e in plan.dispatch] == [1, 64]
    assert plan.timed_on("cpu") and not plan.timed_on("cuda")
    assert cm.deploy.table_dtype == plan.table_dtype and cm.deploy.b_blk == plan.b_blk
    with pytest.raises(SystemExit):
        ingest.main([str(FIXTURES / "ingest" / "xgb_binary.json"), "--out", str(out),
                     "--autotune", "0,8"])


@pytest.mark.parametrize("example", ["torch_quickstart", "torch_ingest_quickstart"])
def test_quick_examples_run_on_the_cpu(example):
    r = subprocess.run([sys.executable, str(ROOT / "examples" / f"{example}.py"),
                        "--device", "cpu"],
                       capture_output=True, text=True, env=_env(), timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "True (cpu)" in r.stdout or "identical to the native model (cpu)" in r.stdout


# -- parity gaps -------------------------------------------------------------


@pytest.mark.parametrize("n_bits", range(1, 17))
def test_macro_cell_count_equals_the_jax_package(n_bits):
    for n_features in (1, 7, 130):
        try:
            want = jprecision.macro_cell_count(n_features, n_bits)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                tprecision.macro_cell_count(n_features, n_bits)
        else:
            assert tprecision.macro_cell_count(n_features, n_bits) == want
    assert tprecision.macro_cell_count(5) == jprecision.macro_cell_count(5) == 10


@pytest.mark.parametrize("row_multiple", [1, 64, 256, 1000])
def test_padded_table_byte_equal(row_multiple, tmp_path):
    ens = j_random_deep_ensemble(n_trees=5, depth=5, n_features=9, n_bins=64,
                                 task="multiclass", n_classes=3, seed=2)
    jt = jcompile.compile_ensemble(ens)
    japi.build(jt).save(tmp_path / "t")
    cm = repro_torch.CompiledModel.load(tmp_path / "t")
    got = tcompile.padded_table(cm.table, row_multiple)
    want = jcompile.padded_table(jt, row_multiple)
    assert got[3] == want[3]
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


"""On the card: each cell runs and comes out correct, and the control fails
each cell's limit at the cell's own size.

    python3 -m pytest -m gpu xbench/test_xbench_gpu.py

Skips where torch sees no CUDA card (decided inside each test).
"""

import json
import subprocess
import sys

import pytest
import torch

from xbench import harness

CELLS = [w["name"] for w in harness.load_benchmark()["workloads"]]
# rows a run of each cell checks (PERF.md): the control reads as many
CONTROL_ROWS = {"f130.bulk": 10752, "f968.bulk": 4608, "f130.loop": 65536}


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cell):
    need_card()
    out = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload", cell,
                          "--seed", "3141592653", "--seconds", "3", "--trace", "0"],
                         capture_output=True, text=True, timeout=900, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size(cell):
    need_card()
    from xbench.control import control_gap

    spec = harness.load_cell(cell)
    cfg = harness.load_config(spec["config"])
    for seed in (2718281828, 2718281829, 2718281830):
        assert control_gap(cfg, seed, CONTROL_ROWS.get(cell, 8192), "cuda:0") > \
            3 * spec["limits"]["margin_gap"]

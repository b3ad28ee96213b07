"""Where the cluster route's time goes, measured on the card.

    python3 src/repro_torch/tools/cluster_probe.py [--features 968] [--batches 1,256,1024]

Builds variants of the kernel library from copies of ``kernels/csrc``, each
changing where a cluster member's lookups go (``member_tables`` in
cam_match.cu), and times the hard kernel of each on xtime-tabular's 4,096
trees of depth 8 at ``--features`` features (a cluster of blocks a tile
past 223) in uint8/inclusive and int32/direct, with the L2 cache flushed
before each launch:

  * as built — a cell's lookups from the member holding its feature,
    through distributed shared memory;
  * own window local — from this block's own tables where it holds the
    feature, else as built;
  * own rank — every lookup sent to this block's own rank through
    distributed shared memory (wrong answers; the network left out);
  * own shared memory — every lookup from this block's own tables
    (wrong answers; the distributed path left out);
  * builds only — the cluster's tables built and synced, no walk.

Prints the card, one line per (variant, batch) and the margins' agreement
of the first two with the lane-per-query walk.  Builds under
``build/repro_torch/probe`` in the checkout; needs a card and ``nvcc``;
nothing runs at import.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

HOOK = "  return cg::this_cluster().map_shared_rank(const_cast<uint32_t*>(local), m);\n"
VARIANTS = {
    "as built": HOOK,
    "own window local": ("  uint32_t* p = const_cast<uint32_t*>(local);\n"
                         "  return m == int(cg::this_cluster().block_rank()) ? p\n"
                         "      : cg::this_cluster().map_shared_rank(p, m);\n"),
    "own rank": ("  return cg::this_cluster().map_shared_rank(const_cast<uint32_t*>(local),\n"
                 "      int(cg::this_cluster().block_rank()));\n"),
    "own shared memory": "  return local;\n",
    "builds only": HOOK,
}
FLUSH_BYTES = 256 << 20  # written before each timed launch: 5x the 50 MB L2


def build_variants(out: Path) -> dict:
    """One shared library a variant, built side by side; name -> path."""
    from repro_torch.kernels import cam_match as K

    out.mkdir(parents=True, exist_ok=True)
    src = (K.CSRC / "cam_match.cu").read_text()
    if src.count(HOOK) != 1:
        raise RuntimeError("cam_match.cu's member_tables is not the one this probe edits")
    for h in (*K.HEADERS, *K.SOURCES[1:]):
        shutil.copy(h, out / h.name)
    procs = {}
    for i, (name, body) in enumerate(VARIANTS.items()):
        text = src.replace(HOOK, body)
        if name == "builds only":  # the cluster instances skip their walk
            text = re.sub(r"(\n\s+)walk_splits\(a, tile", r"\1if (!kCluster) walk_splits(a, tile",
                          text)
        cu, lib = out / f"variant{i}.cu", out / f"variant{i}.so"
        cu.write_text(text)
        cmd = [K._nvcc(), *K.NVCC_FLAGS, "-shared", "-o", str(lib), str(cu),
               *(str(out / s.name) for s in K.SOURCES[1:])]
        procs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                             text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name!r}:\n{log[-4000:]}")
        libs[name] = lib
    return libs


def cold_ms(fn, iters: int) -> float:
    """Mean ms of ``fn()`` launched alone after a write that flushes the L2."""
    import torch

    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    pairs = []
    for i in range(iters):
        scratch.fill_(i & 0xFF)
        torch.cuda._sleep(200_000)  # the host enqueues the launch meanwhile
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def main() -> int:
    # run as a file, sys.path[0] is this directory: put the checkout's src there
    sys.path[0] = str(Path(__file__).resolve().parents[2])
    import numpy as np
    import torch

    import repro_torch
    from repro_torch.core.trees import random_deep_ensemble
    from repro_torch.kernels import cam_match as K

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--features", type=int, default=968)
    ap.add_argument("--batches", default="1,256,1024")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("cluster_probe: torch sees no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    libs = {name: K._bind(ctypes.CDLL(str(p))) for name, p in
            build_variants(K.BUILD_DIR / "probe").items()}
    ens = random_deep_ensemble(n_trees=4096, depth=8, n_features=args.features, n_bins=256,
                               task="multiclass", n_classes=8, seed=60)
    cm = repro_torch.build(ens)
    rng = np.random.default_rng(61)
    for label, overrides in (("uint8/inclusive", {}), ("int32/direct", {"table_dtype": "int32"})):
        eng = cm.engine(**overrides)
        a = eng.arrays
        print(f"{label}: R={a.r_pad}, F_pad={a.f_pad}, span {a.cells.span}, "
              f"{K.kernel_route(a.cells)}", flush=True)
        for b in map(int, args.batches.split(",")):
            qp = eng._prep_queries(rng.integers(0, 256, size=(b, args.features)).astype(np.uint8))

            def call(walk=False):
                return K.cam_match_cuda(qp, a.cells, a.leaf, eng._bias, mode=eng.kernel_mode,
                                        walk=walk)
            times = []
            for name, lib in libs.items():
                K._LIB = lib
                if name in ("as built", "own window local") and not torch.equal(
                        call(), call(walk=True)):
                    raise SystemExit(f"{label} B={b} {name}: margins differ from the walk's")
                times.append(f"{name} {cold_ms(call, 10):.4f}")
            print(f"  {label} B={b} (ms, L2 flushed): " + "; ".join(times), flush=True)
        cm._engines.clear()
        del eng, a
        torch.cuda.empty_cache()
    K._LIB = None
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

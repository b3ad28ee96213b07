"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line (or block) each:
  1. environment: card name and power limit, torch and CUDA versions;
  2. build: nvcc of kernels/csrc/cam_match.cu, its time and ptxas report;
  3. kernel against its plain PyTorch version on the card, for every
     instantiated (table dtype x cell mode), tile mask on and off, bias
     fused and unfused, at b256/r16384/f130/c8 and a ragged small shape;
  4. the main path at the full width of xtime-tabular (4096 trees of depth
     8, 130 features, 256 bins, 8 classes): ``repro_torch.build`` ->
     ``CompiledModel.predict``/``raw_margin`` at batch 1, 37, 256 and 1024,
     held to the host traversal and to the plain version, then
     save -> load -> predict;
  5. times with CUDA events at full width, beside the least time the card
     could take: the main path's uint8/inclusive kernel at batch 256, 1
     and 1024 (tile mask and fused bias on and off), and the uint16 and
     int32 instantiations at batch 256, each beside its plain version.

Every check that fails stops the run with a non-zero exit.  The last two
lines are a JSON object of the kernels and the contract line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or ``repro``.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import repro_torch  # noqa: E402
from repro_torch.core.engine import XTimeEngine  # noqa: E402
from repro_torch.core.compile import compile_ensemble  # noqa: E402
from repro_torch.core.trees import random_deep_ensemble  # noqa: E402
from repro_torch.kernels import cam_match as K  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense): HBM 3.35 TB/s; 67 TFLOP/s
# float32 outside the tensor cores counts an FMA as two operations, i.e.
# 33.5 T lane-instructions/s — the rate of a 32-bit compare, AND or add.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
F32_EPS = 2.0 ** -24  # unit roundoff of float32


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


_TYPES = {"h": "uint8", "t": "uint16", "i": "int32"}


def ptxas_report(log: str) -> list[str]:
    """One line per compiled kernel: registers, shared memory, spills."""
    lines, out = log.splitlines(), []
    for i, ln in enumerate(lines[:-2]):
        m = re.search(r"Function properties for (\S+)", ln)
        if not m:
            continue
        k = re.search(r"cam_match_kernelI([hti])NS_\d+(\w+?)EEEv", m.group(1))
        name = f"cam_match<{_TYPES[k.group(1)]}, {k.group(2)}>" if k else "reduce_splits"
        used = lines[i + 2].split(":", 1)[-1].strip()
        out.append(f"{name}: {used}; {lines[i + 1].strip()}")
    return out


def sync_time(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` runs, CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- phase 3: kernel against the plain version -------------------------------


def tree_problem(rng, dev):
    """b256/r16384/f130/c8 from a compiled 64-tree depth-8 ensemble: every
    query matches exactly one row per tree (k/16 leaves)."""
    ens = random_deep_ensemble(n_trees=64, depth=8, n_features=130, n_bins=256,
                               task="multiclass", n_classes=8, seed=SEED + 1)
    t = compile_ensemble(ens)
    q = rng.integers(0, 256, size=(256, 130))
    return dict(name="b256/r16384/f130/c8", low=t.low, high=t.high,
                leaf=t.leaf_matrix(), q=q, n_bins=256, r_blk=256, f_blk=128)


def ragged_problem(rng, dev):
    """b37/r300/f11/c3 on a 200-bin grid (uint8 holds exclusive bounds),
    70% wildcard cells: rows match many queries, padding on every axis."""
    r, f, n_bins = 300, 11, 200
    low = rng.integers(0, n_bins, size=(r, f)).astype(np.int32)
    high = np.minimum(low + rng.integers(1, n_bins, size=(r, f)), n_bins).astype(np.int32)
    dc = rng.random((r, f)) < 0.7
    low[dc], high[dc] = 0, n_bins
    leaf = (rng.integers(-16, 17, size=(r, 3)) / 16.0).astype(np.float32)
    q = rng.integers(0, n_bins, size=(37, f))
    return dict(name="b37/r300/f11/c3", low=low, high=high, leaf=leaf, q=q,
                n_bins=n_bins, r_blk=32, f_blk=16)


# (table dtype, mode, inclusive encoding): every instantiation of the kernel
VARIANTS = [
    ("int32", "direct", False), ("int32", "inclusive", True),
    ("int32", "msb_lsb", False), ("int32", "two_cycle", False),
    ("uint8", "inclusive", True), ("uint16", "inclusive", True),
    ("uint8", "direct", False), ("uint16", "direct", False),
]


def operands(p, dtype, inclusive, leaf, dev):
    if inclusive:
        lo, hi, lm, _ = ops.pack_tables(p["low"], p["high"], leaf, r_blk=p["r_blk"],
                                        f_blk=p["f_blk"], n_bins=p["n_bins"],
                                        dtype=dtype, inclusive=True)
    else:  # exclusive-high: unsigned dtypes hold it only below 256 bins
        lo, hi, lm = ops.pad_tables(p["low"], p["high"], leaf, r_blk=p["r_blk"],
                                    f_blk=p["f_blk"], n_bins=p["n_bins"])
        if dtype != "int32" and p["n_bins"] > np.iinfo(dtype).max:
            return None
        lo, hi = lo.astype(dtype), hi.astype(dtype)
    mask = ops.wildcard_tile_mask(lo, hi, r_blk=p["r_blk"], f_blk=p["f_blk"],
                                  n_bins=p["n_bins"], inclusive=inclusive)
    q = ops.pad_queries(p["q"], lo.shape[1], dtype=dtype, device=dev)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return q, to(lo), to(hi), to(lm), to(mask)


def summation_bound(bits: torch.Tensor, leaf: torch.Tensor, extra: int) -> torch.Tensor:
    """|kernel - plain| limit for two float32 sums of the same terms in
    different orders: each is within (n-1)·u·Σ|term| of the exact sum, n
    the number of nonzero terms (+ ``extra`` partial-sum merges)."""
    absum = bits.double() @ leaf.abs().double()
    n = bits.sum(dim=1, keepdim=True).double() + extra
    return 2.0 * n * F32_EPS * absum


def phase_kernel(dev, stats) -> None:
    rng = np.random.default_rng(SEED)
    for p in (tree_problem(rng, dev), ragged_problem(rng, dev)):
        normal = rng.normal(size=p["leaf"].shape).astype(np.float32)
        normal[p["leaf"] == 0] = 0.0  # keep the class routing of each row
        int32_out = {}
        for dtype, mode, incl in VARIANTS:
            dyadic = operands(p, dtype, incl, p["leaf"], dev)
            if dyadic is None:
                continue
            q, lo, hi, lm, mask = dyadic
            _, _, _, lm_n, _ = operands(p, dtype, incl, normal, dev)
            kw = dict(r_blk=p["r_blk"], f_blk=p["f_blk"], mode=mode)
            bias = torch.full((1, lm.shape[1]), 0.3125, device=dev)
            bits_ref = ref.cam_match_bits_ref(q, lo, hi, mode=mode)
            out_ref = ref.cam_match_ref(q, lo, hi, lm, mode=mode)
            out_ref_n = ref.cam_match_ref(q, lo, hi, lm_n, mode=mode)
            for m in (mask, None):
                bits = K.cam_match_bits_cuda(q, lo, hi, m, **kw)
                out = K.cam_match_cuda(q, lo, hi, lm, m, **kw)
                again = K.cam_match_cuda(q, lo, hi, lm, m, **kw)
                fused = K.cam_match_cuda(q, lo, hi, lm, m, bias, **kw)
                out_n = K.cam_match_cuda(q, lo, hi, lm_n, m, **kw)
                fused_n = K.cam_match_cuda(q, lo, hi, lm_n, m, bias, **kw)
                torch.cuda.synchronize()
                tag = f"{p['name']} {dtype}/{mode} mask={'on' if m is not None else 'off'}"
                if not torch.equal(bits, bits_ref):
                    fail(f"{tag}: match bits differ from the plain version")
                if not torch.equal(out, out_ref):
                    fail(f"{tag}: k/16 margins differ from the plain version")
                if not torch.equal(out, again):
                    fail(f"{tag}: two runs differ")
                if not (torch.equal(fused, out + bias) and torch.equal(fused_n, out_n + bias)):
                    fail(f"{tag}: fused bias != unfused + bias")
                err = (out_n - out_ref_n).abs()
                lim = summation_bound(bits_ref, lm_n, extra=K.n_splits(lo.shape[0]) + 2)
                if bool((err.double() > lim).any()):
                    fail(f"{tag}: normal-leaf margins off by {float(err.max())} > bound")
                stats["max_abs_err"] = max(stats["max_abs_err"], float(err.max()))
                enc = "incl" if incl else "excl"
                if dtype == "int32":
                    int32_out.setdefault(enc, out_n)
                elif not torch.equal(out_n, int32_out[enc]):
                    fail(f"{tag}: packed {dtype} != int32 {enc} margins")
            print(f"kernel {p['name']} {dtype}/{mode}: bits, k/16 margins, "
                  f"fused bias, mask on/off, rerun exact; normal leaves "
                  f"within 2(n+splits)·u·Σ|leaf| (max |err| so far "
                  f"{stats['max_abs_err']:.3g})", flush=True)


# -- phase 4: the main path at full width -------------------------------------


def phase_main_path(dev, stats):
    t0 = time.perf_counter()
    ens = random_deep_ensemble(n_trees=4096, depth=8, n_features=130, n_bins=256,
                               task="multiclass", n_classes=8, seed=SEED)
    t1 = time.perf_counter()
    cm = repro_torch.build(ens)
    t2 = time.perf_counter()
    print(f"main path: xtime-tabular 4096 trees x depth 8, 130 features, 8 classes "
          f"-> {cm.table.n_rows} CAM rows; ensemble {t1 - t0:.1f} s, build "
          f"{t2 - t1:.1f} s (host)", flush=True)
    rng = np.random.default_rng(SEED + 2)
    batches = {b: rng.integers(0, 256, size=(b, 130)).astype(np.uint8)
               for b in (1, 37, 256, 1024)}
    torch.cuda.reset_peak_memory_stats()
    K.cam_match_cuda.launches = 0  # count only the main path's launches
    margins = {b: cm.raw_margin(x) for b, x in batches.items()}
    preds = {b: cm.predict(x) for b, x in batches.items()}
    torch.cuda.synchronize()
    stats["launches"] = K.cam_match_cuda.launches
    stats["peak_bytes"] = torch.cuda.max_memory_allocated()
    if stats["launches"] == 0:
        fail("the main path never launched the cam_match kernel")
    eng = cm.engine()
    print(f"main path: {stats['launches']} kernel launches over "
          f"{2 * len(batches)} calls; engine {eng.table_dtype}/{eng.kernel_mode}, "
          f"fused bias {eng.fuse_epilogue}", flush=True)

    # host traversal (exact: k/16 leaves) on the first 64 rows of each batch
    for b, x in batches.items():
        head = x[:64]
        if not np.array_equal(margins[b][:64], ens.raw_margin(head)):
            fail(f"batch {b}: margins differ from Ensemble.raw_margin")
        if not np.array_equal(preds[b][:64], ens.predict(head)):
            fail(f"batch {b}: predictions differ from Ensemble.predict")
        if not np.isfinite(margins[b]).all() or margins[b].shape != (b, 8):
            fail(f"batch {b}: margins not finite of shape ({b}, 8)")
    # the plain version on the card, all rows
    a = eng.arrays
    for b, x in batches.items():
        qp = eng._prep_queries(x)
        plain = ref.cam_match_ref(qp, a.low, a.high, a.leaf, mode=eng.kernel_mode)
        plain = (plain + eng._bias)[:, :8].cpu().numpy()  # the separate epilogue
        if not np.array_equal(margins[b], plain):
            fail(f"batch {b}: margins differ from the plain version on the card")
        stats["max_abs_err"] = max(stats["max_abs_err"],
                                   float(np.abs(margins[b] - plain).max()))
    print("main path: margins == Ensemble.raw_margin (64 rows/batch) and == "
          "plain version (all rows), predictions == Ensemble.predict", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cm.save(Path(tmp) / "xtime")
        loaded = repro_torch.CompiledModel.load(Path(tmp) / "xtime")
        t1 = time.perf_counter()
        for b, x in batches.items():
            if not np.array_equal(loaded.predict(x), preds[b]):
                fail(f"batch {b}: predictions differ after save -> load")
    print(f"main path: save -> load -> predict equal at full width "
          f"({t1 - t0:.1f} s host)", flush=True)
    return cm, batches


# -- phase 5: times -----------------------------------------------------------


def bound_ms(eng: XTimeEngine, batch: int, n_matched: int) -> tuple[float, str]:
    """Least time for one cam_match call on this data: bytes of the active
    table tiles, leaves, queries, mask and outputs at HBM rate, against two
    compares per active cell and query plus one add per matched row and
    query at the 32-bit lane rate."""
    a = eng.arrays
    mask = a.tile_mask.cpu().numpy()
    cells = int(mask.sum()) * eng.r_blk * eng.f_blk
    item = np.dtype(eng.table_dtype).itemsize
    nbytes = (2 * cells * item + a.r_pad * a.c_pad * 4 + batch * a.f_pad * item
              + mask.nbytes + batch * a.c_pad * 4)
    n_ops = 2 * batch * cells + n_matched
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, n_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# (label, engine overrides) timed at full width; the first is the main path
TIMED = [
    ("uint8/inclusive", {}),
    ("uint16/inclusive", {"table_dtype": "uint16"}),
    ("int32/direct", {"table_dtype": "int32"}),
    ("int32/msb_lsb", {"mode": "msb_lsb"}),
    ("int32/two_cycle", {"mode": "two_cycle"}),
]


def phase_times(cm, batches, name, stats) -> None:
    n_trees = cm.table.n_trees

    def timed(eng, b, *, mask=True, bias=True, iters=10):
        a = eng.arrays
        qp = eng._prep_queries(batches[b])
        m = a.tile_mask if mask else None
        bs = eng._bias if bias else None
        kw = dict(r_blk=eng.r_blk, f_blk=eng.f_blk, mode=eng.kernel_mode)
        return sync_time(lambda: K.cam_match_cuda(qp, a.low, a.high, a.leaf, m, bs, **kw), iters)

    def plain(eng, b):
        a = eng.arrays
        qp = eng._prep_queries(batches[b])
        return sync_time(lambda: ref.cam_match_ref(qp, a.low, a.high, a.leaf,
                                                   mode=eng.kernel_mode), 2, warmup=1)

    rows = {}
    for label, overrides in TIMED:
        eng = cm.engine(**overrides)
        for b in ((256, 1, 1024) if not overrides else (256,)):
            ms = timed(eng, b, iters=50 if b == 1 else 5)
            plain_ms = plain(eng, b)
            bnd, by = bound_ms(eng, b, b * n_trees)  # one leaf per tree and query
            rows[label, b] = (ms, plain_ms, bnd, by)
            print(f"times [{name}] cam_match {label} B={b} (R={eng.arrays.r_pad}, "
                  f"F_pad={eng.arrays.f_pad}): kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.3f} ms, bound {bnd:.4f} ms by {by} "
                  f"({bnd / ms:.1%} of bound)", flush=True)
    eng = cm.engine()
    no_mask = timed(eng, 256, mask=False, iters=5)
    no_bias = timed(eng, 256, bias=False, iters=5)
    active = float(eng.arrays.tile_mask.float().mean())
    print(f"times [{name}] cam_match uint8/inclusive B=256: tile mask off "
          f"{no_mask:.4f} ms (mask on: {rows['uint8/inclusive', 256][0]:.4f} ms, "
          f"{active:.1%} of tiles active); bias unfused {no_bias:.4f} ms", flush=True)
    print(f"times [{name}] peak device memory over the main path "
          f"{stats['peak_bytes'] / 2**30:.2f} GiB", flush=True)
    ms, plain_ms, bnd, by = rows["uint8/inclusive", 256]
    stats["kernel_line"] = {
        "name": "cam_match", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cam_match.cu",
        "replaces": "src/repro/kernels/cam_match.py:90",
        "launches": stats["launches"], "max_abs_err": stats["max_abs_err"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
        "library_ms": None,
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's products
    torch.backends.cudnn.allow_tf32 = False
    name = card()
    print(name, flush=True)
    print(f"env: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}, "
          f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    info = K.build()
    print(f"build: nvcc {info.seconds:.1f} s -> {info.path.name}", flush=True)
    for ln in ptxas_report(info.log):
        print(f"  ptxas {ln}", flush=True)

    stats = {"max_abs_err": 0.0}
    t0 = time.perf_counter()
    phase_kernel(dev, stats)
    print(f"kernel phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    cm, batches = phase_main_path(dev, stats)
    print(f"main path phase {time.perf_counter() - t0:.1f} s", flush=True)
    phase_times(cm, batches, name, stats)

    print(json.dumps({"kernels": [stats["kernel_line"]]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line (or block) each:
  1. environment: card name and power limit, torch and CUDA versions;
  2. build: nvcc of kernels/csrc/*.cu (one process per source, started
     together), its time and ptxas report;
  3. the kernels against their plain PyTorch version on the card: the hard
     kernel for every instantiated (table dtype x cell mode), the soft
     kernel at tau 0, 0.1 and 0.5 (scores, margins, tau = 0 against the
     int32 `direct` kernel, the moments pass), each on the table's cell
     list as built and widened past the staged slots, bias fused and
     unfused, at b256/r16384/f130/c8 and a ragged small shape;
  4. the main paths at the full width of xtime-tabular (4096 trees of
     depth 8, 130 features, 256 bins, 8 classes), each with the launch
     counts set to 0 just before it and read just after:
     hard: ``repro_torch.build`` -> ``CompiledModel.predict``/``raw_margin``
     at batch 1, 37, 256 and 1024, held to the host traversal and to the
     plain version, then save -> load -> predict;
     soft: ``build(deploy=DeployConfig(mode="soft", tau=0.1))`` ->
     ``raw_margin``/``raw_moments`` at tau = 0 (held to the host
     traversal, the m1 moments to the unfused margins),
     ``predict_proba`` and ``predict(return_uncertainty=True)`` at batch
     1, 37 and 256 and ``raw_moments`` at batch 37 (held to the plain
     version), then save -> load -> ``predict_proba``;
  5. times with CUDA events at full width, each launch alone with the L2
     cache flushed before it (and back to back, warm, beside it), beside
     the least time the card could take: the main path's uint8/inclusive
     kernel at batch 256, 1 and 1024 (fused bias on and off), the uint16
     and int32 instantiations at batch 256, the soft kernel at batch 1 and
     256 for tau 0 and 0.1 and its moments pass at batch 256, each beside
     its plain version and beside what the cell-list design evaluates
     (listed cells x queries); the cell lists' K, cells per row, bytes and
     host build time; soft bind time; peak device memory.

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
SOFT_TAU = 0.1  # the soft main path's temperature, in bin units
# H100 SXM peaks (NVIDIA data sheet, dense): HBM 3.35 TB/s; 67 TFLOP/s
# float32 outside the tensor cores counts an FMA as two operations, i.e.
# 33.5 T lane-instructions/s — the rate of a 32-bit compare, AND or add.
# The special-function units return 16 ex2/lg2 results per clock per SM
# (CUDA C++ programming guide, arithmetic instruction throughput, compute
# capability 9.0); their rate is that times the SMs and the card's
# maximum SM clock, both read from the card.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
F32_FLOPS_PER_S = 67e12
SFU_PER_CLOCK_PER_SM = 16
F32_EPS = ref.F32_EPS


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def card() -> str:
    return smi("name,power.limit")


def sfu_per_s() -> tuple[float, str]:
    """ex2/lg2 results per second on this card, and how it was reckoned."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(smi("clocks.max.sm").split()[0])
    rate = SFU_PER_CLOCK_PER_SM * sms * mhz * 1e6
    return rate, f"{SFU_PER_CLOCK_PER_SM}/clk/SM x {sms} SMs x {mhz:.0f} MHz"


_TYPES = {"h": "uint8", "t": "uint16", "i": "int32"}


def ptxas_report(log: str) -> list[str]:
    """One line per compiled kernel: registers, shared memory, spills."""
    lines, out = log.splitlines(), []
    for i, ln in enumerate(lines[:-2]):
        m = re.search(r"Function properties for (\S+)", ln)
        if not m:
            continue
        k = re.search(r"cam_match_kernelI([hti])NS_\d+(\w+?)EEEv", m.group(1))
        sk = re.search(r"cam_match_soft_kernelILb([01])E", m.group(1))
        if k:
            name = f"cam_match<{_TYPES[k.group(1)]}, {k.group(2)}>"
        elif sk:
            name = f"cam_match_soft<{'tau=0' if sk.group(1) == '1' else 'tau>0'}>"
        else:
            name = "reduce_splits"
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
    cells = ops.binding_cells(lo, hi, n_bins=p["n_bins"], inclusive=inclusive,
                              n_real_rows=p["low"].shape[0])
    q = ops.pad_queries(p["q"], lo.shape[1], dtype=dtype, device=dev)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return q, to(lo), to(hi), to(lm), cells.to(dev)


def widened(cells: ops.CellList, k: int) -> ops.CellList:
    """The same list with its rows padded to ``k`` slots: the kernels must
    stop at each row's count and read the slots past their staged ones
    from device memory."""
    def pad(a):
        out = torch.zeros((a.shape[0], k), dtype=a.dtype, device=a.device)
        out[:, : a.shape[1]] = a
        return out
    return ops.CellList(cells.count, pad(cells.feat), pad(cells.lo), pad(cells.hi), cells.width)


WIDE_K = 40  # past the 8 cells a row the kernels stage


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
            q, lo, hi, lm, cells = dyadic
            _, _, _, lm_n, _ = operands(p, dtype, incl, normal, dev)
            bias = torch.full((1, lm.shape[1]), 0.3125, device=dev)
            bits_ref = ref.cam_match_bits_ref(q, lo, hi, mode=mode)
            out_ref = ref.cam_match_ref(q, lo, hi, lm, mode=mode)
            out_ref_n = ref.cam_match_ref(q, lo, hi, lm_n, mode=mode)
            for cl in (cells, widened(cells, WIDE_K)):
                bits = K.cam_match_bits_cuda(q, cl, mode=mode)
                out = K.cam_match_cuda(q, cl, lm, mode=mode)
                again = K.cam_match_cuda(q, cl, lm, mode=mode)
                fused = K.cam_match_cuda(q, cl, lm, bias, mode=mode)
                out_n = K.cam_match_cuda(q, cl, lm_n, mode=mode)
                fused_n = K.cam_match_cuda(q, cl, lm_n, bias, mode=mode)
                torch.cuda.synchronize()
                tag = f"{p['name']} {dtype}/{mode} K={cl.k}"
                if not torch.equal(bits, bits_ref):
                    fail(f"{tag}: match bits differ from the plain version")
                if not torch.equal(out, out_ref):
                    fail(f"{tag}: k/16 margins differ from the plain version")
                if not torch.equal(out, again):
                    fail(f"{tag}: two runs differ")
                if not (torch.equal(fused, out + bias) and torch.equal(fused_n, out_n + bias)):
                    fail(f"{tag}: fused bias != unfused + bias")
                err = (out_n - out_ref_n).abs()
                lim = ref.summation_bound(bits_ref, lm_n, extra=K.n_splits(lo.shape[0]) + 2)
                if bool((err.double() > lim).any()):
                    fail(f"{tag}: normal-leaf margins off by {float(err.max())} > bound")
                stats["max_abs_err"] = max(stats["max_abs_err"], float(err.max()))
                enc = "incl" if incl else "excl"
                if dtype == "int32":
                    int32_out.setdefault(enc, out_n)
                elif not torch.equal(out_n, int32_out[enc]):
                    fail(f"{tag}: packed {dtype} != int32 {enc} margins")
            print(f"kernel {p['name']} {dtype}/{mode}: bits, k/16 margins, "
                  f"fused bias, cell list K={cells.k} and widened to {WIDE_K}, rerun "
                  f"exact; normal leaves "
                  f"within 2(n+splits)·u·Σ|leaf| (max |err| so far "
                  f"{stats['max_abs_err']:.3g})", flush=True)


def soft_operands(p, leaf, dev):
    """The problem in the float32 soft layout: bins as float32 queries."""
    lo, hi, lm, _ = ops.pack_tables(p["low"], p["high"], leaf, r_blk=p["r_blk"],
                                    f_blk=p["f_blk"], n_bins=p["n_bins"], dtype="float32")
    cells = ops.binding_cells(lo, hi, n_bins=p["n_bins"], inclusive=False,
                              n_real_rows=p["low"].shape[0])
    q = ops.pad_queries(p["q"], lo.shape[1], dtype="float32", device=dev)
    to = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return q, to(lo), to(hi), to(lm), cells.to(dev)


def moments_matrix(lm: torch.Tensor) -> torch.Tensor:
    """[leaf, leaf^2, mass] as the engine builds it; each compiled row
    feeds one channel, so its mass goes where its leaf is nonzero."""
    return torch.cat([lm, lm * lm, (lm != 0).float()], dim=1).contiguous()


def perturb(p, rng):
    """1% of the real cells made never-match (high <= low), as the defect
    injector leaves them: (+inf, -inf) in the soft layout."""
    low, high = p["low"].copy(), p["high"].copy()
    bad = rng.random(low.shape) < 0.01
    high[bad] = low[bad]
    return dict(p, name=p["name"] + "+never", low=low, high=high)


def phase_soft_kernel(dev, stats) -> None:
    """The soft kernel against the plain version: scores and margins,
    exact at tau = 0 (and equal to the int32 `direct` kernel), within
    ``ref.soft_score_bound``/``ref.soft_margin_bound`` at tau > 0; the
    cell list as built and widened, fused bias, reruns, never-match rows,
    the moments pass."""
    rng = np.random.default_rng(SEED + 10)
    worst = 0.0  # largest |err| / bound over the tau > 0 checks
    for p in (tree_problem(rng, dev), perturb(ragged_problem(rng, dev), rng)):
        normal = rng.normal(size=p["leaf"].shape).astype(np.float32)
        normal[p["leaf"] == 0] = 0.0  # keep the class routing of each row
        q, lo, hi, lm, cells = soft_operands(p, p["leaf"], dev)
        _, _, _, lm_n, _ = soft_operands(p, normal, dev)
        mom = moments_matrix(lm)
        f_pad, extra = lo.shape[1], K.n_splits(lo.shape[0]) + 2
        never = torch.isposinf(lo).any(dim=1)  # padding rows and perturbed rows
        iq, ilo, ihi, ilm, icells = operands(p, "int32", False, p["leaf"], dev)
        _, _, _, ilm_n, _ = operands(p, "int32", False, normal, dev)
        direct = (K.cam_match_cuda(iq, icells, ilm, mode="direct"),
                  K.cam_match_cuda(iq, icells, ilm_n, mode="direct"))
        bias = torch.full((1, lm.shape[1]), 0.3125, device=dev)
        for tau in (0.0, 0.1, 0.5):
            s_ref = ref.soft_scores_ref(q, lo, hi, tau=tau)
            plain = {name: ref.cam_match_ref(q, lo, hi, leaf, mode="soft", tau=tau)
                     for name, leaf in (("k/16", lm), ("normal", lm_n), ("moments", mom))}
            for cl in (cells, widened(cells, WIDE_K)):
                tag = f"{p['name']} soft tau={tau} K={cl.k}"
                scores = K.soft_scores_cuda(q, cl, tau=tau)
                outs = {"k/16": K.cam_match_soft_cuda(q, cl, lm, tau=tau),
                        "normal": K.cam_match_soft_cuda(q, cl, lm_n, tau=tau),
                        "moments": K.cam_match_soft_cuda(q, cl, mom, tau=tau)}
                again = K.cam_match_soft_cuda(q, cl, lm_n, tau=tau)
                fused = K.cam_match_soft_cuda(q, cl, lm_n, bias, tau=tau)
                torch.cuda.synchronize()
                if torch.isnan(scores).any() or any(torch.isnan(o).any() for o in outs.values()):
                    fail(f"{tag}: NaN")
                if not bool((scores[:, never] == 0).all()):
                    fail(f"{tag}: a never-match row scored above 0")
                if not (torch.equal(again, outs["normal"]) and torch.equal(fused, again + bias)):
                    fail(f"{tag}: rerun differs, or fused bias != unfused + bias")
                if tau == 0.0:  # scores 0/1: exact wherever the sums are order-free
                    if not torch.equal(scores, s_ref):
                        fail(f"{tag}: scores differ from the plain version")
                    for name in ("k/16", "moments"):
                        if not torch.equal(outs[name], plain[name]):
                            fail(f"{tag}: {name} margins differ from the plain version")
                    err = (outs["normal"] - plain["normal"]).abs().double()
                    if bool((err > ref.summation_bound(s_ref, lm_n, extra)).any()):
                        fail(f"{tag}: normal margins off by {float(err.max())} > bound")
                    if not (torch.equal(outs["k/16"], direct[0])
                            and torch.equal(outs["normal"], direct[1])):
                        fail(f"{tag}: margins differ from the int32 direct kernel")
                    continue
                lim_s = ref.soft_score_bound(s_ref, f_pad)
                err_s = (scores - s_ref).abs().double()
                worst = max(worst, float((err_s / lim_s).max()))
                if bool((err_s > lim_s).any()):
                    fail(f"{tag}: scores off by {float(err_s.max())} > bound")
                leaves = {"k/16": lm, "normal": lm_n, "moments": mom}
                for name, out in outs.items():
                    lim = ref.soft_margin_bound(s_ref, leaves[name], f_pad, extra)
                    err = (out - plain[name]).abs().double()
                    worst = max(worst, float((err / lim).max()))
                    if bool((err > lim).any()):
                        fail(f"{tag}: {name} margins off by {float(err.max())} > bound")
                    if name == "normal":
                        stats["soft_max_abs_err"] = max(stats["soft_max_abs_err"],
                                                        float(err.max()))
            print(f"kernel {p['name']} soft tau={tau}: cell list K={cells.k} and widened "
                  f"to {WIDE_K}, fused bias, rerun, "
                  f"never-match rows 0, no NaN; "
                  + ("scores, k/16 + moments margins exact; normal margins within "
                     "2(n+splits+2)u·Σ|s·leaf|; all == int32 direct kernel bit for bit"
                     if tau == 0.0 else
                     f"scores within s(2(F+8)u|ln s| + 8u) + 2^-126 (F = {f_pad}), margins "
                     f"and moments within that through |leaf| + 2(n+splits+2)u·Σ|s·leaf| "
                     f"(max |err| normal margins so far {stats['soft_max_abs_err']:.3g}, "
                     f"worst err/bound {worst:.3g})"), flush=True)


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
    reset_launches()  # count only the main path's launches
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
    return ens, cm, batches


def reset_launches() -> None:
    for fn in (K.cam_match_cuda, K.cam_match_bits_cuda, K.cam_match_soft_cuda,
               K.soft_scores_cuda):
        fn.launches = 0


def phase_soft_main_path(ens, cm, batches, stats):
    """The soft main path at full width, with the hard engine still bound."""
    t0 = time.perf_counter()
    soft = repro_torch.build(cm.table, deploy=repro_torch.DeployConfig(mode="soft", tau=SOFT_TAU))
    t1 = time.perf_counter()
    print(f"soft path: build(deploy=DeployConfig(mode='soft', tau={SOFT_TAU})) "
          f"{t1 - t0:.1f} s host", flush=True)
    hard = {b: cm.raw_margin(batches[b]) for b in (37, 256)}  # the hard main path's
    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # count only the soft main path's launches
    expected = 0
    t0 = time.perf_counter()
    eng0 = soft.engine(tau=0.0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eng = soft.engine()
    torch.cuda.synchronize()
    stats["soft_bind_s"] = time.perf_counter() - t1
    stats["soft_bind0_s"] = t1 - t0
    # tau = 0: the exact limit, held to the host traversal and the hard path
    for b in (37, 256):
        m0 = soft.raw_margin(batches[b], tau=0.0)
        expected += 1
        if not np.array_equal(m0[:64], ens.raw_margin(batches[b][:64])):
            fail(f"soft tau=0 batch {b}: margins differ from Ensemble.raw_margin")
        if not np.array_equal(m0, hard[b]):
            fail(f"soft tau=0 batch {b}: margins differ from the hard main path")
    mom0 = eng0.raw_moments(batches[256])
    expected += 1
    if not (mom0[:, 16:24].sum(dim=1) == cm.table.n_trees).all():
        fail("soft tau=0: the mass channels do not sum to the tree count")
    # tau > 0: probabilities and uncertainty at every batch
    proba, unc = {}, {}
    for b in (1, 37, 256):
        x = batches[b]
        proba[b] = soft.predict_proba(x)
        pred, unc[b] = soft.predict(x, return_uncertainty=True)
        expected += 3
        if proba[b].shape != (b, 8) or not np.isfinite(proba[b]).all():
            fail(f"soft batch {b}: predict_proba not finite of shape ({b}, 8)")
        if not np.allclose(proba[b].sum(axis=1), 1.0, rtol=0, atol=1e-5):
            fail(f"soft batch {b}: predict_proba rows do not sum to 1 within 1e-5")
        if not (np.isfinite(unc[b]).all() and (unc[b] >= 0).all() and unc[b].shape == (b,)):
            fail(f"soft batch {b}: uncertainties not finite and >= 0")
        if not np.array_equal(pred, proba[b].argmax(axis=1)):
            fail(f"soft batch {b}: predict != argmax of predict_proba")
    mom37 = eng.raw_moments(batches[37])
    expected += 1
    torch.cuda.synchronize()
    stats["soft_launches"] = K.cam_match_soft_cuda.launches
    stats["soft_peak_bytes"] = torch.cuda.max_memory_allocated()
    if stats["soft_launches"] != expected or K.cam_match_cuda.launches != 0:
        fail(f"soft path: {stats['soft_launches']} soft launches (expected {expected}), "
             f"{K.cam_match_cuda.launches} hard ones")
    print(f"soft path: {expected} soft kernel launches (tau=0: 2 raw_margin + 1 "
          f"raw_moments; tau={SOFT_TAU}: predict_proba + predict + moments at B = 1, 37, "
          f"256, and raw_moments at B = 37); tau=0 margins == Ensemble.raw_margin "
          f"(64 rows) == hard path (all rows), "
          f"mass channels sum to {cm.table.n_trees}; proba rows sum to 1, "
          f"uncertainties finite >= 0; bind {stats['soft_bind_s']:.1f} s host "
          f"(tau=0 engine {stats['soft_bind0_s']:.1f} s)", flush=True)

    # tau = 0: the m1 channels are the unfused margins, bit for bit (the
    # same float adds per channel); a comparison launch, not counted
    a0 = eng0.arrays
    unfused = K.cam_match_soft_cuda(eng0._prep_queries(batches[256]), a0.cells, a0.leaf,
                                    tau=0.0)
    if not torch.equal(mom0[:, :8], unfused[:, :8]):
        fail("soft tau=0: the m1 moments differ from the unfused margins")
    print("soft path: tau=0 m1 moments == unfused margins (B = 256) bit for bit", flush=True)

    # B = 37 margins and moments against the plain version on the card
    a = eng.arrays
    qp = eng._prep_queries(batches[37])
    s_ref = ref.soft_scores_ref(qp, a.low, a.high, tau=SOFT_TAU)
    plain = ref.cam_match_ref(qp, a.low, a.high, a.leaf, mode="soft", tau=SOFT_TAU)
    plain = plain + eng._bias  # the separate epilogue
    lim = ref.soft_margin_bound(s_ref, a.leaf, a.f_pad, K.n_splits(a.r_pad) + 2)
    lim = lim + 2 * F32_EPS * plain.abs().double()  # the bias add
    got = torch.from_numpy(soft.raw_margin(batches[37])).to(plain.device)
    err = (got - plain[:, :8]).abs().double()
    if bool((err > lim[:, :8]).any()):
        fail(f"soft batch 37: margins off the plain version by {float(err.max())} > bound")
    stats["soft_max_abs_err"] = max(stats["soft_max_abs_err"], float(err.max()))
    print(f"soft path: B=37 margins within the bound of the plain version on the card "
          f"(max |err| {float(err.max()):.3g}, worst err/bound "
          f"{float((err / lim[:, :8]).max()):.3g})", flush=True)
    plain_m = ref.cam_match_ref(qp, a.low, a.high, eng._moments, mode="soft", tau=SOFT_TAU)
    lim_m = ref.soft_margin_bound(s_ref, eng._moments, a.f_pad, K.n_splits(a.r_pad) + 2)
    err_m = (mom37 - plain_m[:, :24]).abs().double()
    if mom37.shape != (37, 24) or bool((err_m > lim_m[:, :24]).any()):
        fail(f"soft batch 37: moments off the plain version by {float(err_m.max())} > bound")
    stats["soft_max_abs_err"] = max(stats["soft_max_abs_err"], float(err_m.max()))
    print(f"soft path: B=37 moments (R={a.r_pad}, C=24) within the bound of the plain "
          f"version on the card (max |err| {float(err_m.max()):.3g}, worst err/bound "
          f"{float((err_m / lim_m[:, :24]).max()):.3g})", flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        soft.save(Path(tmp) / "soft")
        loaded = repro_torch.CompiledModel.load(Path(tmp) / "soft")
        if (loaded.deploy.mode, loaded.deploy.tau) != ("soft", SOFT_TAU):
            fail("soft save -> load lost mode/tau")
        if not np.array_equal(loaded.predict_proba(batches[37]), proba[37]):
            fail("soft save -> load: predict_proba differs")
        del loaded
    print("soft path: save -> load keeps mode and tau, predict_proba equal", flush=True)
    return soft


# -- phase 5: times -----------------------------------------------------------


FLUSH_BYTES = 256 << 20  # written before each cold launch: 5x the 50 MB L2


def cold_time(fn, iters: int) -> float:
    """Mean milliseconds of ``fn()`` launched alone with the L2 cache
    flushed before it: CUDA events around each launch only, after a write
    of ``FLUSH_BYTES`` and a short device spin that lets the host enqueue
    the launch before the first event is reached."""
    scratch = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    fn()
    pairs = []
    for i in range(iters):
        scratch.fill_(i & 0xFF)
        torch.cuda._sleep(200_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(st.elapsed_time(en) for st, en in pairs) / iters


def binding_bounds(eng: XTimeEngine) -> int:
    """Bounds that constrain a query: low > 0 or high < n_bins, on the
    compiled table.  A wildcard side needs no compare."""
    t = eng.table
    return int((t.low > 0).sum()) + int((t.high < t.n_bins).sum())


def listed_cells(cells: ops.CellList) -> int:
    """Cells the kernels evaluate a query against: each row's count, the
    ELL padding past it excluded."""
    return int(cells.count.sum())


def list_bytes(cells: ops.CellList) -> tuple[int, int]:
    """Bytes of the cell list: the listed cells and counts (what a kernel
    must read), and as stored with its ELL padding."""
    per_cell = cells.feat.element_size() + 2 * cells.lo.element_size()
    R, K = cells.feat.shape
    return listed_cells(cells) * per_cell + 4 * R, (K * per_cell + 4) * R


def cell_list_line(name: str, label: str, eng: XTimeEngine) -> None:
    """K, cells per row, bytes and host build time of an engine's list."""
    a, t = eng.arrays, eng.table
    lo, hi = a.low.cpu().numpy(), a.high.cpu().numpy()
    t0 = time.perf_counter()
    ops.binding_cells(lo, hi, n_bins=t.n_bins, inclusive=a.inclusive, n_real_rows=t.n_rows)
    secs = time.perf_counter() - t0
    cnt = a.cells.count[: t.n_rows].double()
    need, stored = list_bytes(a.cells)
    print(f"times [{name}] cell list {label}: K = {a.cells.k}, cells per row mean "
          f"{float(cnt.mean()):.3f} max {int(cnt.max())} ({t.n_rows} rows, F_pad "
          f"{a.f_pad}); {need / 1e6:.2f} MB listed + counts, {stored / 1e6:.2f} MB as "
          f"stored; built in {secs:.2f} s on the host", flush=True)


def match_stats(eng: XTimeEngine, qp: torch.Tensor) -> tuple[int, int]:
    """(matched (query, row) pairs, distinct matched rows) of this batch,
    from the kernel's match words, 256 queries at a time."""
    rows = torch.zeros(eng.arrays.r_pad, dtype=torch.bool, device=qp.device)
    n = 0
    for b0 in range(0, qp.shape[0], 256):
        bits = K.cam_match_bits_cuda(qp[b0:b0 + 256], eng.arrays.cells, mode=eng.kernel_mode)
        n += int(bits.sum())
        rows |= bits.any(dim=0)
    return n, int(rows.sum())


def bound_ms(eng: XTimeEngine, batch: int, n_matched: int,
             distinct: int) -> tuple[float, str, float]:
    """Least time for one cam_match call on this data: the bytes the
    cell-list kernel must read and write, each once — the listed cells and
    counts, the distinct matched leaf rows, the queries and the outputs —
    at HBM rate, against a compare and an AND per binding bound and query
    plus one add per matched row and query at the 32-bit lane rate.
    Third: the time of what the design evaluates at that rate, two
    compares per listed cell and query plus the adds."""
    a = eng.arrays
    item = np.dtype(eng.table_dtype).itemsize
    nbytes = (list_bytes(a.cells)[0] + distinct * a.c_pad * 4 + batch * a.f_pad * item
              + batch * a.c_pad * 4)
    n_ops = 2 * batch * binding_bounds(eng) + n_matched
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, n_ops / INT32_OPS_PER_S * 1e3
    design = (2 * batch * listed_cells(a.cells) + n_matched) / INT32_OPS_PER_S * 1e3
    return (*((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")), design)


# (label, engine overrides) timed at full width; the first is the main path
TIMED = [
    ("uint8/inclusive", {}),
    ("uint16/inclusive", {"table_dtype": "uint16"}),
    ("int32/direct", {"table_dtype": "int32"}),
    ("int32/msb_lsb", {"mode": "msb_lsb"}),
    ("int32/two_cycle", {"mode": "two_cycle"}),
]


def phase_times(cm, batches, name, stats) -> None:
    def launcher(eng, qp, *, bias=True):
        a = eng.arrays
        bs = eng._bias if bias else None
        return lambda: K.cam_match_cuda(qp, a.cells, a.leaf, bs, mode=eng.kernel_mode)

    def plain(eng, qp):
        a = eng.arrays
        return sync_time(lambda: ref.cam_match_ref(qp, a.low, a.high, a.leaf,
                                                   mode=eng.kernel_mode), 2, warmup=1)

    rows = {}
    for label, overrides in TIMED:
        eng = cm.engine(**overrides)
        for b in ((256, 1, 1024) if not overrides else (256,)):
            qp = eng._prep_queries(batches[b])
            fn = launcher(eng, qp)
            ms = cold_time(fn, 20 if b == 1 else 10)
            warm = sync_time(fn, 50 if b == 1 else 10)
            plain_ms = plain(eng, qp)
            bnd, by, design = bound_ms(eng, b, *match_stats(eng, qp))
            rows[label, b] = (ms, plain_ms, bnd, by)
            print(f"times [{name}] cam_match {label} B={b} (R={eng.arrays.r_pad}, "
                  f"F_pad={eng.arrays.f_pad}, K={eng.arrays.cells.k}): kernel {ms:.4f} ms "
                  f"L2 flushed (warm {warm:.4f} ms), plain {plain_ms:.3f} ms, bound "
                  f"{bnd:.4f} ms by {by} ({bnd / ms:.1%} of bound); the cell-list design "
                  f"evaluates {listed_cells(eng.arrays.cells) * b} cells x queries: "
                  f"{design:.4f} ms of compares", flush=True)
        if not overrides:
            cell_list_line(name, label, eng)
    eng = cm.engine()
    qp = eng._prep_queries(batches[256])
    no_bias = cold_time(launcher(eng, qp, bias=False), 10)
    print(f"times [{name}] cam_match uint8/inclusive B=256: bias unfused {no_bias:.4f} ms "
          f"(fused {rows['uint8/inclusive', 256][0]:.4f} ms), L2 flushed", flush=True)
    print(f"times [{name}] peak device memory over the main path "
          f"{stats['peak_bytes'] / 2**30:.2f} GiB; binding bounds "
          f"{binding_bounds(eng)} of {2 * eng.table.n_rows * eng.table.n_cols} "
          f"(table cells x 2)", flush=True)
    ms, plain_ms, bnd, by = rows["uint8/inclusive", 256]
    stats["kernel_line"] = {
        "name": "cam_match", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cam_match.cu",
        "replaces": "src/repro/kernels/cam_match.py:90",
        "launches": stats["launches"], "max_abs_err": stats["max_abs_err"],
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": by,
        "library_ms": None,
    }


def finite_bounds(eng: XTimeEngine) -> int:
    """Finite bounds of the soft-encoded table: the sides whose
    log-sigmoid is not exactly 0 (an infinite side needs none)."""
    a = eng.arrays
    return int(torch.isfinite(a.low).sum()) + int(torch.isfinite(a.high).sum())


def evaluated_sides(cells: ops.CellList) -> int:
    """Log-sigmoids the soft kernel evaluates a query against: the sides
    of listed cells that are not the exact +0 of an infinite bound."""
    used = torch.arange(cells.k, device=cells.count.device)[None, :] < cells.count[:, None]
    return int(((cells.lo != -torch.inf) & used).sum() + ((cells.hi != torch.inf) & used).sum())


def soft_bound_ms(eng: XTimeEngine, batch: int, tau: float, leaf: torch.Tensor,
                  sfu: float, distinct: int) -> tuple[float, str, float]:
    """Least time for one soft kernel call on this data.  Bytes: the listed
    cells and counts, the leaf rows the call needs (the ``distinct``
    matched rows at tau = 0; every table row at tau > 0), the queries and
    the outputs, each once.  Operations at tau = 0: a compare and an AND
    per finite bound and query plus one add per matched row and query (one
    per tree), at the 32-bit lane rate; at tau > 0: two special-function
    results (ex2 + lg2) per finite bound and query and one ex2 per table
    row and query, at the SFU rate ``sfu``, against an FMA per score and
    nonzero leaf entry at the float32 rate.  Third: the time of what the
    design evaluates at the same rates (two compares per listed cell, or
    two SFU results per evaluated side, and query)."""
    a, t = eng.arrays, eng.table
    c = leaf.shape[1]
    rows = distinct if tau == 0.0 else t.n_rows
    nbytes = (list_bytes(a.cells)[0] + rows * c * 4 + batch * a.f_pad * 4
              + batch * c * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    n_fin, adds = finite_bounds(eng), batch * t.n_trees
    if tau == 0.0:
        t_ops = (2 * batch * n_fin + adds) / INT32_OPS_PER_S * 1e3
        design = (2 * batch * listed_cells(a.cells) + adds) / INT32_OPS_PER_S * 1e3
    else:
        fma = 2 * batch * int((leaf != 0).sum()) / F32_FLOPS_PER_S * 1e3
        t_ops = max(batch * (2 * n_fin + t.n_rows) / sfu * 1e3, fma)
        design = batch * (2 * evaluated_sides(a.cells) + a.r_pad) / sfu * 1e3
    return (*((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")), design)


def phase_soft_times(soft, batches, name, stats) -> None:
    sfu, how = sfu_per_s()
    eng = soft.engine()
    rows = {}
    for tau in (0.0, SOFT_TAU):
        e = soft.engine(tau=tau)
        a = e.arrays
        for b, what in ((1, "margin"), (256, "margin"), (256, "moments")):
            if what == "moments" and tau == 0.0:
                continue
            leaf, bias = (a.leaf, e._bias) if what == "margin" else (e._moments, None)
            qp = e._prep_queries(batches[b])
            fn = lambda: K.cam_match_soft_cuda(qp, a.cells, leaf, bias, tau=tau)  # noqa: E731
            ms = cold_time(fn, 20 if b == 1 else 10)
            warm = sync_time(fn, 50 if b == 1 else 10)
            plain_ms = sync_time(lambda: ref.cam_match_ref(qp, a.low, a.high, leaf,
                                                           mode="soft", tau=tau),
                                 1 if b == 256 else 2, warmup=1)
            distinct = 0 if tau else int((K.soft_scores_cuda(qp, a.cells, tau=0.0) > 0)
                                         .any(dim=0).sum())
            bnd, by, design = soft_bound_ms(e, b, tau, leaf, sfu, distinct)
            rows[tau, b, what] = (ms, plain_ms, bnd, by)
            print(f"times [{name}] cam_match_soft tau={tau} {what} B={b} "
                  f"(R={a.r_pad}, F_pad={a.f_pad}, C={leaf.shape[1]}, K={a.cells.k}): kernel "
                  f"{ms:.4f} ms L2 flushed (warm {warm:.4f} ms), plain {plain_ms:.3f} ms, "
                  f"bound {bnd:.4f} ms by {by} ({bnd / ms:.1%} of bound); the cell-list "
                  f"design evaluates {listed_cells(a.cells) * b} cells x queries: "
                  f"{design:.4f} ms of " + ("compares" if tau == 0.0 else "SFU time"),
                  flush=True)
    cell_list_line(name, "soft float32", eng)
    print(f"times [{name}] soft bound: SFU rate {sfu / 1e12:.3f} T/s ({how}); finite "
          f"bounds {finite_bounds(eng)} of {2 * eng.arrays.r_pad * eng.arrays.f_pad}, "
          f"sides the kernel evaluates {evaluated_sides(eng.arrays.cells)}; soft bind "
          f"{stats['soft_bind_s']:.1f} s host; peak device memory over the soft path, "
          f"hard and soft engines bound: {stats['soft_peak_bytes'] / 2**30:.2f} GiB "
          f"(allocated now {torch.cuda.memory_allocated() / 2**30:.2f} GiB)", flush=True)
    ms, plain_ms, bnd, by = rows[SOFT_TAU, 256, "margin"]
    stats["soft_kernel_line"] = {
        "name": "cam_match_soft", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/cam_match_soft.cu",
        "replaces": "src/repro/kernels/cam_match.py:90",
        "launches": stats["soft_launches"], "max_abs_err": stats["soft_max_abs_err"],
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

    stats = {"max_abs_err": 0.0, "soft_max_abs_err": 0.0}
    t0 = time.perf_counter()
    phase_kernel(dev, stats)
    print(f"kernel phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_soft_kernel(dev, stats)
    print(f"soft kernel phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    reset_launches()
    ens, cm, batches = phase_main_path(dev, stats)
    print(f"main path phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    soft = phase_soft_main_path(ens, cm, batches, stats)
    print(f"soft path phase {time.perf_counter() - t0:.1f} s", flush=True)
    phase_times(cm, batches, name, stats)
    phase_soft_times(soft, batches, name, stats)

    print(json.dumps({"kernels": [stats["kernel_line"], stats["soft_kernel_line"]]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

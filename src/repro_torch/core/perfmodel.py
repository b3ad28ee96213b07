"""X-TIME chip performance model (§III-C Eq. 4/5, §IV-B Fig. 8, §V Fig. 10/11).

The paper evaluates a simulated 16 nm chip with an SST cycle-detailed
simulator; this module is the analytical equivalent, built from the same
architectural constants (1 GHz clock, λ_CAM = 4 cycles, λ_C = 12 cycles,
4096 cores, radix-4 H-tree) and calibrated against every number the paper
reports:

  * core throughput 250 MS/s (≤4 trees/core, Eq. 4) / ~200 MS/s (5 trees,
    Eq. 5),
  * chip latency ~100 ns for typical models,
  * 19 W peak power, energy down to ~0.3 nJ/decision with batching,
  * Booster comparison: O(D) core occupancy, 1/(4D) samples/clock,
  * GPU comparison: latency 10 µs – 1 ms (V100, FIL kernels).

It consumes the compiler's ``CorePlacement`` and ``NoCPlan`` so every
number responds to the actual model mapping, exactly like the paper's
toolchain.

A copy of ``repro.core.perfmodel`` (the port imports nothing of ``repro``):
the chip model (``PowerAreaSpec``, ``PerfReport``, ``core_throughput_msps``,
``xtime_perf``), so the port assembles the same artifacts, and the analytic
traffic, Booster and GPU models (``kernel_traffic_model``, ``booster_perf``,
``GPUSpec``, ``gpu_perf_model``).  The GPU model describes the paper's
baseline GPU from its published constants; none of its numbers is a
reading of the card the port runs on.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.compile import CAMTable, ChipSpec, CorePlacement
from repro_torch.core.noc import NoCPlan


# ---------------------------------------------------------------------------
# Power / area constants (Fig. 8: "area and power mainly consumed by the
# analog CAM arrays, peripherals negligible"; totals calibrated to the
# paper's 19 W peak for 4096 active cores at 16 nm).
# ---------------------------------------------------------------------------


@dataclass
class PowerAreaSpec:
    acam_mw_per_core: float = 4.20  # aCAM arrays + DAC + SA + P-Ch (dominant)
    sram_logic_mw_per_core: float = 0.25  # buffer, MMR, SRAM, ACC
    router_mw: float = 0.50  # per router, TSMC 16nm-ish
    cp_w: float = 0.40  # co-processor + IO
    acam_mm2_per_core: float = 0.030  # 256x130 macro-cells + periph
    sram_logic_mm2_per_core: float = 0.006
    router_mm2: float = 0.002
    cp_mm2: float = 2.0

    def chip_power_w(self, spec: ChipSpec, active_cores: int | None = None) -> float:
        n = spec.n_cores if active_cores is None else active_cores
        return (
            n * (self.acam_mw_per_core + self.sram_logic_mw_per_core) / 1e3
            + spec.n_routers * self.router_mw / 1e3
            + self.cp_w
        )

    def chip_area_mm2(self, spec: ChipSpec) -> float:
        return (
            spec.n_cores * (self.acam_mm2_per_core + self.sram_logic_mm2_per_core)
            + spec.n_routers * self.router_mm2
            + self.cp_mm2
        )


@dataclass
class PerfReport:
    name: str
    latency_ns: float
    throughput_msps: float  # million samples / s
    energy_nj_per_dec: float
    power_w: float
    area_mm2: float
    bottleneck: str
    n_cores_used: int
    replication: int

    def as_row(self) -> dict:
        return {
            "name": self.name,
            "latency_ns": round(self.latency_ns, 2),
            "throughput_msps": round(self.throughput_msps, 2),
            "energy_nj_per_dec": round(self.energy_nj_per_dec, 4),
            "power_w": round(self.power_w, 2),
            "bottleneck": self.bottleneck,
            "cores": self.n_cores_used,
            "replication": self.replication,
        }


# ---------------------------------------------------------------------------
# X-TIME chip model
# ---------------------------------------------------------------------------


def core_throughput_msps(n_trees_core: int, spec: ChipSpec, n_samples: int = 10**6) -> float:
    """Eq. 4 / Eq. 5: pipelined core throughput.

    ≤4 trees/core: a new sample enters every λ_CAM cycles (Eq. 4, ~250 MS/s).
    >4 trees/core: the MMR needs N_B = N_trees,core iterations, inserting
    bubbles (Eq. 5, ~200 MS/s at 5 trees).
    """
    f_hz = spec.clock_ghz * 1e9
    if n_trees_core <= spec.lambda_cam:
        cycles = spec.lambda_core + spec.lambda_cam * (n_samples - 1)
    else:
        cycles = spec.lambda_core + n_trees_core * (n_samples - 1)
    return n_samples / (cycles / f_hz) / 1e6


def xtime_perf(
    table: CAMTable,
    placement: CorePlacement,
    noc: NoCPlan,
    *,
    spec: ChipSpec | None = None,
    power_area: PowerAreaSpec | None = None,
    batch: int = 1 << 20,
    io_overhead_cycles: int = 60,
) -> PerfReport:
    """Latency/throughput/energy for one model on one X-TIME chip.

    ``io_overhead_cycles`` covers chip ingress/egress + CP decision,
    calibrated so typical Table-II models land at the paper's ~100 ns
    latency (§V-A).
    """
    spec = spec or placement.spec
    pa = power_area or PowerAreaSpec()
    f_hz = spec.clock_ghz * 1e9

    # --- latency of a single sample (unbatched) ---
    # input broadcast: feature vector streams down the H-tree; queued arrays
    # receive ceil(F/65) sequential segments (§III-C input segmentation).
    # Physical columns only: compression-collapsed wildcard columns are
    # never broadcast, so the latency/throughput respond to the rewrite.
    seg = placement.n_feature_segments
    bcast_cycles = noc.n_levels + int(np.ceil(table.n_cols / spec.flit_bytes))
    core_cycles = spec.lambda_core + spec.lambda_cam * max(0, seg - spec.n_queued) // spec.n_queued
    mmr_extra = max(0, placement.max_trees_per_core - 1)  # sequential leaf reads
    noc_up_cycles = noc.n_levels + int(np.ceil(noc.flits_per_sample_per_level[-1])) - 1
    cp_cycles = noc.cp_ops_per_sample
    lat_cycles = (
        bcast_cycles + core_cycles + mmr_extra + noc_up_cycles + cp_cycles + io_overhead_cycles
    )
    latency_ns = lat_cycles / f_hz * 1e9

    # --- steady-state throughput ---
    tau_core = core_throughput_msps(placement.max_trees_per_core, spec, batch)
    # root link: 1 flit/cycle; multiclass forwards n_outputs flits/sample
    root_flits = noc.flits_per_sample_per_level[-1]
    tau_noc = f_hz / root_flits / 1e6
    # input broadcast: one feature segment (65 features) per cycle down the
    # tree; queued arrays consume n_queued segments in parallel per search.
    tau_in = f_hz / max(1.0, seg / spec.n_queued * spec.lambda_cam) / 1e6
    tau_chip = min(tau_core, tau_noc, tau_in)
    bottleneck = {tau_core: "core-pipeline", tau_noc: "noc-root", tau_in: "input-broadcast"}[
        tau_chip
    ]
    throughput = tau_chip * noc.replication  # input batching (§III-D)

    # --- power / energy ---
    active = placement.n_cores_used * noc.replication
    power = pa.chip_power_w(spec, active_cores=active)
    energy_nj = power / (throughput * 1e6) * 1e9
    area = pa.chip_area_mm2(spec)

    return PerfReport(
        name="x-time",
        latency_ns=latency_ns,
        throughput_msps=throughput,
        energy_nj_per_dec=energy_nj,
        power_w=power,
        area_mm2=area,
        bottleneck=bottleneck,
        n_cores_used=placement.n_cores_used,
        replication=noc.replication,
    )


# ---------------------------------------------------------------------------
# Kernel v2 memory-traffic model (DESIGN.md §10) — what compact dtypes and
# wildcard tile skipping buy on the TPU/CPU adaptation, as bytes.
# ---------------------------------------------------------------------------


def kernel_traffic_model(
    *,
    batch: int,
    rows: int,
    features: int,
    channels: int,
    table_dtype: str = "int32",
    tile_skip_fraction: float = 0.0,
    rows_saved: int = 0,
    cols_saved: int = 0,
) -> dict:
    """Bytes one cam_match call streams through VMEM, and its arithmetic
    intensity — the roofline inputs the autotuner's candidates move.

    ``rows``/``features`` are the COMPRESSED shapes actually streamed
    (pass ``CAMTable.n_rows``/``CAMTable.n_cols``); ``rows_saved`` /
    ``cols_saved`` carry what compression removed so the report can
    price the rewrite (``uncompressed_ratio``: table traffic the naive
    one-row-per-leaf layout would have streamed, relative to this one).
    ``table_dtype`` scales the threshold-table and query traffic (the low
    and high tables dominate: 2·R·F cells vs B·F queries).
    ``tile_skip_fraction`` discounts COMPARE OPS only: the v2 kernel's
    ``@pl.when`` guard skips the VPU work of an all-wildcard tile, but
    the BlockSpec pipeline still streams its blocks into VMEM — the
    bytes are spent either way (index-map-level skipping is future
    work).  Returns raw byte counts plus ``packed_ratio`` — table
    traffic relative to the v1 int32 layout (4.0 for uint8).
    """
    itemsize = np.dtype(table_dtype).itemsize
    live = 1.0 - tile_skip_fraction
    bytes_tables = 2 * rows * features * itemsize
    bytes_queries = batch * features * itemsize
    bytes_leaf = rows * channels * 4
    bytes_out = batch * channels * 4
    total = bytes_tables + bytes_queries + bytes_leaf + bytes_out
    compare_ops = 2.0 * batch * rows * features * live
    mac_ops = 2.0 * batch * rows * channels
    naive_tables = (
        2 * (rows + rows_saved) * (features + cols_saved) * itemsize
    )
    return {
        "bytes_tables": bytes_tables,
        "bytes_queries": bytes_queries,
        "bytes_leaf": bytes_leaf,
        "bytes_out": bytes_out,
        "bytes_total": total,
        "compare_ops": compare_ops,
        "mac_ops": mac_ops,
        "intensity_ops_per_byte": (compare_ops + mac_ops) / max(1.0, total),
        "packed_ratio": 4.0 / itemsize,
        "uncompressed_ratio": naive_tables / max(1, bytes_tables),
    }


# ---------------------------------------------------------------------------
# Booster (He et al., IPDPS'22) — digital LUT ASIC comparison (§V-B)
# ---------------------------------------------------------------------------


def booster_perf(
    table: CAMTable,
    placement: CorePlacement,
    noc: NoCPlan,
    *,
    depth: int,
    spec: ChipSpec | None = None,
    power_area: PowerAreaSpec | None = None,
    node_cycles: int = 4,
) -> PerfReport:
    """Same chip/NoC, LUT cores: O(D) node fetches per sample (4 cyc/node),
    new sample admitted every 4·D cycles (paper: throughput 1/4D)."""
    spec = spec or placement.spec
    pa = power_area or PowerAreaSpec()
    f_hz = spec.clock_ghz * 1e9

    traverse_cycles = node_cycles * depth
    bcast_cycles = noc.n_levels + int(np.ceil(table.n_cols / spec.flit_bytes))
    noc_up = noc.n_levels + int(np.ceil(noc.flits_per_sample_per_level[-1])) - 1
    lat_cycles = bcast_cycles + traverse_cycles + noc_up + noc.cp_ops_per_sample + 60
    tau_core = f_hz / traverse_cycles / 1e6  # 1/(4D) samples/clock
    tau_noc = f_hz / noc.flits_per_sample_per_level[-1] / 1e6
    tau = min(tau_core, tau_noc) * noc.replication
    power = pa.chip_power_w(spec, active_cores=placement.n_cores_used * noc.replication)
    return PerfReport(
        name="booster-model",
        latency_ns=lat_cycles / f_hz * 1e9,
        throughput_msps=tau,
        energy_nj_per_dec=power / (tau * 1e6) * 1e9,
        power_w=power,
        area_mm2=pa.chip_area_mm2(spec),
        bottleneck="lut-traversal" if tau_core < tau_noc else "noc-root",
        n_cores_used=placement.n_cores_used,
        replication=noc.replication,
    )


# ---------------------------------------------------------------------------
# GPU analytical model (V100 + RAPIDS FIL, §IV-C) — calibrated to the
# paper's measured range (latency 10 µs – 1 ms; Fig. 11 trends: linear in
# N_trees and D, flat in N_feat).
# ---------------------------------------------------------------------------


@dataclass
class GPUSpec:
    """V100 + FIL constants.

    ``node_visit_rate`` is the single calibrated parameter: effective
    (sample, tree, level) gathers per second under FIL's breadth-first
    interleaved layout.  8.22e10/s reproduces the paper's Churn-modelling
    measurement pair — ~0.98 ms batch latency and ~21 MS/s saturated
    throughput for 404 trees x depth 8 at a ~20 K saturation batch —
    which yields the 9740x / 119x headline comparison exactly.  The model
    keeps the paper's observed scaling: throughput prop. 1/(N_trees*D),
    flat in N_feat (Fig. 11), latency dominated by the saturated-batch
    sweep.
    """

    kernel_launch_us: float = 10.0  # fixed kernel + scheduling overhead
    node_visit_rate: float = 8.22e10  # gathers/s, memory-system bound
    saturation_batch: int = 20480  # batch at which throughput plateaus
    imbalance: float = 1.2  # tall-tree synchronization penalty (§II-B)


def gpu_perf_model(
    *,
    n_trees: int,
    depth: int,
    batch: int | None = None,
    gpu: GPUSpec | None = None,
) -> PerfReport:
    """Analytical V100 inference model for tree ensembles (§IV-C protocol:
    kernel time only, batch swept to saturation)."""
    g = gpu or GPUSpec()
    b = g.saturation_batch if batch is None else batch
    visits = float(b) * n_trees * max(1, depth) * g.imbalance
    sweep_us = visits / g.node_visit_rate * 1e6
    lat_us = g.kernel_launch_us + sweep_us
    throughput = b / (lat_us * 1e-6) / 1e6
    return PerfReport(
        name="gpu-model",
        latency_ns=lat_us * 1e3,
        throughput_msps=throughput,
        energy_nj_per_dec=250.0 / (throughput * 1e6) * 1e9,  # 250 W card
        power_w=250.0,
        area_mm2=815.0,
        bottleneck="memory-gather" if sweep_us > g.kernel_launch_us else "launch-overhead",
        n_cores_used=80,
        replication=1,
    )

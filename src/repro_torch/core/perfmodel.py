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

The chip model of ``repro.core.perfmodel`` (``PowerAreaSpec``,
``PerfReport``, ``core_throughput_msps``, ``xtime_perf``), copied so the port
assembles the same artifacts; the traffic, Booster and GPU models are not
ported yet.
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

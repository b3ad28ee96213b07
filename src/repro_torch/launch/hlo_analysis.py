"""Trip-count-aware HLO analysis for the roofline terms: the port's copy of
``repro.launch.hlo_analysis``.

A text parser of XLA's compiled HLO (``compiled.as_text()``, such as the
JAX package's dry-run output), so users of the port can analyse it
without JAX; it imports only ``re`` and numpy.  The parser gives the same
``HLOCost`` as the JAX package's on the same text:

  * every while loop's trip count from its condition region (XLA
    canonicalizes scan conditions to ``compare(iv, constant(N)), LT``),
    multipliers propagated through nested computations;
  * **dot FLOPs** per computation (recursing into fusion/call
    subcomputations) x trip multiplier;
  * **fusion-boundary bytes** (operands + results of top-level
    instructions, internal fusion values excluded) x multiplier;
  * **collective bytes** (all-gather / all-reduce / reduce-scatter /
    all-to-all / collective-permute operand sizes) x multiplier, per
    device (HLO shapes are already sharded under SPMD).

One deliberate difference: the roofline constants are one NVIDIA H100
SXM's, not a TPU's.  ``repro_torch.launch.dryrun`` feeds
``roofline_from_cost`` the cost it counts on the port's own eager program.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "token": 0, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*(.*)$")
_CALLED_RE = re.compile(r"(?:calls|body|condition|to_apply|branch_computations)=%?\{?([\w.\-, %]+)\}?")
_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute", "ragged-all-to-all")


def _shape_bytes(type_str: str) -> int:
    """Total bytes of possibly-tuple HLO type string."""
    total = 0
    for m in _SHAPE_RE.finditer(type_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _shape_dims(type_str: str) -> tuple[str, list[int]] | None:
    m = _SHAPE_RE.search(type_str)
    if not m:
        return None
    dims = [int(d) for d in m.group(2).split(",") if d] if m.group(2) else []
    return m.group(1), dims


@dataclass
class Instruction:
    name: str
    type_str: str
    opcode: str
    operands: list[str]
    raw: str


@dataclass
class Computation:
    name: str
    instructions: list[Instruction] = field(default_factory=list)
    by_name: dict = field(default_factory=dict)


def parse_hlo(text: str) -> dict[str, Computation]:
    comps: dict[str, Computation] = {}
    cur: Computation | None = None
    for line in text.splitlines():
        s = line.rstrip()
        if not s:
            continue
        # computation header: `%name (params...) -> type {`  or `ENTRY %name ...{`
        if s.endswith("{") and ("(" in s) and ("=" not in s.split("(")[0]):
            m = re.search(r"%([\w.\-]+)\s*\(", s)
            if m:
                cur = Computation(name=m.group(1))
                comps[cur.name] = cur
            continue
        if s.strip() == "}":
            cur = None
            continue
        if cur is None:
            continue
        mi = _INSTR_RE.match(s)
        if not mi:
            continue
        name, rest = mi.group(1), mi.group(2)
        # type is everything up to the opcode '(' — find `op(` after type
        mo = re.match(r"((?:\([^)]*\)|[\w\[\],{}\/ ]+?)*?)\s*([\w\-]+)\(", rest)
        if not mo:
            continue
        type_str, opcode = mo.group(1).strip(), mo.group(2)
        # operands: first parenthesized group after opcode
        paren = rest[mo.end() - 1:]
        depth = 0
        end = 0
        for i, ch in enumerate(paren):
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
                if depth == 0:
                    end = i
                    break
        operands = re.findall(r"%([\w.\-]+)", paren[: end + 1])
        inst = Instruction(name=name, type_str=type_str, opcode=opcode,
                           operands=operands, raw=s)
        cur.instructions.append(inst)
        cur.by_name[name] = inst
    return comps


def _trip_count(cond: Computation) -> int:
    """Scan conditions: compare(iv, constant(N)), direction=LT."""
    consts = {}
    for inst in cond.instructions:
        if inst.opcode == "constant":
            m = re.search(r"constant\((-?\d+)\)", inst.raw)
            if m:
                consts[inst.name] = int(m.group(1))
    # find the compare (possibly wrapped in a fusion) and take the constant
    for inst in cond.instructions:
        if "compare" in inst.raw or inst.opcode == "fusion":
            for op in inst.operands:
                if op in consts:
                    return max(1, consts[op])
    if consts:
        return max(1, max(consts.values()))
    return 1


@dataclass
class HLOCost:
    dot_flops: float = 0.0
    fusion_boundary_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_breakdown: dict = field(default_factory=dict)
    n_whiles: int = 0
    trip_counts: list[int] = field(default_factory=list)


def _dot_flops(inst: Instruction, comp: Computation) -> float:
    """2 x out_elems x contraction_size from the dot's dnums + lhs shape."""
    out = _shape_dims(inst.type_str)
    if out is None:
        return 0.0
    _, out_dims = out
    out_elems = float(np.prod(out_dims)) if out_dims else 1.0
    m = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", inst.raw)
    lhs = comp.by_name.get(inst.operands[0]) if inst.operands else None
    if m is None or lhs is None:
        return 2.0 * out_elems  # degenerate
    lshape = _shape_dims(lhs.type_str)
    if lshape is None:
        return 2.0 * out_elems
    _, ldims = lshape
    contract = 1.0
    for d in (int(x) for x in m.group(1).split(",") if x):
        if d < len(ldims):
            contract *= ldims[d]
    return 2.0 * out_elems * contract


def analyze(text: str) -> HLOCost:
    comps = parse_hlo(text)
    entry = None
    for name, c in comps.items():
        if name.startswith("main") or entry is None:
            if name.startswith("main"):
                entry = c
    if entry is None and comps:
        entry = next(iter(comps.values()))

    cost = HLOCost()
    visited_flops_cache: dict[str, tuple[float, float, dict]] = {}

    def comp_cost(cname: str, depth: int = 0) -> tuple[float, float, dict]:
        """(dot_flops, boundary_bytes, collective_bytes_by_kind) of one
        execution of computation `cname`, recursing into calls."""
        if cname in visited_flops_cache:
            return visited_flops_cache[cname]
        comp = comps.get(cname)
        if comp is None or depth > 50:
            return 0.0, 0.0, {}
        flops = 0.0
        bbytes = 0.0
        coll: dict[str, float] = {}
        for inst in comp.instructions:
            if inst.opcode == "while":
                body_m = re.search(r"body=%?([\w.\-]+)", inst.raw)
                cond_m = re.search(r"condition=%?([\w.\-]+)", inst.raw)
                trips = 1
                if cond_m and cond_m.group(1) in comps:
                    trips = _trip_count(comps[cond_m.group(1)])
                cost.n_whiles += 1
                cost.trip_counts.append(trips)
                if body_m and body_m.group(1) in comps:
                    f, b, c = comp_cost(body_m.group(1), depth + 1)
                    flops += f * trips
                    bbytes += b * trips
                    for k, v in c.items():
                        coll[k] = coll.get(k, 0.0) + v * trips
                continue
            if inst.opcode in ("conditional", "call", "custom-call"):
                for called in re.findall(r"(?:calls|branch_computations)=\{?%?([\w.\-]+)", inst.raw):
                    if called in comps:
                        f, b, c = comp_cost(called, depth + 1)
                        flops += f
                        bbytes += b
                        for k, v in c.items():
                            coll[k] = coll.get(k, 0.0) + v
            if inst.opcode == "dot":
                flops += _dot_flops(inst, comp)
            elif inst.opcode == "fusion":
                m = re.search(r"calls=%?([\w.\-]+)", inst.raw)
                if m and m.group(1) in comps:
                    f, _b, _c = comp_cost(m.group(1), depth + 1)
                    flops += f  # dots inside fusions count; bytes don't
            for kind in _COLLECTIVES:
                if inst.opcode == kind:
                    nbytes = sum(
                        _shape_bytes(comp.by_name[op].type_str)
                        for op in inst.operands
                        if op in comp.by_name
                    )
                    if nbytes == 0:  # fall back to result size
                        nbytes = _shape_bytes(inst.type_str)
                    coll[kind] = coll.get(kind, 0.0) + nbytes
            # fusion-boundary bytes: top-level instruction operands+result
            if inst.opcode in ("fusion", "dot", "convolution", "copy",
                               "transpose", "reshape", "dynamic-slice",
                               "dynamic-update-slice", "gather", "scatter",
                               "reduce", "broadcast", "concatenate", "sort",
                               *_COLLECTIVES):
                nbytes = _shape_bytes(inst.type_str)
                for op in inst.operands:
                    if op in comp.by_name:
                        nbytes += _shape_bytes(comp.by_name[op].type_str)
                bbytes += nbytes
        out = (flops, bbytes, coll)
        visited_flops_cache[cname] = out
        return out

    if entry is not None:
        f, b, c = comp_cost(entry.name)
        cost.dot_flops = f
        cost.fusion_boundary_bytes = b
        cost.collective_breakdown = c
        cost.collective_bytes = sum(c.values())
    return cost


# ---------------------------------------------------------------------------
# Roofline terms: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates at the
# 700 W limit; `nvidia-smi` names the card "NVIDIA H100 80GB HBM3, 700.00 W")
# ---------------------------------------------------------------------------

PEAK_FLOPS = 989e12  # dense bf16 FLOP/s per card
HBM_BW = 3.35e12  # HBM3 bytes/s per card
NVLINK_BW = 450e9  # NVLink bytes/s per direction per card: the collective term


@dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes_hbm: float
    bytes_collective: float
    model_flops: float = 0.0

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flop_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    def as_row(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "hlo_flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.bytes_hbm,
            "coll_bytes_per_dev": self.bytes_collective,
            "model_flops_ratio": round(self.useful_flop_ratio, 4),
        }


def roofline_from_cost(
    cost: HLOCost, *, model_flops_per_dev: float = 0.0
) -> RooflineTerms:
    """Three terms in seconds, per the assignment formulas.

    All quantities are per-device (SPMD HLO shapes are sharded), so the
    'chips x' denominators are already applied.
    """
    return RooflineTerms(
        compute_s=cost.dot_flops / PEAK_FLOPS,
        memory_s=cost.fusion_boundary_bytes / HBM_BW,
        collective_s=cost.collective_bytes / NVLINK_BW,
        flops=cost.dot_flops,
        bytes_hbm=cost.fusion_boundary_bytes,
        bytes_collective=cost.collective_bytes,
        model_flops=model_flops_per_dev,
    )

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
     unfused, at b256/r16384/f130/c8, a ragged small shape and tables
     2,048 and 8,192 features wide (past the staged query window), with
     each instance's launches; the soft kernel's per-term error: one-cell
     tables (F = 1) swept over x, computed and through the lattice table,
     each score within s(8u|ls| + 4u) + 2^-126 of float64;
  4. the main paths at the full width of xtime-tabular (4096 trees of
     depth 8, 130 features, 256 bins, 8 classes), each with the launch
     counts set to 0 just before it and read just after:
     hard: ``repro_torch.build`` -> ``CompiledModel.predict``/``raw_margin``
     at batch 1, 37, 256 and 1024, held to the host traversal and to the
     plain version, then save -> load -> predict;
     soft: ``build(deploy=DeployConfig(mode="soft", tau=0.1))`` ->
     ``raw_margin``/``raw_moments`` at tau = 0 (held to the host
     traversal, the m1 moments to the unfused margins),
     ``predict_proba`` and ``predict(return_uncertainty=True)`` — one
     launch, equal to ``predict`` and ``uncertainty`` apart bit for bit —
     at batch 1, 37 and 256 and ``raw_moments`` at batch 37 (held to the
     plain version), then save -> load -> ``predict_proba``;
  5. times with CUDA events at full width, each launch alone with the L2
     cache flushed before it (and back to back, warm, beside it), beside
     the least time the card could take: the main path's uint8/inclusive
     kernel at batch 256, 1 and 1024 (fused bias on and off), the uint16
     and int32 instantiations at batch 256 (int32 'inclusive' through
     ``cm.raw_margin(x, table_dtype="int32", mode="inclusive")``), the two
     instances no engine binds — uint8 and uint16 'direct' — on the full
     table (uint8 on it clipped to a 255-bin grid), the soft kernel at batch 1 and
     256 for tau 0 and 0.1 and its moments pass (C = 24) at batch 1 and
     256, tau = 0.1 at batch 256 once more with the lattice table off, and
     ``predict(return_uncertainty=True)``'s one launch at batch 256, each
     beside its plain version, beside what the design evaluates and beside
     the former design's recorded time (the uint8 and soft tau > 0 bounds
     are the redesigned kernels' counts, the former counts printed beside
     them);
     the cell lists' K, cells per row, bytes and host build time; soft
     bind time; peak device memory;
  6. the tiers on top of the engine, on the phase 4 artifacts (each with
     the launch counts set to 0 just before it and read just after):
     serving: ``TableRegistry`` -> ``ServeLoop(flush_rows=256)`` replaying
     a seeded trace of 2000 single-row requests at its pace (every result
     == ``cm.predict``), the single-row service latency (a flush per
     request), and a hot swap to the soft artifact under traffic (results
     after it == ``soft.predict``); cluster: ``ClusterServer(n_replicas=2)``
     on the same trace (== the ``ServeLoop`` results), then again with
     replica 1 crashed midway (every request completes, bit-equal, none
     shed); scoring: ``score_file`` of 262,144 seeded uint8 rows x 130 from
     an ``.npy`` in 16384-row chunks, double buffering on, off and on
     (== ``cm.predict`` in 1024-row batches); the traversal baseline at
     batch 1, 256 and 1024 (margins == the engine's), its time beside the
     CAM kernel's;
  7. models in (each run with the launch counts set to 0 just before it
     and read just after): the 8 golden dumps of tests/fixtures/ingest
     through ``build(path)`` == their records; the xtime-tabular ensemble
     exported by ``to_xgboost_json`` with float thresholds, built from the
     dump at 'off' and 'prune' (== the native ensemble and each other bit
     for bit at B = 1, 256, 1024; rows, K, cells a row and the host
     seconds of each step; the uint8 kernel's time at B = 256 and 1024;
     ``score_file`` on the 'prune' artifact); the paper-scale smoke shape
     (512 trees x depth 8, 32 features) at every level, bit-equal to
     'off', and soft tau = 0.1 on 'full' against its plain version; the
     degenerate tables compression leaves (one sentinel row, one column)
     against the plain version; ``random_search`` GBDT and RF winners on
     churn and a 3-round GBDT on gas, built at 'auto' and served, equal to
     ``Ensemble.predict``; a model 8,000 features wide (past every
     variant's staged query window) through every hard variant and the
     soft kernel and its moments pass, held to the traversal or the plain
     version and timed; xtime-tabular's 4,096 trees of depth 8 at the
     width of Bosch Production Line Performance (968 features, R =
     1,048,576) through ``raw_margin``/``predict`` at B = 1, 256 and 1,024
     in uint8/inclusive, uint16/inclusive, int32/direct and soft tau = 0,
     each on a cluster of blocks a tile, held to the traversal, the plain
     version and the lane-per-query walk (``walk=True``) bit for bit, and
     timed beside the walk;
  8. the operator's tools, on the phase 4 artifacts (launch counts set to
     0 just before the tuned path and read just after): ``autotune_kernel``
     at full width on batch 256 with buckets 1, 16 and 1024 (each layout's
     median per bucket, the spread of its (b_blk, r_blk) twins, the
     dispatch, the engines bound, its seconds); ``with_tuning`` -> save ->
     load, whose ``predict``/``raw_margin`` at batch 1, 16, 256 and 1024
     equal the untuned artifact's bit for bit, with each variant's
     launches and one engine for buckets sharing a winner; a JAX-style
     plan that applies no dispatch entry; the soft artifact's sweep at
     batch 256; the command lines as subprocesses on the card
     (``python -m repro_torch.cli.ingest --expected`` on the 8 golden
     dumps, ``cli.score --expected`` on xgb_deep, ``cli.ingest --autotune
     1,256``, the four examples, all at once; then ``cli.score
     --out`` of the saved tuned artifact over 262,144 uint8 rows, == 
     ``cm.predict``);
  9. the multi-device engine and checkpoint/restart, on the phase 4
     artifacts (launch counts set to 0 just before the mesh path and read
     just after): ``make_host_mesh(2, 4, devices=[card] * 8)`` — 8 logical
     shards of the card, one copy of the table on it (device bytes of an
     engine against one copy) — under accumulate, batch and hybrid
     (shard_map) and accumulate and batch (gspmd): ``cm.raw_margin`` /
     ``cm.predict(x, mesh=)`` at batch 1, 37, 256 and 1024, each call 8
     launches, == the single-device engine and ``Ensemble.raw_margin``; the
     median ms a call at batch 256 beside the single-device engine's; one
     accumulate call on a (4, 2) mesh with axes ("model", "data"); save ->
     load -> ``engine(mesh=)``; ``TableRegistry(mesh=)`` + ``ServeLoop`` and
     ``ClusterServer(mesh=, n_replicas=2)`` on the first 500 requests of
     phase 6's trace (== its results); ``score_file(mesh=)`` of phase 6's
     rows (== ``cm.predict``, rows/s beside phase 6's); then, with
     ``python -m repro_torch.tools.paper_scale_smoke`` and
     ``examples/torch_xtime_multichip.py`` running as subprocesses on the
     card: soft tau = 0.1 on the mesh (margins, ``predict_proba``,
     ``raw_moments``, uncertainty within the derived bound of the
     single-device engine; tau = 0 == the hard main path), and a checkpoint
     of CUDA tensors (float32, bfloat16, int64) restored onto the card and
     through a placer onto the mesh's devices, and a
     ``FaultTolerantRunner`` crashed and resumed on the card (== an
     uninterrupted run); and each program's dry-run hook: the ``fn`` of
     ``serve_step_for_dryrun()`` on ``input_specs(256)``-shaped queries ==
     ``engine.raw_margin`` bit for bit, 8 kernel launches a call;
 10. the LM half's serving path (no kernel of its own: the same torch ops
     as on the CPU), each model built from the port's seeded initialiser on
     the card and freed before the next: ``generate`` on llama3.2-3b at full
     width and depth (bfloat16, B = 4 prompts of 128 tokens, 32 new, greedy,
     twice and bit-equal) with the prefill ms, the decode ms a step (CUDA
     events), tokens/s and peak memory beside their bounds; the same model
     in float32, where the greedy run's last token is the argmax of
     ``prefill`` over prompt + generated[:-1] and that step's decode logits
     match it within 2e-3 of their largest; llama3.2-3b cut to depth 2 in
     float32, the card against the port on the CPU (prefill + 4
     teacher-forced decode steps, 1e-4, TF32 off); gemma3-1b (a 1,024-token
     prompt past its 512 window, 5:1 local:global, qk-norm, tied head,
     GeGLU, sandwich norms) and deepseek-v3 cut to depth 2 (1 dense + 1 MoE
     layer at full width: 256 experts top-8, MLA) timed the same way and
     checked decode against the full forward in float32 (deepseek at B = 1
     with room for every token in every expert); then the JAX package's
     recorded answers (tests/fixtures/torch_lm) for the smoke configs of
     llama3.2-3b, gemma3-1b, deepseek-v3 and llava-next replayed on the
     card from the same numpy seed (equal greedy tokens, logits within
     1e-4);
 11. the LM half's last three families, each built from the port's seeded
     initialiser on the card at full width and depth and freed before the
     next: zamba2-2.7b (54 mamba layers in 9 groups of 6 and the shared
     attention block) and rwkv6-1.6b (24 layers) through ``generate``,
     whisper-tiny (4 + 4 layers, 1,500 frames x 384 from a numpy seed,
     a 64-token decoder prompt) through ``prefill`` + ``decode_step``;
     bfloat16, B = 4, 32 new greedy tokens, twice and bit-equal, timed as
     phase 10 beside the decode bound (weights + state/cache bytes / HBM
     rate); a 4,096-token prompt at B = 1 for zamba2 and rwkv6 (32 SSD
     chunks of 128, 256 WKV chunks of 16): prefill ms and decode ms a
     step; decode against the full forward in float32 at full depth
     (225-token prompts: the forward over 256 positions takes two SSD
     chunks and the chunked WKV); the card against the port on the CPU in
     float32, TF32 off (zamba2 and rwkv6 cut to depth 2 — zamba2 one group
     of 2 mamba layers and the shared block — whisper whole); the JAX
     package's recorded answers for the three smoke configs.  Then the
     card's busy share and kernels a decode step (``torch.profiler``) of
     every phase 10 and 11 model, after all their timed runs;
 12. the LM half's training path (no kernel of its own), after phases
     10-11's models are freed: llama3.2-3b at full width and depth
     (bfloat16, remat, float32 moments) trained 6 steps by
     ``launch.train.make_train_step`` with the ``AdamWConfig`` ``train()``
     builds on ``TokenPipeline`` batches of 8 x 1,024 (``_chunked_ce``'s
     two 512-token chunks): losses and gradient norms finite, parameters
     changed, the ms a step (CUDA events, median of steps 2-6) beside
     ``model_flops`` / 989 TFLOP/s, the optimizer's ms alone, the card's
     busy share and kernels a step (``torch.profiler`` over 2 more steps),
     tokens/s and peak memory; 3 steps again from the seed with equal
     losses; llama3.2-3b cut to depth 2 in float32, one loss_fn + backward
     on the card against the port on the CPU (loss 1e-5, gradients 1e-4,
     TF32 off); one timed bfloat16 step after a first at full width of
     zamba2 (one group of 2 mamba layers + the shared block, 8 SSD chunks
     of 128), rwkv6 (2 layers) and whisper-tiny (whole, 1,500 frames),
     losses and gradient norms finite; deepseek-v3 left out (its float32
     moments alone outgrow the card); the JAX package's recorded training
     answers (tests/fixtures/torch_lm/train.json) replayed on the card;
     ``train()`` at ``_scaled(llama3.2-3b, 0.05)`` crashed after step 6 and
     resumed from its step-4 checkpoint, equal to an uninterrupted run;
 13. the LM mesh (no kernel of its own: the same torch ops plus device
     copies), on logical shards of the card: llama3.2-3b at full width cut
     to 8 layers, as phase 12 trains it otherwise, ``place_params`` onto a
     (4, 2) mesh
     (the bytes each shard holds == the specs' reckoning) and 3 steps of
     ``make_train_step(mesh=)``, the split program (ms a step beside one
     device's at that depth, the optimizer's 8 shard updates, the card's busy share
     and kernels a step over 1 more profiled step, tokens/s, peak), 2
     steps again from the seed with equal losses; llama3.2-3b cut to depth
     2 in float32, the mesh's first step within rtol 2e-4 of one device's;
     deepseek-v3 cut to depth 2 in float32 (16 experts, vocab 32,768,
     capacity 0.5) on a (2, 4) mesh, its first step within rtol 2e-4 of
     one device's and the same assignments dropped; zamba2-2.7b and
     rwkv6-1.6b cut to depth 2 in float32 on (4, 2), the split program
     (the scans by heads), and whisper-tiny whole on the split program too
     (its encoder over the frames, its decoder over the tokens): each
     first step against one device's, ms,
     kernels and peak of a step beside one device's, two runs equal; the
     flash-decode merge at gemma3-1b's decode widths over a 32,768-position
     cache on a (2, 4) mesh against ``decode_attention`` (1e-5 x scale,
     ms of both); the all-to-all MoE at deepseek-v3's widths (E 256, top-8,
     512 tokens, float32) on a (2, 4) mesh against ``moe_forward`` at cf
     16 (output, aux, the gradients of x, the router and the shared
     expert) and at cf 1.25 the dropped count, two runs equal, ms of both;
     then the split serve step (``launch.serve.MeshServe``) on a (2, 4)
     mesh: llama3.2-3b (KV heads on `model`, 4 greedy tokens) and
     gemma3-1b (sequence-sharded KV, 3 greedy tokens), zamba2-2.7b (the
     float32 SSM state by heads), rwkv6-1.6b (the WKV state by heads) and
     whisper-tiny (1,500 frames, a 64-token prompt, 4 greedy tokens: the
     cross cache's 6 KV heads by chunks of 375 frames) at full width and
     depth in bfloat16 (prefill and decode ms beside phase 10's or 11's,
     kernels a step, busy share, peak, cache bytes a shard ==
     ``cache_pspecs``'s leaf by leaf, greedy tokens agreeing with one
     device's, reported), and llama3.2-3b, gemma3-1b and deepseek-v3
     (``DEEPSEEK_CHECK``'s cut, decode capacity 0.5 so the decode drops
     too) at depth 2 in float32 against one device (every step's logits
     within 1e-4 of their scale, tokens and drops equal, two runs
     bit-equal, ``generate(mesh=)``'s tokens); llama3.2-3b at full depth
     teacher-forced on one device's 4 greedy tokens through
     ``teacher_forced(mesh=)``, float32 (every step's logits within 1e-4
     of their scale) and bfloat16 (its gap reported), zamba2-2.7b and
     rwkv6-1.6b likewise on 2 tokens in float32, whisper-tiny on 4 tokens
     after its 64-token prompt over 1,500 frames in float32;
 14. the dry run (``repro_torch.launch.dryrun``; no kernel of its own):
     llama3.2-3b as phase 12 trains it on a (1, 1) mesh of the card — the
     argument bytes the dry run reckons == the bytes of the parameters,
     moments, step and batch the card holds, its meta trace's dot FLOPs ==
     ``FlopCounterMode`` over one real ``make_train_step(mesh=)`` step, its
     bytes a device beside the next step's peak and its roofline bound
     beside that step's ms; then seven production cells on a 16 x 16 mesh
     of meta devices, each timed, each printing
     the reference's three lines and its fullest device's bytes, fit,
     dominant roofline term and ``n_compute_devices``, traced on the host
     by the dry run's command line while phase 13 runs on the card:
     llama3.2-3b and deepseek-v3-671b train_4k, deepseek-v3-671b
     decode_32k, llama3.2-3b prefill_32k, zamba2-2.7b and whisper-tiny
     decode_32k (device (0, M - 1) of the split program; zamba2's and
     whisper's also on the gathered program, beside it) and xtime-tabular
     serve_1m.

Every check that fails stops the run with a non-zero exit.  The last two
lines are a JSON object of the kernels and the contract line
``{"ok": true, "device": {...}}``.  Imports nothing of JAX or ``repro``.
"""

from __future__ import annotations

import contextlib
import copy
import gc
import importlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import repro_torch  # noqa: E402
from repro_torch.config import ShapeCell, get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    leaf_checksums,
    lm_params_from_numpy,
    seeded_numpy_params,
)
from repro_torch.core.engine import XTimeEngine  # noqa: E402
from repro_torch.core.precision import soft_inv  # noqa: E402
from repro_torch.core.compile import compile_ensemble  # noqa: E402
from repro_torch.core.trees import random_deep_ensemble  # noqa: E402
from repro_torch.kernels import cam_match as K  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.data import tokens as lm_tokens  # noqa: E402
from repro_torch.ft.runtime import InjectedFailure  # noqa: E402
from repro_torch.launch import model_flops as lm_flops  # noqa: E402
from repro_torch.launch import serve as lm_serve  # noqa: E402
from repro_torch.launch import train as lm_train  # noqa: E402
from repro_torch.models import common as lm_common  # noqa: E402
from repro_torch.models.common import leaf_tensors as lm_leaf_tensors  # noqa: E402
from repro_torch.models.common import tree_leaves as lm_tree_leaves  # noqa: E402
from repro_torch.models.common import tree_tensors as lm_tree_tensors  # noqa: E402
from repro_torch.optim import adamw as lm_adamw  # noqa: E402
from repro_torch.models import mamba2 as lm_mamba2  # noqa: E402
from repro_torch.models import moe as lm_moe  # noqa: E402
from repro_torch.models import registry as lm_registry  # noqa: E402
from repro_torch.models import transformer as lm_transformer  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models.attention import decode_attention as lm_decode_attention  # noqa: E402
from repro_torch.models.decode_opt import flash_decode_shardmap  # noqa: E402
from repro_torch.models.moe import MoEParams as LMMoEParams  # noqa: E402
from repro_torch.models.moe import moe_forward as lm_moe_forward  # noqa: E402
from repro_torch.models.moe_shardmap import make_shardmap_moe  # noqa: E402
from repro_torch.sharding import partition as lm_partition  # noqa: E402
from repro_torch.sharding import placement as lm_placement  # noqa: E402
from repro_torch.launch import dryrun as lm_dryrun  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

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
# shared memory serves 32 banks of 4 bytes a clock per SM (the same guide,
# shared memory), at the same SM count and clock
SMEM_WORDS_PER_CLOCK_PER_SM = 32
F32_EPS = ref.F32_EPS
# the former designs' recorded times (ms, L2 flushed, NVIDIA H100 80GB
# HBM3, 700.00 W) of the kernels this script times beside the redesigned
# ones: the lane-per-query uint8 kernel and the library log-sigmoid (PR
# 16's run 1), the lane-per-query uint16/int32 kernel and the tau = 0
# instance of the soft kernel (PR 23's run 7)
FORMER_MS = {("uint8", 1): 0.0819, ("uint8", 256): 1.3146, ("uint8", 1024): 5.0377,
             (0.1, 1, "margin"): 0.1809, (0.1, 256, "margin"): 5.2585,
             (0.1, 256, "moments"): 6.3947, (0.0, 1, "margin"): 0.1360,
             (0.0, 256, "margin"): 2.0859, ("uint16/inclusive", 256): 1.3940,
             ("int32/direct", 256): 1.5100, ("int32/inclusive", 256): 1.5096,
             ("int32/msb_lsb", 256): 1.8937, ("int32/two_cycle", 256): 1.9864,
             ("uint16/direct", 256): 1.3830}


def recorded(key) -> str:
    ms = FORMER_MS.get(key)
    return "former design not recorded" if ms is None else f"former design {ms:.4f} ms"


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


def smem_words_per_s() -> float:
    """4-byte shared-memory reads per second on this card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(smi("clocks.max.sm").split()[0])
    return SMEM_WORDS_PER_CLOCK_PER_SM * sms * mhz * 1e6


_TYPES = {"h": "uint8", "t": "uint16", "i": "int32", "f": "float32"}


def ptxas_report(log: str) -> list[str]:
    """One line per compiled kernel: registers, shared memory, spills."""
    lines, out = log.splitlines(), []
    for i, ln in enumerate(lines[:-2]):
        m = re.search(r"Function properties for (\S+)", ln)
        if not m:
            continue
        k = re.search(r"cam_match_kernelI([htif])NS_\d+(\w+?)ELb([01])EEEv", m.group(1))
        bk = re.search(r"cam_match_bp_kernelI([htif])NS_\d+(\w+?)ELb([01])EEEv", m.group(1))
        uk = re.search(r"cam_match_u8_kernelILb([01])ELb([01])E", m.group(1))
        sk = re.search(r"cam_match_soft_kernelILb([01])E", m.group(1))
        if uk:  # the bit-parallel kernels, one block a tile or a cluster
            name = (f"cam_match_u8<{'Inclusive' if uk.group(1) == '1' else 'Direct'}"
                    f"{', cluster' if uk.group(2) == '1' else ''}>")
        elif bk:  # value and rank routes
            name = (f"cam_match_bp<{_TYPES[bk.group(1)]}, {bk.group(2)}"
                    f"{', cluster' if bk.group(3) == '1' else ''}>")
        elif k:  # the lane-per-query kernel: lists past the tables' window
            wide = ", wide" if k.group(3) == "1" else ""
            name = f"cam_match<{_TYPES[k.group(1)]}, {k.group(2)}{wide}>"
        elif sk:
            name = f"cam_match_soft<tau>0{', wide' if sk.group(1) == '1' else ''}>"
        elif "live_tiles_kernel" in m.group(1):
            name = "live_tiles (float32 tiles' finite queries)"
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


# padded widths past the staged query window: of the int32 and soft
# variants at 2,048 (1,536 and 1,408 features fit), of every variant at 8,192
WIDE_WIDTHS = (2048, 8192)


def wide_problem(rng, f):
    """b40/r2048/f<f>/c3 on a 200-bin grid: 12 listed cells a row at
    random features, one of them among the last 512; every 4th row widened
    to hold a query.  The 32-query tile walks a row a warp, the 8-query
    tail a (row, query) pair a thread."""
    r, b, n_bins = 2048, 40, 200
    low = np.zeros((r, f), np.int32)
    high = np.full((r, f), n_bins, np.int32)
    q = rng.integers(0, n_bins, size=(b, f))
    for i in range(r):
        cols = rng.choice(f - 512, size=11, replace=False).tolist() + [int(rng.integers(f - 512, f))]
        lo = rng.integers(0, n_bins - 1, size=12)
        hi = np.minimum(n_bins, lo + rng.integers(1, n_bins // 2, size=12))
        if i % 4 == 0:
            lo, hi = np.minimum(lo, q[i % b, cols]), np.maximum(hi, q[i % b, cols] + 1)
        low[i, cols], high[i, cols] = lo, hi
    leaf = (rng.integers(-16, 17, size=(r, 3)) / 16.0).astype(np.float32)
    return dict(name=f"b{b}/r{r}/f{f}/c3", low=low, high=high, leaf=leaf, q=q,
                n_bins=n_bins, r_blk=256, f_blk=128)


def rank_problems(tree, rng):
    """The tree problem on a grid of 1,024 bins (its bounds x 4, so every
    query bin still matches one leaf a tree), its 32-query tiles
    alternating between bins below 256 (the value route) and bins up to
    1,023 (the rank route); and the same table with its listed int32
    bounds moved by up to +-3 (negative ones among them) and 1% of its
    listed cells made never-match (high <= low), as the defect injector
    leaves a table."""
    low, high = tree["low"] * 4, tree["high"] * 4
    b, f = tree["q"].shape
    q = rng.integers(0, 1024, size=(b, f))
    for t in range(0, b, 2 * K.QUERIES_PER_TILE):
        q[t:t + K.QUERIES_PER_TILE] = rng.integers(0, 256, size=q[t:t + K.QUERIES_PER_TILE].shape)
    wide = dict(tree, name=tree["name"] + " 1024 bins", low=low, high=high, q=q, n_bins=1024)
    listed = ~ops.wildcard_cells(low, high, n_bins=1024, inclusive=False)
    nlow = low + np.where(listed, rng.integers(-3, 4, size=low.shape), 0).astype(low.dtype)
    nhigh = high + np.where(listed, rng.integers(-3, 4, size=high.shape), 0).astype(high.dtype)
    bad = listed & (rng.random(low.shape) < 0.01)
    nhigh[bad] = nlow[bad]
    return wide, dict(wide, name=wide["name"] + " noisy", low=nlow, high=nhigh, int32_only=True)


def problems(rng, dev):
    """The shapes phase 3 holds every kernel variant to its plain version at."""
    tree = tree_problem(rng, dev)
    return (tree, ragged_problem(rng, dev), *(wide_problem(rng, f) for f in WIDE_WIDTHS),
            *rank_problems(tree, rng))


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


def ranked(cells: ops.CellList) -> ops.CellList:
    """The same list without its packed words: every tile of a uint16,
    int32 or float32 list then takes the rank route."""
    out = copy.copy(cells)
    object.__setattr__(out, "words", None)
    return out


def route_of(cells: ops.CellList, on_bins: bool = True) -> str:
    """The route a tile of this list takes: the bit-parallel kernels' value
    or rank route (on one block a tile or a cluster), or the lane-per-query
    kernel past a cluster's windows."""
    kernel, _ = K.kernel_route(cells)
    if kernel == "lanes":
        return "lanes"
    value = cells.words is not None and ops.packing(cells) is not None and on_bins
    return "value" if value else "rank"


def blocks_a_tile(cells: ops.CellList) -> str:
    """How many blocks serve a 32-query tile of this list (`kernel_route`)."""
    kernel, n = K.kernel_route(cells)
    return "the lane-per-query kernel" if kernel == "lanes" else (
        "one block a tile" if n == 1 else f"a cluster of {n} blocks a tile")


def routes(q: torch.Tensor, cells: ops.CellList) -> str:
    """Which route each 32-query tile of a uint16/int32/float32 list takes
    (the kernel's own test, mirrored): value tiles / rank tiles, or the
    lane-per-query kernel past the rank tables' window."""
    if route_of(cells) == "lanes":
        return "lane-per-query"
    tiles = [q[t:t + K.QUERIES_PER_TILE, : max(1, cells.span)].double()
             for t in range(0, q.shape[0], K.QUERIES_PER_TILE)]
    value = sum(route_of(cells, bool(((x >= 0) & (x <= 255) & (x == torch.round(x))).all()))
                == "value" for x in tiles)
    return f"{value} value / {len(tiles) - value} rank tiles"


def phase_kernel(dev, stats) -> None:
    rng = np.random.default_rng(SEED)
    launched = {}
    for p in problems(rng, dev):
        normal = rng.normal(size=p["leaf"].shape).astype(np.float32)
        normal[p["leaf"] == 0] = 0.0  # keep the class routing of each row
        int32_out = {}
        for dtype, mode, incl in VARIANTS:
            if (dtype == "uint8" and p["n_bins"] > 256) or (p.get("int32_only")
                                                              and dtype != "int32"):
                continue
            dyadic = operands(p, dtype, incl, p["leaf"], dev)
            if dyadic is None:
                continue
            q, lo, hi, lm, cells = dyadic
            _, _, _, lm_n, _ = operands(p, dtype, incl, normal, dev)
            before = K.cam_match_cuda.launches + K.cam_match_bits_cuda.launches
            bias = torch.full((1, lm.shape[1]), 0.3125, device=dev)
            bits_ref = ref.cam_match_bits_ref(q, lo, hi, mode=mode)
            out_ref = ref.cam_match_ref(q, lo, hi, lm, mode=mode)
            out_ref_n = ref.cam_match_ref(q, lo, hi, lm_n, mode=mode)
            lists = (cells, widened(cells, WIDE_K), *(() if dtype == "uint8" else (ranked(cells),)))
            for cl in lists:
                bits = K.cam_match_bits_cuda(q, cl, mode=mode)
                out = K.cam_match_cuda(q, cl, lm, mode=mode)
                again = K.cam_match_cuda(q, cl, lm, mode=mode)
                fused = K.cam_match_cuda(q, cl, lm, bias, mode=mode)
                out_n = K.cam_match_cuda(q, cl, lm_n, mode=mode)
                fused_n = K.cam_match_cuda(q, cl, lm_n, bias, mode=mode)
                torch.cuda.synchronize()
                tag = f"{p['name']} {dtype}/{mode} K={cl.k}{'' if cl.words is not None else ' ranked'}"
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
            launched[dtype, mode] = launched.get((dtype, mode), 0) + (
                K.cam_match_cuda.launches + K.cam_match_bits_cuda.launches - before)
            how = "" if dtype == "uint8" else (f", without its words (every tile ranked); "
                                               f"as built: {routes(q, cells)}")
            print(f"kernel {p['name']} {dtype}/{mode}: bits, k/16 margins, "
                  f"fused bias, cell list K={cells.k} and widened to {WIDE_K}{how}, rerun "
                  f"exact; normal leaves "
                  f"within 2(n+splits)·u·Σ|leaf| (max |err| so far "
                  f"{stats['max_abs_err']:.3g})", flush=True)
    print("kernel launches in this phase, by instance: " + ", ".join(
        f"{d}/{m} {n}" for (d, m), n in launched.items()), flush=True)


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
    tree, ragged, *rest = problems(rng, dev)
    for p in (tree, perturb(ragged, rng), *rest[: len(WIDE_WIDTHS)]):
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
            ranks = (ranked(cells),) if tau == 0.0 else ()  # the words serve tau = 0 alone
            for cl in (cells, widened(cells, WIDE_K), *ranks):
                tag = f"{p['name']} soft tau={tau} K={cl.k}{'' if cl.words is not None else ' ranked'}"
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
                  f"to {WIDE_K}"
                  + (f", without its words (every tile ranked; as built: {routes(q, cells)})"
                     if tau == 0.0 else "") + ", fused bias, rerun, "
                  f"never-match rows 0, no NaN; "
                  + ("scores, k/16 + moments margins exact; normal margins within "
                     "2(n+splits+2)u·Σ|s·leaf|; all == int32 direct kernel bit for bit"
                     if tau == 0.0 else
                     f"scores within s(2(F+8)u|ln s| + 8u) + 2^-126 (F = {f_pad}), margins "
                     f"and moments within that through |leaf| + 2(n+splits+2)u·Σ|s·leaf| "
                     f"(max |err| normal margins so far {stats['soft_max_abs_err']:.3g}, "
                     f"worst err/bound {worst:.3g})"), flush=True)
    soft_odd_queries(tree, rng, dev)
    one_cell_sweep(dev)


ODD_QUERIES = (float("nan"), float("inf"), -float("inf"), 2.5, -1.0, 300.0, -0.0)


def soft_odd_queries(p, rng, dev) -> None:
    """tau = 0 on the tree problem with 2% of two tiles' entries NaN,
    +-inf, a half bin, -1, 300 or -0: scores and the k/16 and moments
    margins equal the plain version bit for bit, with the list's words and
    without them; a query with a NaN or infinite feature scores 0 on every
    row (every cell, a wildcard too, compares false against it)."""
    q, lo, hi, lm, cells = soft_operands(p, p["leaf"], dev)
    odd = torch.tensor(ODD_QUERIES, device=dev)
    for t in (1, 3):
        tile = q[t * K.QUERIES_PER_TILE:(t + 1) * K.QUERIES_PER_TILE]
        pick = torch.from_numpy(rng.random(tuple(tile.shape)) < 0.02).to(dev)
        tile[pick] = odd[torch.from_numpy(rng.integers(0, len(ODD_QUERIES),
                                                       size=int(pick.sum()))).to(dev)]
    mom = moments_matrix(lm)
    s_ref = ref.soft_scores_ref(q, lo, hi, tau=0.0)
    plain = {name: ref.cam_match_ref(q, lo, hi, leaf, mode="soft", tau=0.0)
             for name, leaf in (("k/16", lm), ("moments", mom))}
    dead = ~torch.isfinite(q).all(dim=1)
    if not dead.any() or bool(s_ref[dead].any()):
        fail("odd soft queries: no non-finite query, or one the plain version matched")
    for cl in (cells, ranked(cells)):
        tag = f"{p['name']} soft tau=0 odd queries{'' if cl.words is not None else ' ranked'}"
        if not torch.equal(K.soft_scores_cuda(q, cl, tau=0.0), s_ref):
            fail(f"{tag}: scores differ from the plain version")
        for name, leaf in (("k/16", lm), ("moments", mom)):
            if not torch.equal(K.cam_match_soft_cuda(q, cl, leaf, tau=0.0), plain[name]):
                fail(f"{tag}: {name} margins differ from the plain version")
    print(f"kernel {p['name']} soft tau=0, 2% of tiles 1 and 3 NaN/+-inf/2.5/-1/300/-0 "
          f"({int(dead.sum())} queries with a non-finite feature): scores, k/16 and moments "
          f"margins == the plain version bit for bit, with the words and without "
          f"(as built: {routes(q, cells)})", flush=True)


def one_cell_table(bounds: np.ndarray, side: str, dev) -> ops.CellList:
    """A table one feature wide (the smallest width the kernel takes), one
    listed cell a row: lower bound ``bounds[r]`` (upper +inf), or upper
    bound ``bounds[r]`` (lower -inf)."""
    r = bounds.shape[0]
    b = bounds.astype(np.float32)[:, None]
    inf = np.full_like(b, np.inf)
    lo, hi = (b, inf) if side == "lo" else (-inf, b)
    return ops.CellList(np.ones(r, np.int32), np.zeros((r, 1), np.uint16), lo, hi, 1).to(dev)


def log_sigmoid64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64)
    return np.minimum(x, 0.0) - np.log1p(np.exp(-np.abs(x)))


def one_cell_sweep(dev) -> float:
    """The soft kernel's per-term error on the card: one-cell tables swept
    over x, query 0, each side, through the computed log-sigmoid (tau = 1,
    x dense in [-104, 104] with +-0 and subnormals) and the lattice table
    (half-integer bounds, tau = 1, 0.1, 0.37).  Each score expf(ls) is
    held to the budget against float64: |s - s64| <= s64 (8u |ls| + 4u) +
    2^-126 (8u a log-score, expf's 2 ulp).  Returns the worst err/budget."""
    rng = np.random.default_rng(SEED + 30)
    grid = np.concatenate([np.linspace(-104, 104, 1 << 20), rng.uniform(-104, 104, 1 << 18),
                           [0.0, -0.0, 1e-40, -1e-40, 1e-45, -1e-45, 2.0 ** -126]])
    half = np.arange(-255.5, 256.0, 1.0)
    worst = 0.0
    q = torch.zeros((1, 1), dtype=torch.float32, device=dev)
    for path, tau, xs in (("computed", 1.0, grid), ("lattice", 1.0, half),
                          ("lattice", 0.1, half), ("lattice", 0.37, half)):
        inv = soft_inv(tau)
        for side in ("lo", "hi"):
            bounds = -xs if side == "lo" else xs  # q - lo = x, hi - q = x
            cells = one_cell_table(bounds, side, dev)
            if cells.lattice != (path == "lattice"):
                fail(f"one-cell {path} table: lattice flag {cells.lattice}")
            s = K.soft_scores_cuda(q, cells, tau=tau)[0].double().cpu().numpy()
            x = xs.astype(np.float32) * np.float32(inv)  # the kernel's argument, exactly
            ls = log_sigmoid64(x)
            s64 = np.exp(ls)
            lim = s64 * (8 * F32_EPS * np.abs(ls) + 4 * F32_EPS) + ref.F32_TINY
            err = np.abs(s - s64)
            if np.isnan(s).any() or bool((err > lim).any()):
                i = int(np.argmax(err / lim))
                fail(f"one-cell {path} tau={tau} {side}: x={x[i]!r} score {s[i]!r} vs "
                     f"{s64[i]!r} over the per-term budget")
            worst = max(worst, float((err / lim).max()))
    print(f"kernel soft one-cell sweep (F = 1): computed log-sigmoid over {grid.size} x in "
          f"[-104, 104] and the lattice table at tau 1, 0.1, 0.37, both sides: scores "
          f"within s(8u|ls| + 4u) + 2^-126 of float64, worst err/budget {worst:.3g}",
          flush=True)
    return worst


# -- phase 4: the main path at full width -------------------------------------


def phase_main_path(dev, stats):
    t0 = time.perf_counter()
    xt = get_config("xtime-tabular")
    ens = random_deep_ensemble(n_trees=xt.n_trees, depth=xt.max_leaves.bit_length() - 1,
                               n_features=xt.n_features, n_bins=xt.n_bins, task=xt.task,
                               n_classes=xt.n_classes, seed=SEED)
    t1 = time.perf_counter()
    cm = repro_torch.build(ens)
    t2 = time.perf_counter()
    print(f"main path: {xt.name} {xt.n_trees} trees x depth "
          f"{xt.max_leaves.bit_length() - 1}, {xt.n_features} features, {xt.n_classes} "
          f"classes -> {cm.table.n_rows} CAM rows; ensemble {t1 - t0:.1f} s, build "
          f"{t2 - t1:.1f} s (host)", flush=True)
    rng = np.random.default_rng(SEED + 2)
    batches = {b: rng.integers(0, xt.n_bins, size=(b, xt.n_features)).astype(np.uint8)
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
        if not np.isfinite(margins[b]).all() or margins[b].shape != (b, xt.n_classes):
            fail(f"batch {b}: margins not finite of shape ({b}, {xt.n_classes})")
    # the plain version on the card, all rows
    a = eng.arrays
    for b, x in batches.items():
        qp = eng._prep_queries(x)
        plain = ref.cam_match_ref(qp, a.low, a.high, a.leaf, mode=eng.kernel_mode)
        plain = (plain + eng._bias)[:, :xt.n_classes].cpu().numpy()  # the separate epilogue
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
    proba, pred, unc = {}, {}, {}
    for b in (1, 37, 256):
        x = batches[b]
        proba[b] = soft.predict_proba(x)
        pred[b], unc[b] = soft.predict(x, return_uncertainty=True)  # one launch
        expected += 2
        if proba[b].shape != (b, 8) or not np.isfinite(proba[b]).all():
            fail(f"soft batch {b}: predict_proba not finite of shape ({b}, 8)")
        if not np.allclose(proba[b].sum(axis=1), 1.0, rtol=0, atol=1e-5):
            fail(f"soft batch {b}: predict_proba rows do not sum to 1 within 1e-5")
        if not (np.isfinite(unc[b]).all() and (unc[b] >= 0).all() and unc[b].shape == (b,)):
            fail(f"soft batch {b}: uncertainties not finite and >= 0")
        if not np.array_equal(pred[b], proba[b].argmax(axis=1)):
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
          f"raw_moments; tau={SOFT_TAU}: predict_proba + predict(return_uncertainty=True), "
          f"one launch, at B = 1, 37, 256, and raw_moments at B = 37); tau=0 margins == "
          f"Ensemble.raw_margin "
          f"(64 rows) == hard path (all rows), "
          f"mass channels sum to {cm.table.n_trees}; proba rows sum to 1, "
          f"uncertainties finite >= 0; bind {stats['soft_bind_s']:.1f} s host "
          f"(tau=0 engine {stats['soft_bind0_s']:.1f} s)", flush=True)

    # the one-launch uncertainty path == predict and uncertainty apart, bit
    # for bit (comparison launches, after the count)
    for b in (1, 37, 256):
        apart = eng.uncertainty(batches[b]).numpy()
        apart = apart[np.arange(b), pred[b].astype(np.int64)]
        if not (np.array_equal(pred[b], soft.predict(batches[b]))
                and np.array_equal(unc[b], apart)):
            fail(f"soft batch {b}: predict(return_uncertainty=True) differs from predict "
                 f"and uncertainty apart")
    print("soft path: predict(return_uncertainty=True) (one launch) == predict and "
          "uncertainty apart (two launches), bit for bit, at B = 1, 37, 256", flush=True)

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


_BINDING_BOUNDS: dict[int, int] = {}


def binding_bounds(eng: XTimeEngine) -> int:
    """Bounds that constrain a query: low > 0 or high < n_bins, on the
    compiled table (counted once a table: every variant's engine shares
    it).  A wildcard side needs no compare."""
    t = eng.table
    if id(t) not in _BINDING_BOUNDS:
        _BINDING_BOUNDS[id(t)] = int((t.low > 0).sum()) + int((t.high < t.n_bins).sum())
    return _BINDING_BOUNDS[id(t)]


def listed_cells(cells: ops.CellList) -> int:
    """Cells the kernels evaluate a query against: each row's count, the
    ELL padding past it excluded."""
    return int(cells.count.sum())


def list_bytes(cells: ops.CellList) -> tuple[int, int]:
    """Bytes of the cell list: the listed cells and counts (what a kernel
    must read: a packed word a cell where the list has them), and as
    stored with its ELL padding."""
    per_cell = cells.feat.element_size() + 2 * cells.lo.element_size()
    R, K = cells.feat.shape
    least = 4 if cells.words is not None else per_cell
    return listed_cells(cells) * least + 4 * R, (K * per_cell + 4) * R


# operations of a rank-route cell and 32-query tile: two six-step binary
# searches (a shared read, a compare and an add a step), two lookups, an AND
RANK_CELL_OPS = 39


def design_ops(cells: ops.CellList, batch: int, n_matched: int, route: str) -> int:
    """Operations the route evaluates: per listed cell and 32-query tile
    the value route's two lookups and an AND, or the rank route's
    RANK_CELL_OPS, and its tables (257 or 65 words a listed feature and
    tile); the lane-per-query kernel two compares per listed cell and
    query; one add per matched row and query either way."""
    tiles, listed = -(-batch // K.QUERIES_PER_TILE), listed_cells(cells)
    if route == "value":
        return tiles * (3 * listed + 257 * cells.span) + n_matched
    if route == "rank":
        return tiles * (RANK_CELL_OPS * listed + 65 * cells.span) + n_matched
    return 2 * batch * listed + n_matched


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


def bound_ms(eng: XTimeEngine, batch: int, n_matched: int, distinct: int,
             route: str | None = None) -> tuple[float, str, float, float]:
    """Least time for one cam_match call on this data: the bytes the
    cell-list kernel must read and write, each once — the listed cells
    (their packed words, where the list has them) and counts, the distinct
    matched leaf rows, the queries and the outputs — at HBM rate, against
    the fewest operations a design shown so far needs, at the 32-bit lane
    rate: the lesser of the value route's count (``design_ops``, where the
    list has words within the value tables' window; the queries here are
    bins) and the former count, the compare and AND per binding bound and
    query of the lane-per-query design, plus the adds.  Third: the time of
    what the kernel evaluates on the route it takes (``route``, default the
    list's own); fourth: the former count, which the bit-parallel design
    beats."""
    a = eng.arrays
    item = np.dtype(eng.table_dtype).itemsize
    nbytes = (list_bytes(a.cells)[0] + distinct * a.c_pad * 4 + batch * a.f_pad * item
              + batch * a.c_pad * 4)
    n_ops = 2 * batch * binding_bounds(eng) + n_matched
    former = n_ops / INT32_OPS_PER_S * 1e3
    if route_of(a.cells) == "value":
        n_ops = min(n_ops, design_ops(a.cells, batch, n_matched, "value"))
    design = design_ops(a.cells, batch, n_matched, route or route_of(a.cells))
    design = design / INT32_OPS_PER_S * 1e3
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, n_ops / INT32_OPS_PER_S * 1e3
    return (*((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")), design,
            former)


# (label, engine overrides) timed at full width; the first is the main path
TIMED = [
    ("uint8/inclusive", {}),
    ("uint16/inclusive", {"table_dtype": "uint16"}),
    ("int32/direct", {"table_dtype": "int32"}),
    ("int32/inclusive", {"table_dtype": "int32", "mode": "inclusive"}),
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

    rows, variant_launches = {}, {}
    main_256 = cm.raw_margin(batches[256])
    for label, overrides in TIMED:
        if overrides:  # this variant's path: cm.raw_margin(x, **overrides)
            reset_launches()
            if not np.array_equal(cm.raw_margin(batches[256], **overrides), main_256):
                fail(f"{label}: margins differ from the main path's")
            variant_launches[label] = counted(label)
        eng = cm.engine(**overrides)
        for b in ((256, 1, 1024) if not overrides else (256,)):
            qp = eng._prep_queries(batches[b])
            fn = launcher(eng, qp)
            ms = cold_time(fn, 20 if b == 1 else 10)
            warm = sync_time(fn, 50 if b == 1 else 10)
            plain_ms = plain(eng, qp)
            bnd, by, design, former = bound_ms(eng, b, *match_stats(eng, qp))
            rows[label, b] = (ms, plain_ms, bnd, by)
            key = ("uint8", b) if label == "uint8/inclusive" else (label, b)
            how = (f"the bit-parallel design's {design:.4f} ms of lookups "
                   f"({route_of(eng.arrays.cells)} route); former count, a compare and an "
                   f"AND per binding bound and query: {former:.4f} ms; {recorded(key)}")
            print(f"times [{name}] cam_match {label} B={b} (R={eng.arrays.r_pad}, "
                  f"F_pad={eng.arrays.f_pad}, K={eng.arrays.cells.k}): kernel {ms:.4f} ms "
                  f"L2 flushed (warm {warm:.4f} ms), plain {plain_ms:.3f} ms, bound "
                  f"{bnd:.4f} ms by {by} ({bnd / ms:.1%} of bound); {how}", flush=True)
        if not overrides:
            cell_list_line(name, label, eng)
    # the rank route on the same calls: each list without its words
    for label in ("int32/direct", "int32/msb_lsb"):
        eng = cm.engine(**dict(TIMED)[label])
        qp = eng._prep_queries(batches[256])
        a = eng.arrays
        rk = ranked(a.cells)
        fn = lambda: K.cam_match_cuda(qp, rk, a.leaf, eng._bias,  # noqa: E731
                                      mode=eng.kernel_mode)
        if not torch.equal(fn(), launcher(eng, qp)()):
            fail(f"{label}: the rank route's margins differ from the value route's")
        ms = cold_time(fn, 10)
        bnd, by, design, former = bound_ms(eng, 256, *match_stats(eng, qp), route="rank")
        print(f"times [{name}] cam_match {label} B=256, rank route (the list's words dropped): "
              f"== the value route's margins; kernel {ms:.4f} ms L2 flushed (value route "
              f"{rows[label, 256][0]:.4f}), bound {bnd:.4f} ms by {by}; the rank route's "
              f"count {design:.4f} ms; former count {former:.4f} ms; "
              f"{recorded((label, 256))}", flush=True)
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
    stats["kernel_line"] = kernel_entry("cam_match", "cam_match.cu", stats["launches"],
                                        stats["max_abs_err"], ms, plain_ms, bnd, by)
    stats["variant_lines"] = [
        kernel_entry(f"cam_match[{label}]", "cam_match.cu", variant_launches[label],
                     stats["max_abs_err"], *rows[label, 256])
        for label, overrides in TIMED if overrides]
    print(f"times [{name}] variant paths cm.raw_margin(x, **overrides) at B=256 == the main "
          f"path's margins; launches {variant_launches}", flush=True)


def phase_direct_packed_times(cm, batches, name) -> None:
    """The two instances no engine binds — uint8 and uint16 with exclusive
    upper bounds ('direct'), which phase 3 alone launches — at full width,
    B = 256, against the plain version: uint16 on the main path's table,
    uint8 on it clipped to a 255-bin grid (an exclusive bound of 256 does
    not fit uint8; the clip leaves the shape and nearly every cell)."""
    t = cm.table
    for dtype, n_bins in (("uint16", t.n_bins), ("uint8", t.n_bins - 1)):
        low, high = np.minimum(t.low, n_bins - 1), np.minimum(t.high, n_bins)
        lo, hi, lm = ops.pad_tables(low, high, t.leaf_matrix(), r_blk=256, f_blk=128,
                                    n_bins=n_bins)
        lo, hi = lo.astype(dtype), hi.astype(dtype)
        cells = ops.binding_cells(lo, hi, n_bins=n_bins, inclusive=False,
                                  n_real_rows=t.n_rows).to("cuda")
        qp = ops.pad_queries(np.minimum(batches[256], n_bins - 1), lo.shape[1], dtype=dtype,
                             device="cuda")
        lo_d, hi_d, lm_d = (torch.from_numpy(a).cuda() for a in (lo, hi, lm))
        fn = lambda: K.cam_match_cuda(qp, cells, lm_d, mode="direct")  # noqa: E731
        plain = lambda: ref.cam_match_ref(qp, lo_d, hi_d, lm_d, mode="direct")  # noqa: E731
        if not torch.equal(fn(), plain()):
            fail(f"{dtype}/direct at full width: margins differ from the plain version")
        ms, warm = cold_time(fn, 10), sync_time(fn, 10)
        plain_ms = sync_time(plain, 2, warmup=1)
        shim = SimpleNamespace(  # what bound_ms and match_stats read of an engine
            arrays=SimpleNamespace(cells=cells, c_pad=lm.shape[1], f_pad=lo.shape[1],
                                   r_pad=lo.shape[0]),
            table_dtype=dtype, kernel_mode="direct",
            table=SimpleNamespace(low=low, high=high, n_bins=n_bins))
        bnd, by, design, former = bound_ms(shim, 256, *match_stats(shim, qp))
        print(f"times [{name}] cam_match {dtype}/direct B=256 (R={lo.shape[0]}, "
              f"F_pad={lo.shape[1]}, K={cells.k}, {n_bins} bins"
              f"{', clipped' if n_bins < t.n_bins else ''}): == plain version; kernel "
              f"{ms:.4f} ms L2 flushed (warm {warm:.4f} ms), plain {plain_ms:.3f} ms, bound "
              f"{bnd:.4f} ms by {by} ({bnd / ms:.1%} of bound); the design's count "
              f"{design:.4f} ms ({route_of(cells)} route); former count {former:.4f} ms; "
              f"{recorded((f'{dtype}/direct', 256))}; launched by phase 3 only", flush=True)
        del cells, lo_d, hi_d, lm_d


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
                  sfu: float, distinct: int,
                  route: str | None = None) -> tuple[float, str, float, float]:
    """Least time for one soft kernel call on this data.  Bytes: the listed
    cells (at tau = 0 their packed words, where the list has them) and
    counts, the leaf rows the call needs (the ``distinct`` matched rows at
    tau = 0; every table row at tau > 0), the queries and the outputs,
    each once.  Operations at tau = 0: the lesser of the bit-parallel value
    route's count (``design_ops``) and the former count, a compare and an
    AND per finite bound and query, plus one add per matched row and query
    (one per tree), at the 32-bit lane rate.  At tau > 0 the fewest a design
    shown so far needs, the lattice design's (cam_match_soft.cu): per
    finite bound and query an add forming the table index and an add into
    the row sum at the lane rate and one table read at the shared-memory
    rate, one ex2 per table row and query at the SFU rate ``sfu``, an FMA
    per score and nonzero leaf entry at the float32 rate; each pipe timed
    alone, the longest taken.  Third: the time of what the design evaluates
    at the same rates (at tau = 0 the route's count, ``route`` default the
    list's own; at tau > 0 two table reads per listed cell and query);
    fourth: the former count (at tau > 0 an ex2 and an lg2 per finite bound
    and query and an ex2 per row and query on the SFU, the library
    log-sigmoid's)."""
    a, t = eng.arrays, eng.table
    c = leaf.shape[1]
    rows = distinct if tau == 0.0 else t.n_rows
    listed_bytes = list_bytes(a.cells)[0] if tau == 0.0 else list_bytes(ranked(a.cells))[0]
    nbytes = listed_bytes + rows * c * 4 + batch * a.f_pad * 4 + batch * c * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    n_fin, adds = finite_bounds(eng), batch * t.n_trees
    if tau == 0.0:
        former = (2 * batch * n_fin + adds) / INT32_OPS_PER_S * 1e3
        value = design_ops(a.cells, batch, adds, "value") / INT32_OPS_PER_S * 1e3
        t_ops = min(former, value) if route_of(a.cells) == "value" else former
        design = design_ops(a.cells, batch, adds, route or route_of(a.cells))
        design = design / INT32_OPS_PER_S * 1e3
    else:
        smem = smem_words_per_s()
        fma = 2 * batch * int((leaf != 0).sum()) / F32_FLOPS_PER_S * 1e3
        lane = 2 * batch * n_fin / INT32_OPS_PER_S * 1e3
        reads = batch * n_fin / smem * 1e3
        exps = batch * t.n_rows / sfu * 1e3
        t_ops = max(lane, reads, exps, fma)
        design = max(2 * batch * listed_cells(a.cells) / smem * 1e3, exps)
        former = max(batch * (2 * n_fin + t.n_rows) / sfu * 1e3, fma)
    return (*((t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")), design,
            former)


def phase_soft_times(soft, batches, name, stats) -> None:
    sfu, how = sfu_per_s()
    eng = soft.engine()
    rows = {}
    for tau in (0.0, SOFT_TAU):
        e = soft.engine(tau=tau)
        a = e.arrays
        for b, what in ((1, "margin"), (256, "margin"), (1, "moments"), (256, "moments")):
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
            bnd, by, design, former = soft_bound_ms(e, b, tau, leaf, sfu, distinct)
            rows[tau, b, what] = (ms, plain_ms, bnd, by)
            print(f"times [{name}] cam_match_soft tau={tau} {what} B={b} "
                  f"(R={a.r_pad}, F_pad={a.f_pad}, C={leaf.shape[1]}, K={a.cells.k}, "
                  f"lattice {a.cells.lattice}): kernel "
                  f"{ms:.4f} ms L2 flushed (warm {warm:.4f} ms), plain {plain_ms:.3f} ms, "
                  f"bound {bnd:.4f} ms by {by} ({bnd / ms:.1%} of bound); "
                  + (f"the bit-parallel design's {design:.4f} ms of lookups "
                     f"({route_of(a.cells)} route); former count, a compare and an AND per "
                     f"finite bound and query: {former:.4f} ms" if tau == 0.0 else
                     f"the cell-list design evaluates {listed_cells(a.cells) * b} cells x "
                     f"queries: {design:.4f} ms of table reads (former count, ex2 + lg2 a "
                     f"finite bound: {former:.4f} ms)")
                  + f"; {recorded((tau, b, what))}", flush=True)
    # tau = 0 on the rank route: the list without its words
    e = soft.engine(tau=0.0)
    a = e.arrays
    qp = e._prep_queries(batches[256])
    rk = ranked(a.cells)
    fn = lambda: K.cam_match_soft_cuda(qp, rk, a.leaf, e._bias, tau=0.0)  # noqa: E731
    if not torch.equal(fn(), K.cam_match_soft_cuda(qp, a.cells, a.leaf, e._bias, tau=0.0)):
        fail("soft tau = 0: the rank route's margins differ from the value route's")
    distinct = int((K.soft_scores_cuda(qp, a.cells, tau=0.0) > 0).any(dim=0).sum())
    bnd, by, design, former = soft_bound_ms(e, 256, 0.0, a.leaf, sfu, distinct, route="rank")
    print(f"times [{name}] cam_match_soft tau=0.0 margin B=256, rank route (the list's words "
          f"dropped): == the value route's margins; kernel {cold_time(fn, 10):.4f} ms L2 "
          f"flushed (value route {rows[0.0, 256, 'margin'][0]:.4f}), bound {bnd:.4f} ms by "
          f"{by}; the rank route's count {design:.4f} ms; former count {former:.4f} ms",
          flush=True)
    # the short log-sigmoid alone: the same call with the lattice table off
    e = soft.engine()
    a = e.arrays
    qp = e._prep_queries(batches[256])
    computed = ops.CellList(a.cells.count, a.cells.feat, a.cells.lo, a.cells.hi, a.cells.width)
    object.__setattr__(computed, "lattice", False)
    fn = lambda: K.cam_match_soft_cuda(qp, computed, a.leaf, e._bias, tau=SOFT_TAU)  # noqa: E731
    if not torch.equal(fn(), K.cam_match_soft_cuda(qp, a.cells, a.leaf, e._bias, tau=SOFT_TAU)):
        fail("soft tau > 0: the lattice table and the computed log-sigmoids differ")
    print(f"times [{name}] cam_match_soft tau={SOFT_TAU} margin B=256, lattice table off (the "
          f"log-sigmoids computed): kernel {cold_time(fn, 10):.4f} ms L2 flushed, == the "
          f"lattice table's margins bit for bit", flush=True)
    # predict(return_uncertainty=True): one launch, over the moments matrix
    x = batches[256]
    soft.predict(x, return_uncertainty=True)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    soft.predict(x, return_uncertainty=True)
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) * 1e3
    n = K.cam_match_soft_cuda.launches
    if n != 1:
        fail(f"predict(return_uncertainty=True) launched the soft kernel {n} times")
    before = FORMER_MS[SOFT_TAU, 256, "margin"] + FORMER_MS[SOFT_TAU, 256, "moments"]
    print(f"times [{name}] predict(return_uncertainty=True) B=256: {n} soft kernel launch, "
          f"its kernel {rows[SOFT_TAU, 256, 'moments'][0]:.4f} ms L2 flushed (former: 2 "
          f"launches, {before:.4f} ms); the call {call_ms:.3f} ms on the host clock",
          flush=True)
    cell_list_line(name, "soft float32", eng)
    print(f"times [{name}] soft bound: SFU rate {sfu / 1e12:.3f} T/s ({how}); shared "
          f"memory {smem_words_per_s() / 1e12:.3f} T words/s; finite "
          f"bounds {finite_bounds(eng)} of {2 * eng.arrays.r_pad * eng.arrays.f_pad}, "
          f"sides the kernel evaluates {evaluated_sides(eng.arrays.cells)}; soft bind "
          f"{stats['soft_bind_s']:.1f} s host; peak device memory over the soft path, "
          f"hard and soft engines bound: {stats['soft_peak_bytes'] / 2**30:.2f} GiB "
          f"(allocated now {torch.cuda.memory_allocated() / 2**30:.2f} GiB)", flush=True)
    ms, plain_ms, bnd, by = rows[SOFT_TAU, 256, "margin"]
    stats["soft_kernel_line"] = kernel_entry("cam_match_soft", "cam_match_soft.cu",
                                             stats["soft_launches"], stats["soft_max_abs_err"],
                                             ms, plain_ms, bnd, by)
    stats["soft_variant_lines"] = [  # tau = 0 runs the hard kernels' bit-parallel kernel
        kernel_entry(f"cam_match_soft[{label}]", source, stats["soft_launches"],
                     stats["soft_max_abs_err"], *rows[key])
        for label, source, key in (
            ("tau=0", "cam_match.cu", (0.0, 256, "margin")),
            (f"tau={SOFT_TAU} moments", "cam_match_soft.cu", (SOFT_TAU, 256, "moments")))]


# -- phase 6: serving, cluster, scoring and the traversal baseline -----------------


SERVE_REQUESTS = 2000
SERVE_GAP_S = 5e-4  # the trace's mean gap between requests: 2000 requests/s
SCORE_ROWS, SCORE_CHUNK = 262_144, 16_384


def latency(s) -> str:
    """A ``LatencyStats`` as one line of unrounded numbers."""
    return (f"p50 {s.p50_ms} ms, p99 {s.p99_ms} ms, mean {s.mean_ms} ms, "
            f"{s.requests_per_s} requests/s, {s.samples_per_s} rows/s, "
            f"{s.n_requests} requests, {s.n_flushes} flushes")


def request_rows(xs: np.ndarray, trace) -> list[np.ndarray]:
    return [np.take(xs, np.arange(r.row_start, r.row_start + r.n_rows), axis=0, mode="wrap")
            for r in trace.requests]


def counted(label: str) -> int:
    """The hard and soft kernels' launches since the last reset; a phase
    that launched neither fails."""
    n = K.cam_match_cuda.launches + K.cam_match_soft_cuda.launches
    if n == 0:
        fail(f"{label}: no kernel launch")
    return n


def serve_trace(marks=()):
    """The seeded trace of 2000 single-row requests (marks leave the
    requests as they are) and the rows it replays."""
    from repro_torch.serve import make_trace

    xs = np.random.default_rng(SEED + 20).integers(0, 256, size=(4096, 130)).astype(np.uint8)
    return make_trace(["xtime"], SERVE_REQUESTS, seed=SEED + 21, mean_interval_s=SERVE_GAP_S,
                      mean_rows=1.0, max_rows=1, marks=marks), xs


def phase_serving(cm, soft, name, stats):
    from repro_torch.serve import ServeLoop, TableRegistry, make_trace, replay_trace

    eng = cm.engine()
    reg = TableRegistry(device=eng.device)
    if reg.register("xtime", cm).engine is not eng:
        fail("serving: the registry bound a second engine for the artifact")
    trace, xs = serve_trace()
    want = cm.predict(np.concatenate(request_rows(xs, trace)))

    loop = ServeLoop(reg, flush_rows=256)  # window 2 ms
    reset_launches()
    res = replay_trace(loop.submit, trace, {"xtime": xs}, speed=1.0)
    loop.drain()
    launches = counted("serving")
    got = [loop.result(h) for h in res.handles]
    if not np.array_equal(np.concatenate(got), want):
        fail("serving: ServeLoop results differ from cm.predict")
    stats["serve_results"] = got  # the cluster phase's oracle
    s, rep = loop.stats("xtime"), loop.report("xtime")
    print(f"serve [{name}] ServeLoop(flush_rows=256, window 2 ms), {SERVE_REQUESTS} single-row "
          f"requests paced at {1 / SERVE_GAP_S:.0f}/s (replayed in {res.wall_s:.3f} s): "
          f"{latency(s)}; buckets {rep['measured']['buckets']}; {launches} kernel launches; "
          f"== cm.predict", flush=True)

    # service time: a flush per request (window 0), nothing to wait for
    quick = ServeLoop(reg, window_s=0.0, flush_rows=256)
    head = make_trace(["xtime"], 500, seed=SEED + 22, mean_rows=1.0, max_rows=1)
    reset_launches()
    res = replay_trace(quick.submit, head, {"xtime": xs}, speed=0)
    quick.drain()
    launches = counted("serving, window 0")
    got = [quick.result(h) for h in res.handles]
    if not np.array_equal(np.concatenate(got), cm.predict(np.concatenate(request_rows(xs, head)))):
        fail("serving, window 0: results differ from cm.predict")
    s = quick.stats("xtime")
    print(f"serve [{name}] single-row service latency (window 0: one flush, one launch a "
          f"request, 500 requests back to back): {latency(s)}; {launches} kernel launches",
          flush=True)

    # a hot swap to the soft artifact under traffic
    swap = make_trace(["xtime"], 400, seed=SEED + 23, mean_interval_s=SERVE_GAP_S,
                      mean_rows=1.0, max_rows=1, marks=[(0.5, "swap")])
    at = swap.marks[0].t
    reset_launches()
    res = replay_trace(loop.submit, swap, {"xtime": xs}, speed=1.0,
                       callbacks={"swap": lambda: reg.register("xtime", soft,
                                                               deploy=soft.deploy)})
    loop.drain()
    hard_n, soft_n = K.cam_match_cuda.launches, K.cam_match_soft_cuda.launches
    if hard_n == 0 or soft_n == 0:
        fail(f"hot swap: {hard_n} hard and {soft_n} soft launches")
    got = [loop.result(h) for h in res.handles]
    rows = request_rows(xs, swap)
    before = [i for i, r in enumerate(swap.requests) if r.t < at]
    after = [i for i, r in enumerate(swap.requests) if r.t >= at]
    if not np.array_equal(np.concatenate([got[i] for i in before]),
                          cm.predict(np.concatenate([rows[i] for i in before]))):
        fail("hot swap: results before the swap differ from cm.predict")
    if not np.array_equal(np.concatenate([got[i] for i in after]),
                          soft.predict(np.concatenate([rows[i] for i in after]))):
        fail("hot swap: results after the swap differ from soft.predict")
    if reg.version("xtime") != 2 or reg.engine("xtime") is not soft.engine():
        fail("hot swap: the registry does not serve the soft artifact's engine")
    print(f"serve [{name}] hot swap to the soft artifact (tau={SOFT_TAU}) under traffic: "
          f"{len(before)} requests before == cm.predict, {len(after)} after == soft.predict; "
          f"{hard_n} hard + {soft_n} soft launches", flush=True)


def phase_cluster(cm, name, stats):
    from repro_torch.serve import ClusterServer, replay_trace

    oracle = np.concatenate(stats["serve_results"])  # the ServeLoop's, same trace
    with ClusterServer(n_replicas=2, device=cm.engine().device, flush_rows=256) as srv:
        srv.register("xtime", cm)
        if any(r.registry.engine("xtime") is not cm.engine() for r in srv.replicas.values()):
            fail("cluster: a replica bound a second engine")
        for label, marks, callbacks in (
                ("", (), {}),
                (" with replica 1 crashed midway", [(0.5, "crash")],
                 {"crash": lambda: srv.inject_crash(1)})):
            trace, xs = serve_trace(marks)
            srv.reset_stats()
            reset_launches()
            res = replay_trace(srv.submit, trace, {"xtime": xs}, speed=1.0, callbacks=callbacks)
            srv.drain(timeout=120)
            launches = counted("cluster" + label)
            got = [h.result(10) for h in res.handles]
            if not np.array_equal(np.concatenate(got), oracle):
                fail(f"cluster{label}: results differ from the ServeLoop's")
            rep = srv.report("xtime")
            if res.shed or rep["shed"]:
                fail(f"cluster{label}: {res.shed} requests shed")
            s = srv.stats("xtime")
            states = {i: r["state"] for i, r in rep["replicas"].items()}
            print(f"cluster [{name}] ClusterServer(n_replicas=2), the same trace{label}: "
                  f"{latency(s)}; 0 shed, {rep['failovers']} failovers, replicas {states}, "
                  f"window {rep['windows_ms']} ms; {launches} kernel launches; == ServeLoop",
                  flush=True)
        if srv.report()["failovers"] < 1:
            fail("cluster: the injected crash caused no failover")


def phase_scoring(cm, name, stats):
    from repro_torch.score import score_file

    xs = np.random.default_rng(SEED + 30).integers(0, 256, size=(SCORE_ROWS, 130)).astype(np.uint8)
    want = np.concatenate([cm.predict(xs[i:i + 1024]) for i in range(0, SCORE_ROWS, 1024)])
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "rows.npy"
        np.save(path, xs)
        for db in (True, False, True):
            reset_launches()
            r = score_file(cm, path, kind="predict", chunk_rows=SCORE_CHUNK, double_buffer=db)
            launches = counted("scoring")
            if launches != r.n_chunks:
                fail(f"scoring: {launches} launches for {r.n_chunks} chunks")
            if not np.array_equal(r.values, want):
                fail(f"scoring (double buffer {db}): differs from cm.predict in 1024-row batches")
            stats.setdefault("score_rps", []).append(r.rows_per_s)
            print(f"score [{name}] score_file {SCORE_ROWS} x 130 uint8 rows "
                  f"({xs.nbytes / 1e6:.1f} MB .npy), chunk_rows {SCORE_CHUNK} (bucket {r.bucket}), "
                  f"double buffer {db}: {r.rows_per_s} rows/s ({r.elapsed_s} s, "
                  f"{r.n_chunks} chunks, {launches} launches); == cm.predict", flush=True)
    stats["score_rows"] = xs, want  # phase 8's command line scores the same rows


def phase_traversal(ens, cm, batches, name):
    t0 = time.perf_counter()
    tb = repro_torch.TraversalBaseline(ens)
    print(f"traversal [{name}] TraversalBaseline: {tb.feature.shape[0]} trees x "
          f"{tb.feature.shape[1]} node slots, depth {tb.depth}, built in "
          f"{time.perf_counter() - t0:.1f} s (host); the JAX package's traversal "
          f"algorithm in torch ops (gathers + a float32 sum per class), not a tuned GPU "
          f"library", flush=True)
    eng = cm.engine()
    for b in (1, 256, 1024):
        qd = torch.from_numpy(batches[b]).to(eng.device)
        if not np.array_equal(tb.raw_margin(qd).cpu().numpy(), cm.raw_margin(batches[b])):
            fail(f"traversal batch {b}: margins differ from the engine's")
        trav = sync_time(lambda: tb.raw_margin(qd), 20 if b == 1 else 5)
        qp = eng._prep_queries(batches[b])
        a = eng.arrays
        cam = sync_time(lambda: K.cam_match_cuda(qp, a.cells, a.leaf, eng._bias,
                                                 mode=eng.kernel_mode), 20 if b == 1 else 5)
        print(f"traversal [{name}] B={b}: traversal {trav:.4f} ms, CAM kernel {cam:.4f} ms "
              f"(both warm, back to back, CUDA events; traversal / CAM {trav / cam:.2f}); "
              f"margins == the engine's", flush=True)



# -- phase 7: models in --------------------------------------------------------


FIXTURES = Path(__file__).resolve().parent / "tests" / "fixtures" / "ingest"
# scripts/paper_scale_smoke.py's model: where the merge finishes in seconds
PAPER_SCALE = dict(n_trees=512, depth=8, n_features=32, n_bins=256, p_dup=0.5,
                   seed=20260808)
WIDE_FEATURES, WIDE_BATCH = 8000, 256  # the wide model: F_pad 8,064


class StepTimes:
    """Host seconds of the steps of ``build`` and of an engine bind, by
    wrapping the functions they call for as long as the ``with`` lasts:
    parse (``load_model``), lower, compile, compress, the chip plans
    (placement, NoC, perf) and the cell list."""

    def __init__(self):
        import repro_torch.api as api
        import repro_torch.ingest as ingest

        self.s: dict[str, float] = {}
        self._targets = [(ingest, "load_model", "parse"), (ingest, "lower_to_ensemble", "lower"),
                         (api, "compile_ensemble", "compile"), (api, "compress_table", "compress"),
                         (api, "pack_cores", "plans"), (api, "plan_noc", "plans"),
                         (api, "xtime_perf", "plans"), (ops, "binding_cells", "cell list")]
        self._saved = []

    def __enter__(self):
        for mod, attr, label in self._targets:
            fn = getattr(mod, attr)
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, label))
        return self

    def _wrap(self, fn, label):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.s[label] = self.s.get(label, 0.0) + time.perf_counter() - t0
        return timed

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)


def table_line(cm, eng) -> str:
    cnt = eng.arrays.cells.count[: cm.table.n_rows].double()
    return (f"{cm.table.n_rows} rows x {cm.table.n_cols} columns (F_pad {eng.arrays.f_pad}), "
            f"cell list K = {eng.arrays.cells.k}, cells per row mean {float(cnt.mean()):.3f} "
            f"max {int(cnt.max())}")


def phase_goldens(name) -> None:
    """Every golden dump of tests/fixtures/ingest through ``build(path)``
    on the card: the recorded answers (tests/test_torch_api.py's check)."""
    dumps = sorted(p for p in FIXTURES.iterdir()
                   if p.suffix in (".json", ".txt") and ".expected" not in p.name)
    if len(dumps) != 8:
        fail(f"goldens: {len(dumps)} dumps in {FIXTURES}, expected 8")
    reset_launches()
    for dump in dumps:
        exp = json.loads(dump.with_name(dump.name.rsplit(".", 1)[0] + ".expected.json")
                         .read_text())
        x = np.asarray(exp["x"], dtype=np.float64)
        cm = repro_torch.build(str(dump))
        pred, margin = cm.predict(x), cm.raw_margin(x)
        want_p, want_m = np.asarray(exp["predict"]), np.asarray(exp["raw_margin"], np.float32)
        if cm.table.task == "regression":
            ok_p = np.allclose(pred, want_p, rtol=1e-5, atol=1e-6)
        else:
            ok_p = np.array_equal(pred, want_p.astype(pred.dtype))
        if not ok_p or not np.allclose(margin, want_m, rtol=1e-5, atol=1e-6):
            fail(f"golden {dump.name}: predictions or margins differ from the record")
    launches = counted("goldens")
    print(f"models in [{name}] goldens: the 8 dumps of tests/fixtures/ingest through "
          f"repro_torch.build(path) -> predict/raw_margin on the card == each "
          f"*.expected.json (class ids exact, values rtol 1e-5 atol 1e-6); "
          f"{launches} kernel launches", flush=True)


def phase_ingested(ens, name, stats) -> None:
    """The xtime-tabular ensemble exported as an XGBoost JSON dump with
    float thresholds, built from the dump at 'off' and 'prune', served on
    the card, held to the native ensemble; kernel times and score_file."""
    from repro_torch.core.quantize import FeatureQuantizer
    from repro_torch.ingest import to_xgboost_json
    from repro_torch.score import score_file

    rng = np.random.default_rng(SEED + 40)
    quant = FeatureQuantizer.fit(rng.normal(size=(65536, 130)), 256)
    t0 = time.perf_counter()
    text = json.dumps(to_xgboost_json(ens, quant))
    export_s = time.perf_counter() - t0
    xs = {b: rng.normal(size=(b, 130)) for b in (1, 256, 1024)}
    want = {b: (ens.raw_margin(quant.transform(x[:64])), ens.predict(quant.transform(x[:64])))
            for b, x in xs.items()}
    cms, margins, res = {}, {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "xtime_tabular.json"
        path.write_text(text)
        print(f"models in [{name}] ingested: xtime-tabular (4096 trees x depth 8, 130 features, "
              f"8 classes, seed {SEED}) exported by to_xgboost_json with float thresholds, "
              f"{len(text) / 1e6:.1f} MB, {export_s:.2f} s host", flush=True)
        for level in ("off", "prune"):
            reset_launches()
            with StepTimes() as st:
                t0 = time.perf_counter()
                cm = repro_torch.build(str(path), compress=level)
                t1 = time.perf_counter()
                eng = cm.engine()
                torch.cuda.synchronize()
                t2 = time.perf_counter()
            margins[level] = {b: cm.raw_margin(x) for b, x in xs.items()}
            preds = {b: cm.predict(x) for b, x in xs.items()}
            torch.cuda.synchronize()
            launches = counted(f"ingested {level}")
            for b in xs:
                m, pr = want[b]
                if not (np.array_equal(margins[level][b][:64], m)
                        and np.array_equal(preds[b][:64], pr)):
                    fail(f"ingested {level} B={b}: differs from the native ensemble")
                if not np.array_equal(margins[level][b], margins["off"][b]):
                    fail(f"ingested {level} B={b}: margins differ from 'off' bit for bit")
            cms[level] = cm
            steps = ", ".join(f"{k} {v:.2f} s" for k, v in st.s.items())
            print(f"models in [{name}] ingested compress={level!r}: {table_line(cm, eng)}; "
                  f"margins and predictions at B = 1, 256, 1024 == the native ensemble (64 rows "
                  f"a batch)" + (" and == 'off' bit for bit (all rows)" if level != "off" else "")
                  + f"; {launches} kernel launches; host: build {t1 - t0:.2f} s ({steps}), "
                  f"bind {t2 - t1:.2f} s", flush=True)
            if cm.compression is not None:
                print(f"models in [{name}] ingested compression report: {cm.compression}",
                      flush=True)
            for b in (256, 1024):
                qp = eng._prep_queries(cm.quantizer.transform(xs[b]))
                a = eng.arrays
                fn = lambda: K.cam_match_cuda(qp, a.cells, a.leaf, eng._bias,  # noqa: E731
                                              mode=eng.kernel_mode)
                ms = cold_time(fn, 10)
                bnd, by, design, _ = bound_ms(eng, b, *match_stats(eng, qp))
                res[level, b] = ms
                print(f"times [{name}] ingested {level!r} cam_match {eng.table_dtype}/"
                      f"{eng.kernel_mode} B={b} (R={a.r_pad}, K={a.cells.k}): kernel {ms:.4f} ms "
                      f"L2 flushed, bound {bnd:.4f} ms by {by} ({bnd / ms:.1%} of bound), the "
                      f"cell-list design {design:.4f} ms of compares", flush=True)
        for b in (256, 1024):
            ratio = res["prune", b] / res["off", b]
            rows = cms["prune"].table.n_rows / cms["off"].table.n_rows
            print(f"times [{name}] ingested B={b}: 'prune' / 'off' kernel time {ratio:.3f} "
                  f"(rows {rows:.3f})", flush=True)

        big = cms["prune"].quantizer.transform(rng.normal(size=(SCORE_ROWS, 130)))
        want_big = np.concatenate([cms["off"].predict(big[i:i + SCORE_CHUNK])
                                   for i in range(0, SCORE_ROWS, SCORE_CHUNK)])
        npy = Path(tmp) / "rows.npy"
        np.save(npy, big)
        reset_launches()
        r = score_file(cms["prune"], npy, kind="predict", chunk_rows=SCORE_CHUNK)
        launches = counted("ingested scoring")
        if not np.array_equal(r.values, want_big):
            fail("ingested score_file on 'prune' differs from 'off' predict")
        print(f"score [{name}] ingested 'prune': score_file {SCORE_ROWS} x 130 {big.dtype} rows "
              f"binned by the ingested grid, chunk_rows {SCORE_CHUNK}: {r.rows_per_s} rows/s "
              f"({r.elapsed_s} s, {r.n_chunks} chunks, {launches} launches); == 'off' predict",
              flush=True)


def phase_compress_levels(name, stats) -> None:
    """'merge' and 'full' on the paper-scale smoke shape, bit-equal to
    'off' on the card; soft tau = 0.1 on the 'full' artifact against its
    plain version."""
    ens = random_deep_ensemble(**PAPER_SCALE)
    q = np.random.default_rng(SEED + 41).integers(0, 256, size=(256, 32)).astype(np.uint8)
    base = None
    for level in ("off", "prune", "merge", "full"):
        reset_launches()
        with StepTimes() as st:
            cm = repro_torch.build(ens, compress=level)
        m = cm.raw_margin(q)
        launches = counted(f"paper-scale {level}")
        base = m if base is None else base
        if not np.array_equal(m, base):
            fail(f"paper-scale {level}: margins differ from 'off' bit for bit")
        print(f"models in [{name}] paper-scale (512 trees x depth 8, 32 features, p_dup 0.5, "
              f"seed {PAPER_SCALE['seed']}) compress={level!r}: {table_line(cm, cm.engine())}; "
              f"margins at B = 256 == 'off' bit for bit; compress_table "
              f"{st.s.get('compress', 0.0):.2f} s host; {launches} kernel launches"
              + (f"; report {cm.compression}" if cm.compression else ""), flush=True)
    reset_launches()
    eng = cm.engine(mode="soft", tau=SOFT_TAU)
    got = torch.from_numpy(cm.raw_margin(q, mode="soft", tau=SOFT_TAU)).cuda()
    if K.cam_match_soft_cuda.launches == 0:
        fail("paper-scale 'full' soft: no soft kernel launch")
    a = eng.arrays
    qp = eng._prep_queries(q)
    s_ref = ref.soft_scores_ref(qp, a.low, a.high, tau=SOFT_TAU)
    plain = ref.cam_match_ref(qp, a.low, a.high, a.leaf, mode="soft", tau=SOFT_TAU)
    plain = plain + float(np.float32(cm.table.base_score))  # the epilogue's base score
    lim = ref.soft_margin_bound(s_ref, a.leaf, a.f_pad, K.n_splits(a.r_pad) + 2)
    lim = lim + 2 * F32_EPS * plain.abs().double()  # the bias add
    c = got.shape[1]
    err = (got - plain[:, :c]).abs().double()
    if bool((err > lim[:, :c]).any()):
        fail(f"paper-scale 'full' soft: margins off the plain version by {float(err.max())}")
    stats["soft_max_abs_err"] = max(stats["soft_max_abs_err"], float(err.max()))
    print(f"models in [{name}] paper-scale 'full' soft tau={SOFT_TAU}: margins within the bound "
          f"of the plain version on the card (max |err| {float(err.max()):.3g})", flush=True)


def phase_degenerate(name) -> None:
    """Tables compression leaves degenerate, through the kernel and held
    to the plain version: every row pruned (the one sentinel row) and a
    table collapsed to one feature column."""
    from repro_torch.core.compile import CAMTable
    from repro_torch.core.compress import compress_table

    rng = np.random.default_rng(SEED + 42)
    r, f, n_bins = 64, 20, 256

    def table(low, high):
        return CAMTable(low=low.astype(np.int32), high=high.astype(np.int32),
                        leaf=(rng.integers(-16, 17, size=r) / 16.0).astype(np.float32),
                        tree_id=np.arange(r, dtype=np.int32), class_id=np.zeros(r, np.int32),
                        n_trees=r, n_features=f, n_bins=n_bins, n_outputs=1, task="regression",
                        kind="gbdt", base_score=0.0, n_classes=1, table_dtype="int32")

    low, high = np.zeros((r, f)), np.full((r, f), n_bins)
    cols = rng.integers(0, f, size=r)
    low[np.arange(r), cols] = 100  # an empty interval in every row
    high[np.arange(r), cols] = 100
    pruned = table(low, high)
    low, high = np.zeros((r, f)), np.full((r, f), n_bins)
    low[:, 7] = rng.integers(0, 128, size=r)  # feature 7 the only constrained one
    high[:, 7] = low[:, 7] + rng.integers(1, 128, size=r)
    one_col = table(low, high)
    q = rng.integers(0, n_bins, size=(37, f)).astype(np.int32)
    for label, t, check in (
            ("every row pruned", pruned,
             lambda ct, rep: rep.sentinel_rows == 1 and ct.n_rows == 1),
            ("collapsed to one column", one_col,
             lambda ct, rep: ct.n_cols == 1 and list(ct.feature_ids) == [7])):
        ct, rep = compress_table(t, level="full")
        if not check(ct, rep):
            fail(f"degenerate ({label}): compression gave {ct.n_rows} rows x {ct.n_cols} cols")
        cm = repro_torch.build(ct)
        reset_launches()
        got = cm.raw_margin(q)
        launches = counted(f"degenerate ({label})")
        plain = cm.raw_margin(q, device="cpu")
        truth = repro_torch.build(t).raw_margin(q, device="cpu")
        if not (np.array_equal(got, plain) and np.array_equal(got, truth)):
            fail(f"degenerate ({label}): the card differs from the plain version")
        print(f"models in [{name}] degenerate table, {label}: {ct.n_rows} rows x {ct.n_cols} "
              f"columns through the kernel ({launches} launches) == the plain version == the "
              f"uncompressed table's plain version", flush=True)


SEARCH_S = 5.0  # host seconds of each random search


def search_trials(ds, kind, seconds):
    """``random_search`` with as many trials as fit about ``seconds`` of
    host time, judged from one trial alone (the same seed draws the same
    first trials)."""
    from repro_torch.core.tune import random_search

    t0 = time.perf_counter()
    random_search(ds, kind=kind, n_trials=1, seed=SEED)
    one = time.perf_counter() - t0
    n = int(max(1, min(40, seconds // max(one, 1e-3))))
    t0 = time.perf_counter()
    res = random_search(ds, kind=kind, n_trials=n, seed=SEED)
    return res, n, time.perf_counter() - t0


def serve_trained(label, ens, quant, ds, name) -> None:
    from repro_torch.data import accuracy_metric

    reset_launches()
    cm = repro_torch.build(ens, quantizer=quant, compress="auto")
    pred = cm.predict(ds.x_test)
    launches = counted(label)
    want = ens.predict(quant.transform(ds.x_test))
    if not np.array_equal(pred, want):
        fail(f"{label}: predictions on the card differ from Ensemble.predict")
    acc, acc_np = (accuracy_metric(ds.task, ds.y_test, p) for p in (pred, want))
    if acc != acc_np:
        fail(f"{label}: accuracy {acc} != the numpy ensemble's {acc_np}")
    print(f"models in [{name}] {label}: build(compress='auto') -> {table_line(cm, cm.engine())}; "
          f"predict on the card over the {ds.x_test.shape[0]} test rows == Ensemble.predict; "
          f"accuracy {acc} (numpy ensemble {acc_np}); {launches} kernel launches "
          f"({ens.n_trees} trees, max {ens.max_leaves} leaves, rows saved "
          f"{cm.compression['rows_saved']})", flush=True)


def phase_trained(name) -> None:
    """Trained under the chip's constraints: the hardware-aware search on
    churn (GBDT and RF), and one GBDT on gas (129 features, 6 classes)."""
    from repro_torch.core.quantize import FeatureQuantizer
    from repro_torch.core.trees import GBDTParams, train_gbdt
    from repro_torch.data import make_dataset

    ds = make_dataset("churn")
    for kind in ("gbdt", "rf"):
        res, n, secs = search_trials(ds, kind, SEARCH_S)
        print(f"models in [{name}] random_search(churn, kind={kind!r}): {n} trials in "
              f"{secs:.1f} s host; best valid score {res.best.valid_score}, params "
              f"{res.best.params}", flush=True)
        serve_trained(f"churn {kind} search winner", res.ensemble, res.quantizer, ds, name)
    gas = make_dataset("gas")
    quant = FeatureQuantizer.fit(gas.x_train, 256)
    t0 = time.perf_counter()
    ens = train_gbdt(quant.transform(gas.x_train), gas.y_train, task=gas.task, n_bins=256,
                     n_classes=gas.n_classes, params=GBDTParams(n_rounds=3, max_depth=8))
    print(f"models in [{name}] train_gbdt(gas, n_rounds=3, max_depth=8): {ens.n_trees} trees "
          f"in {time.perf_counter() - t0:.1f} s host", flush=True)
    serve_trained("gas gbdt", ens, quant, gas, name)


# (label, engine overrides) of the wide model, every variant past its window
WIDE_TIMED = [("uint8/inclusive", {}), ("uint16/inclusive", {"table_dtype": "uint16"}),
              ("int32/direct", {"table_dtype": "int32"}), ("int32/msb_lsb", {"mode": "msb_lsb"}),
              ("int32/two_cycle", {"mode": "two_cycle"})]


def phase_wide_model(name, stats) -> None:
    """A model 8,000 features wide (F_pad 8,064, past every variant's
    staged query window) through ``raw_margin`` in every hard variant and
    the soft mode, and the soft engine's ``raw_moments``, each driven with
    the counts set to 0 just before and read just after, held to the host
    traversal or the plain version and timed; beside it the uint8 kernel
    on the same shape at 130 features (F_pad 256, no wide path)."""
    ens = random_deep_ensemble(n_trees=64, depth=8, n_features=WIDE_FEATURES, n_bins=256,
                               task="multiclass", n_classes=4, seed=SEED + 50)
    cm = repro_torch.build(ens)
    rng = np.random.default_rng(SEED + 51)
    x = rng.integers(0, 256, size=(WIDE_BATCH, WIDE_FEATURES)).astype(np.uint8)
    want = ens.raw_margin(x)
    lines = []
    for label, overrides in WIDE_TIMED:
        reset_launches()
        m = cm.raw_margin(x, **overrides)
        launches = counted(f"wide {label}")
        if not np.array_equal(m, want):
            fail(f"wide {label}: margins differ from Ensemble.raw_margin")
        eng = cm.engine(**overrides)
        qp = eng._prep_queries(x)
        a = eng.arrays
        fn = lambda: K.cam_match_cuda(qp, a.cells, a.leaf, eng._bias,  # noqa: E731
                                      mode=eng.kernel_mode)
        ms = cold_time(fn, 10)
        plain_ms = sync_time(lambda: ref.cam_match_ref(qp, a.low, a.high, a.leaf,
                                                       mode=eng.kernel_mode), 1, warmup=1)
        bnd, by, _, _ = bound_ms(eng, WIDE_BATCH, *match_stats(eng, qp))
        print(f"times [{name}] wide cam_match {label} B={WIDE_BATCH} (R={a.r_pad}, F_pad={a.f_pad}, "
              f"K={a.cells.k}): margins == Ensemble.raw_margin, {launches} launches; kernel "
              f"{ms:.4f} ms L2 flushed, plain {plain_ms:.3f} ms, bound {bnd:.4f} ms by {by}",
              flush=True)
        lines.append(kernel_entry(f"cam_match[{label}, F_pad={a.f_pad}]", "cam_match.cu",
                                  launches, 0.0, ms, plain_ms, bnd, by))
        if not overrides:
            per_cell = ms / (listed_cells(a.cells) * WIDE_BATCH) * 1e9  # ps a cell x query
    twin = repro_torch.build(random_deep_ensemble(n_trees=64, depth=8, n_features=130, n_bins=256,
                                                  task="multiclass", n_classes=4,
                                                  seed=SEED + 50))
    teng = twin.engine()
    ta = teng.arrays
    tq = teng._prep_queries(rng.integers(0, 256, size=(WIDE_BATCH, 130)).astype(np.uint8))
    twin_ms = cold_time(lambda: K.cam_match_cuda(tq, ta.cells, ta.leaf, teng._bias,
                                                 mode=teng.kernel_mode), 10)
    twin_cell = twin_ms / (listed_cells(ta.cells) * WIDE_BATCH) * 1e9
    print(f"times [{name}] wide uint8/inclusive B={WIDE_BATCH}: {per_cell:.2f} ps a listed cell "
          f"x query at F_pad 8,064; the same shape at 130 features (F_pad {ta.f_pad}, R={ta.r_pad}) "
          f"{twin_ms:.4f} ms, {twin_cell:.2f} ps (wide / narrow {per_cell / twin_cell:.2f})",
          flush=True)
    sfu, _ = sfu_per_s()
    for tau, what in ((0.0, "margin"), (SOFT_TAU, "margin"), (SOFT_TAU, "moments")):
        reset_launches()
        eng = cm.engine(mode="soft", tau=tau)
        if what == "margin":
            m = cm.raw_margin(x, mode="soft", tau=tau)
        else:
            m = eng.raw_moments(x).cpu().numpy()
        launches = counted(f"wide soft {tau} {what}")
        a = eng.arrays
        qp = eng._prep_queries(x)
        leaf, bias = (a.leaf, eng._bias) if what == "margin" else (eng._moments, None)
        plain = ref.cam_match_ref(qp, a.low, a.high, leaf, mode="soft", tau=tau)
        if what == "margin":  # the epilogue's base score
            plain = plain + float(np.float32(cm.table.base_score))
        c = m.shape[1]
        err = (torch.from_numpy(m).cuda() - plain[:, :c]).abs().double()
        if tau == 0.0:
            if not np.array_equal(m, want):
                fail("wide soft tau=0: margins differ from Ensemble.raw_margin")
        else:
            s_ref = ref.soft_scores_ref(qp, a.low, a.high, tau=tau)
            lim = ref.soft_margin_bound(s_ref, leaf, a.f_pad, K.n_splits(a.r_pad) + 2)
            lim = lim + 2 * F32_EPS * plain.abs().double()
            if bool((err > lim[:, :c]).any()):
                fail(f"wide soft tau={tau} {what}: off the plain version by {float(err.max())}")
        fn = lambda: K.cam_match_soft_cuda(qp, a.cells, leaf, bias, tau=tau)  # noqa: E731
        ms = cold_time(fn, 10)
        plain_ms = sync_time(lambda: ref.cam_match_ref(qp, a.low, a.high, leaf, mode="soft",
                                                       tau=tau), 1, warmup=1)
        distinct = 0 if tau else int((K.soft_scores_cuda(qp, a.cells, tau=0.0) > 0)
                                     .any(dim=0).sum())
        bnd, by, _, _ = soft_bound_ms(eng, WIDE_BATCH, tau, leaf, sfu, distinct)
        label = f"tau={tau}" + (" moments" if what == "moments" else "")
        print(f"times [{name}] wide cam_match_soft {label} B={WIDE_BATCH} (R={a.r_pad}, F_pad={a.f_pad}, "
              f"C={leaf.shape[1]}): " + ("== Ensemble.raw_margin" if tau == 0.0 else
                                         "within the bound of the plain version")
              + f" (max |err| {float(err.max()):.3g}), {launches} launches; kernel {ms:.4f} ms "
              f"L2 flushed, plain {plain_ms:.3f} ms, bound {bnd:.4f} ms by {by}", flush=True)
        lines.append(kernel_entry(f"cam_match_soft[{label}, F_pad={a.f_pad}]",
                                  "cam_match.cu" if tau == 0.0 else "cam_match_soft.cu",
                                  launches, float(err.max()), ms, plain_ms, bnd, by))
    stats["wide_lines"] = lines


# xtime-tabular's trees and depth at the width of Bosch Production Line
# Performance (gbm-bench: 968 numeric features), R = 1,048,576, F_pad 1,024:
# its span passes one block's value (223) and rank (893) table windows
BOSCH_FEATURES = 968
BOSCH_BATCHES = (1, 256, 1024)
BOSCH_TIMED = [("uint8/inclusive", {}), ("uint16/inclusive", {"table_dtype": "uint16"}),
               ("int32/direct", {"table_dtype": "int32"}),
               ("soft tau=0", {"mode": "soft", "tau": 0.0})]


def plain_margins(eng: XTimeEngine, qp: torch.Tensor, b: int) -> tuple[np.ndarray, float]:
    """The engine's margins by the plain version on the card (its epilogue
    as the engine applies it) and the milliseconds that took."""
    a = eng.arrays
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = ref.cam_match_ref(qp, a.low, a.high, a.leaf, mode=eng.kernel_mode, tau=eng.tau)
    end.record()
    torch.cuda.synchronize()
    if eng._bias is not None:
        out = out + eng._bias
    return eng._epilogue(out)[:b].cpu().numpy(), start.elapsed_time(end)


def phase_bosch_width(name, stats) -> None:
    """The 968-feature model at full size through ``cm.raw_margin`` /
    ``cm.predict`` at B = 1, 256 and 1,024 in uint8/inclusive,
    uint16/inclusive, int32/direct and soft tau = 0, each engine bound,
    driven with the counts set to 0 just before and read just after, held
    to the host traversal (64 rows a batch) and to the plain version on
    the card (every row; at B = 1,024 the first variant's, which every
    variant equals bit for bit), timed with the L2 flushed beside its bound and
    beside the lane-per-query walk on the same list (``walk=True``, equal
    bit for bit: margins at every batch, match bits or scores at 256), and
    let go before the next is bound.  Every variant runs a cluster."""
    xt = get_config("xtime-tabular")
    depth = xt.max_leaves.bit_length() - 1
    t0 = time.perf_counter()
    ens = random_deep_ensemble(n_trees=xt.n_trees, depth=depth, n_features=BOSCH_FEATURES,
                               n_bins=xt.n_bins, task=xt.task, n_classes=xt.n_classes,
                               seed=SEED + 60)
    t1 = time.perf_counter()
    cm = repro_torch.build(ens)
    t2 = time.perf_counter()
    rng = np.random.default_rng(SEED + 61)
    batches = {b: rng.integers(0, xt.n_bins, size=(b, BOSCH_FEATURES)).astype(np.uint8)
               for b in BOSCH_BATCHES}
    want = {b: (ens.raw_margin(x[:64]), ens.predict(x[:64])) for b, x in batches.items()}
    print(f"968 features: {xt.n_trees} trees x depth {depth}, {BOSCH_FEATURES} features, "
          f"{xt.n_classes} classes -> {cm.table.n_rows} CAM rows; ensemble {t1 - t0:.1f} s, "
          f"build {t2 - t1:.1f} s (host)", flush=True)
    sfu, _ = sfu_per_s()
    matched, plains, lines = {}, {}, []
    for label, overrides in BOSCH_TIMED:
        t0 = time.perf_counter()
        eng = cm.engine(**overrides)
        torch.cuda.synchronize()
        bind_s = time.perf_counter() - t0
        reset_launches()
        margins = {b: cm.raw_margin(x, **overrides) for b, x in batches.items()}
        preds = {b: cm.predict(x, **overrides) for b, x in batches.items()}
        torch.cuda.synchronize()
        launches = counted(f"968 {label}")
        a = eng.arrays
        kernel, members = K.kernel_route(a.cells)
        print(f"times [{name}] 968 {label}: bound in {bind_s:.1f} s (host; R={a.r_pad}, "
              f"F_pad={a.f_pad}, K={a.cells.k}, span {a.cells.span}, "
              f"{float(a.cells.count[: cm.table.n_rows].double().mean()):.3f} cells a row), "
              f"{launches} launches in {2 * len(batches)} calls, {route_of(a.cells)} route on "
              f"{blocks_a_tile(a.cells)}", flush=True)
        if kernel != "bit-parallel" or members < 2:
            fail(f"968 {label}: the list does not run on a cluster ({kernel}, {members})")
        for b, x in batches.items():
            if not (np.array_equal(margins[b][:64], want[b][0])
                    and np.array_equal(preds[b][:64], want[b][1])):
                fail(f"968 {label} batch {b}: differs from Ensemble.raw_margin/predict")
            if not np.isfinite(margins[b]).all() or margins[b].shape != (b, xt.n_classes):
                fail(f"968 {label} batch {b}: margins not finite of shape ({b}, {xt.n_classes})")
            qp = eng._prep_queries(x)
            if b not in plains or b < 1024:  # B = 1,024 once: ~8-12 s a variant
                plains[b] = (*plain_margins(eng, qp, b), label)
            plain, plain_ms, whose = plains[b]
            if not np.array_equal(margins[b], plain):
                fail(f"968 {label} batch {b}: margins differ from the plain version on the card")
            if eng.kernel_mode == "soft":
                def call(walk=False):
                    return K.cam_match_soft_cuda(qp, a.cells, a.leaf, eng._bias, tau=0.0,
                                                 walk=walk)

                def lines_of(walk=False):
                    return K.soft_scores_cuda(qp, a.cells, tau=0.0, walk=walk)
                bnd, by, _, _ = soft_bound_ms(eng, b, 0.0, a.leaf, sfu, matched[b][1])
            else:
                def call(walk=False):
                    return K.cam_match_cuda(qp, a.cells, a.leaf, eng._bias,
                                            mode=eng.kernel_mode, walk=walk)

                def lines_of(walk=False):
                    return K.cam_match_bits_cuda(qp, a.cells, mode=eng.kernel_mode, walk=walk)
                matched.setdefault(b, match_stats(eng, qp))  # every variant matches alike
                bnd, by, _, _ = bound_ms(eng, b, *matched[b])
            if not torch.equal(call(), call(walk=True)):
                fail(f"968 {label} batch {b}: the cluster's margins differ from the walk's")
            if b == 256 and not torch.equal(lines_of(), lines_of(walk=True)):
                fail(f"968 {label} batch {b}: the cluster's match lines differ from the walk's")
            ms = cold_time(call, 20 if b == 1 else 10)
            walk_ms = cold_time(lambda: call(walk=True), 20 if b == 1 else 10)
            print(f"times [{name}] 968 cam_match {label} B={b}: == Ensemble.raw_margin (64 "
                  f"rows), == plain version (all rows), == the walk bit for bit; cluster "
                  f"{ms:.4f} ms L2 flushed, the walk {walk_ms:.4f} ms ({walk_ms / ms:.2f}x), "
                  f"plain {plain_ms:.3f} ms{'' if whose == label else f' ({whose})'}, bound "
                  f"{bnd:.4f} ms by {by} ({bnd / ms:.1%} of bound)", flush=True)
            if b == 256:
                lines.append(kernel_entry(f"cam_match[{label}, F_pad={a.f_pad}, R={a.r_pad}]",
                                          "cam_match.cu", launches, 0.0, ms, plain_ms, bnd, by))
        del eng, a, call, lines_of
        cm._engines.clear()  # let the engine's tables go before the next binds
        gc.collect()
        torch.cuda.empty_cache()
    stats["bosch_lines"] = lines


# -- phase 8: the operator's tools ----------------------------------------------


ROOT = Path(__file__).resolve().parent
TUNE_BATCH, TUNE_BUCKETS = 256, (1, 16, 1024)
# a JAX-package plan's env: timed on another platform by another package
FOREIGN_ENV = {"platform": "tpu", "n_devices": 1, "jax": "0.4.37"}


class BindCount:
    """Engines bound while the ``with`` lasts (``XTimeEngine.__init__``)."""

    def __enter__(self):
        self.n, init = 0, XTimeEngine.__init__

        def counting(eng, *args, **kwargs):
            self.n += 1
            init(eng, *args, **kwargs)

        self._init, XTimeEngine.__init__ = init, counting
        return self

    def __exit__(self, *exc):
        XTimeEngine.__init__ = self._init


def layout(entry: dict) -> str:
    """The kernel instance a trial or dispatch entry runs: packed dtypes
    always compare inclusive bounds."""
    mode = "inclusive" if np.dtype(entry["table_dtype"]).kind == "u" else entry["mode"]
    return f"{entry['table_dtype']}/{mode}"


def sweep_lines(plan, name: str, label: str) -> dict:
    """Each layout's median microseconds per bucket over its (b_blk, r_blk)
    twins — the same kernel on the same shapes, so their spread (max/min)
    is the timer's noise — and the dispatch."""
    groups: dict[tuple, list[float]] = {}
    for t in plan.trials:
        groups.setdefault((layout(t), t["batch"]), []).append(t["us_per_call"])
    for (lay, b), us in groups.items():
        print(f"tools [{name}] {label} sweep {lay} B={b}: median {float(np.median(us))} us "
              f"over {len(us)} (b_blk, r_blk) twins, min {min(us)}, max {max(us)}, spread "
              f"max/min {max(us) / min(us):.4f}", flush=True)
    print(f"tools [{name}] {label} dispatch: " + "; ".join(
        f"B={e['batch']} -> {layout(e)} (mode {e['mode']}, b_blk {e['b_blk']}, r_blk "
        f"{e['r_blk']}) {e['us_per_call']} us" for e in plan.dispatch), flush=True)
    return groups


def start_together(cmds: list[list[str]], env: dict) -> list[subprocess.Popen]:
    return [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env=env, cwd=str(ROOT)) for c in cmds]


def run_together(cmds: list[list[str]], env: dict, timeout: float) -> list[tuple]:
    """Start every command at once, wait for all: (rc, stdout, stderr,
    seconds) each.  Every process is ended before this returns."""
    t0 = time.perf_counter()
    return wait_together(start_together(cmds, env), t0, timeout)


def wait_together(procs: list[subprocess.Popen], t0: float, timeout: float) -> list[tuple]:
    """Wait for every process started at ``t0``: (rc, stdout, stderr,
    seconds) each.  Every process is ended before this returns."""
    out = []
    try:
        for proc in procs:
            o, e = proc.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
            out.append((proc.returncode, o, e, time.perf_counter() - t0))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def phase_tools(cm, soft, batches, name, stats) -> None:
    """Phase 8: the autotuner and its per-bucket dispatch, the command
    lines and the examples on the card."""
    from repro_torch import TunePlan, autotune_kernel

    with BindCount() as binds:
        t0 = time.perf_counter()
        plan = autotune_kernel(cm, batch=TUNE_BATCH, batches=TUNE_BUCKETS)
        secs = time.perf_counter() - t0
    if not plan.timed_on("cuda") or plan.env["device_name"] != torch.cuda.get_device_name(0):
        fail(f"autotune: the plan's env {plan.env} does not name this card")
    groups = sweep_lines(plan, name, "hard")
    layouts = {lay for lay, _ in groups}
    if binds.n != len(layouts) or len(plan.trials) != 9 * len(layouts) * 4:
        fail(f"autotune: {binds.n} engines bound for {len(layouts)} layouts, "
             f"{len(plan.trials)} trials")
    print(f"tools [{name}] hard sweep: {len(plan.trials)} trials, {binds.n} engines bound "
          f"({', '.join(sorted(layouts))}), {secs} s", flush=True)

    xs = {1: batches[1], 16: batches[37][:16], 256: batches[256], 1024: batches[1024]}
    want = {b: (cm.predict(x), cm.raw_margin(x)) for b, x in xs.items()}
    with tempfile.TemporaryDirectory() as tmp:
        base = Path(tmp) / "tuned"
        t0 = time.perf_counter()
        cm.with_tuning(plan).save(base)
        loaded = repro_torch.CompiledModel.load(base)
        save_s = time.perf_counter() - t0
        if loaded.tune_plan() != plan:
            fail("tuned artifact: the plan differs after save -> load")
        reset_launches()  # count only the tuned path's launches
        per_variant: dict[str, int] = {}
        with BindCount() as tbinds:
            for b, x in xs.items():
                before = K.cam_match_cuda.launches
                if not (np.array_equal(loaded.predict(x), want[b][0])
                        and np.array_equal(loaded.raw_margin(x), want[b][1])):
                    fail(f"tuned artifact B={b}: predict/raw_margin differ from the untuned")
                eng, e = loaded.engine(batch_hint=b), plan.dispatch_for(b)
                if (eng.table_dtype, eng.mode, eng.b_blk, eng.r_blk) != (
                        e["table_dtype"], e["mode"], e["b_blk"], e["r_blk"]):
                    fail(f"tuned artifact B={b}: bound {eng.table_dtype}/{eng.mode} "
                         f"{eng.b_blk}/{eng.r_blk}, not the bucket's winner {e}")
                lay = f"{eng.table_dtype}/{eng.kernel_mode}"
                per_variant[lay] = per_variant.get(lay, 0) + K.cam_match_cuda.launches - before
            torch.cuda.synchronize()
        launches = counted("tuned path")
        winners = {b: tuple(plan.dispatch_for(b)[k] for k in ("b_blk", "r_blk", "table_dtype",
                                                                "mode")) for b in xs}
        engines = {b: loaded.engine(batch_hint=b) for b in xs}
        shared = all((winners[a] == winners[b]) == (engines[a] is engines[b])
                     for a in xs for b in xs)
        if launches != 2 * len(xs) or not shared or tbinds.n != len(set(winners.values())):
            fail(f"tuned path: {launches} launches, {tbinds.n} engines for "
                 f"{len(set(winners.values()))} distinct winners, shared {shared}")
        print(f"tools [{name}] tuned artifact: with_tuning -> save -> load {save_s} s; "
              f"predict + raw_margin at B = {', '.join(map(str, xs))} == untuned bit for "
              f"bit; launches by variant {per_variant}; {tbinds.n} engines bound for "
              f"{len(set(winners.values()))} distinct bucket winners (buckets with one "
              f"winner share one engine)", flush=True)
        del loaded, engines, eng

        own = cm.with_tuning(plan)
        foreign = cm.with_tuning(TunePlan.from_dict({**plan.to_dict(), "env": FOREIGN_ENV}))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            moved = {label: [b for b in xs if a.resolved_deploy(b, device="cuda")
                             != a.resolved_deploy(device="cuda")]
                     for label, a in (("own", own), ("foreign", foreign))}
        n_warn = sum(issubclass(w.category, UserWarning) for w in caught)
        if moved["foreign"] or n_warn != 1:
            fail(f"foreign plan: dispatch applied at {moved['foreign']}, {n_warn} warnings")
        print(f"tools [{name}] a JAX-style plan (env {FOREIGN_ENV}) applies no dispatch entry "
              f"(the port's own moves buckets {moved['own']} off the primary winner); "
              f"{n_warn} UserWarning", flush=True)
        del own, foreign

        with BindCount() as sbinds:
            t0 = time.perf_counter()
            splan = autotune_kernel(soft, batch=TUNE_BATCH)
            ssecs = time.perf_counter() - t0
        sgroups = sweep_lines(splan, name, f"soft tau={SOFT_TAU}")
        if sbinds.n != 1 or len(sgroups) != 1:
            fail(f"soft autotune: {sbinds.n} binds, {len(sgroups)} layouts")
        (us,) = sgroups.values()
        print(f"tools [{name}] soft sweep: {len(splan.trials)} trials, 1 engine bound, "
              f"{ssecs} s; whole call median {float(np.median(us)) / 1e3:.4f} ms against "
              f"phase 5's kernel alone (L2 flushed) "
              f"{stats['soft_kernel_line']['ms']:.4f} ms", flush=True)
        phase_commands(base, name, stats)


def phase_commands(tuned_base: Path, name: str, stats) -> None:
    """The command lines and the four examples as subprocesses on the card."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    work = tuned_base.parent
    deep = FIXTURES / "xgb_deep.json"
    golden = FIXTURES / "xgb_deep.expected.json"
    repro_torch.build(str(deep)).save(work / "xgb_deep")
    py = [sys.executable, "-m"]
    cmds = {}
    for dump in sorted(p for p in FIXTURES.iterdir()
                       if p.suffix in (".json", ".txt") and ".expected" not in p.name):
        exp = FIXTURES / (dump.name.rsplit(".", 1)[0] + ".expected.json")
        cmds[f"ingest {dump.name}"] = py + ["repro_torch.cli.ingest", str(dump), "--out",
                                            str(work / f"g_{dump.stem}"), "--expected", str(exp)]
    cmds["score xgb_deep"] = py + [
        "repro_torch.cli.score", str(work / "xgb_deep"),
        str(ROOT / "tests" / "fixtures" / "score" / "xgb_deep_x.npy"),
        "--expected", str(golden), "--chunk-rows", "10"]
    cmds["ingest --autotune"] = py + ["repro_torch.cli.ingest", str(deep), "--out",
                                      str(work / "deep_tuned"), "--autotune", "1,256"]
    for ex in ("torch_quickstart", "torch_ingest_quickstart", "torch_xtime_serving",
               "torch_xtime_cluster"):
        cmds[ex] = [sys.executable, str(ROOT / "examples" / f"{ex}.py")]
    # one host thread a process: 14 processes with a thread pool the size
    # of the host each would oversubscribe its cores
    results = run_together(list(cmds.values()), {**env, "OMP_NUM_THREADS": "1"}, timeout=300)
    for (label, cmd), (rc, out, err, secs) in zip(cmds.items(), results):
        if rc != 0 or ("--expected" in cmd and "[verify]  OK" not in out):
            fail(f"{label}: rc {rc}\n{out[-2000:]}{err[-2000:]}")
        last = out.strip().splitlines()[-1] if out.strip() else ""
        print(f"tools [{name}] {label}: rc 0, {secs:.1f} s (all {len(cmds)} started together); "
              f"{last}", flush=True)
    plan = repro_torch.CompiledModel.load(work / "deep_tuned").tune_plan()
    if plan is None or not plan.timed_on("cuda") or [e["batch"] for e in plan.dispatch] != [1, 256]:
        fail("ingest --autotune: the saved artifact carries no plan timed on the card")

    xs, want = stats["score_rows"]
    rows, out_path = work / "rows.npy", work / "preds.npy"
    np.save(rows, xs)
    (rc, out, err, secs), = run_together(
        [py + ["repro_torch.cli.score", str(tuned_base), str(rows), "--out", str(out_path),
               "--chunk-rows", str(SCORE_CHUNK)]], env, timeout=300)
    if rc != 0 or not np.array_equal(np.load(out_path), want):
        fail(f"score --out at full width: rc {rc}, output == cm.predict: "
             f"{rc == 0 and np.array_equal(np.load(out_path), want)}\n{out}{err}")
    print(f"tools [{name}] score --out of the tuned full-width artifact, {SCORE_ROWS} x 130 "
          f"uint8 rows, chunk rows {SCORE_CHUNK}: rc 0, {secs:.1f} s in all; == cm.predict; "
          + " | ".join(out.strip().splitlines()), flush=True)


# -- phase 9: the multi-device engine, and checkpoint and restart -----------------------


MESH_PROGRAMS = [("accumulate", "shard_map"), ("batch", "shard_map"), ("hybrid", "shard_map"),
                 ("accumulate", "gspmd"), ("batch", "gspmd")]
MESH_REQUESTS = 500  # the head of phase 6's trace, replayed on the mesh
CARD = torch.device("cuda", 0)  # the card every logical shard shares


SPIN_CYCLES = 10_000_000  # ~5 ms of device spin: longer than the host takes to enqueue a call


def program_ms(fn, iters: int = 11) -> tuple[float, float, float]:
    """Median milliseconds of one call of ``fn`` (after a warm-up), three
    ways: the whole call as its caller sees it — CUDA events around it on
    an idle card, so the host's time to enqueue it counts; the card's time
    alone — a device spin before the first event lets the host enqueue the
    whole call first, as ``cold_time`` does; and the host's time to enqueue
    it (host clock, no synchronize)."""
    fn()
    whole, device, host = [], [], []
    for _ in range(iters):
        for spin, times in ((0, whole), (SPIN_CYCLES, device)):
            torch.cuda.synchronize()
            if spin:
                torch.cuda._sleep(spin)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            fn()
            if not spin:
                host.append((time.perf_counter() - t0) * 1e3)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    return tuple(float(np.median(t)) for t in (whole, device, host))


def card_mesh(shape=(2, 4), axes=("data", "model")):
    """A mesh of logical shards that all share the one card."""
    from repro_torch.launch.mesh import Mesh

    grid = np.empty(8, dtype=object)
    grid[:] = [CARD] * 8
    return Mesh(grid.reshape(shape), axes)


def table_bytes(a) -> int:
    """Bytes of one copy of what the kernels read: the tables and the cell
    list (with its packed words, for uint8)."""
    c = a.cells
    return sum(t.numel() * t.element_size()
               for t in (a.low, a.high, a.leaf, c.count, c.feat, c.lo, c.hi, c.words)
               if t is not None)


def counted_call(fn, per_call: int, label: str):
    """``fn()`` with the hard and soft kernels' launches counted: exactly
    ``per_call`` (one a shard), or the run fails."""
    before = K.cam_match_cuda.launches + K.cam_match_soft_cuda.launches
    out = fn()
    n = K.cam_match_cuda.launches + K.cam_match_soft_cuda.launches - before
    if n != per_call:
        fail(f"{label}: {n} kernel launches, want {per_call} (one a shard)")
    return out


def phase_mesh(ens, cm, batches, name) -> None:
    """Phase 9, step 1: every NoC program at full width on 8 logical shards
    of the card, bit-equal to the single-device engine and the traversal."""
    mesh = card_mesh()
    one = cm.engine()
    want_m = {b: cm.raw_margin(x) for b, x in batches.items()}
    want_p = {b: cm.predict(x) for b, x in batches.items()}
    trav = {b: ens.raw_margin(x[:64]) for b, x in batches.items()}
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    engines = {prog: cm.engine(mesh=mesh, noc_config=prog[0], spmd=prog[1])
               for prog in MESH_PROGRAMS}
    torch.cuda.synchronize()
    bind_s = time.perf_counter() - t0
    held = (torch.cuda.memory_allocated() - m0) / len(engines)
    copy = table_bytes(engines[MESH_PROGRAMS[0]].arrays)
    if not copy <= held <= 1.02 * copy + (1 << 20):
        fail(f"mesh: an engine holds {held:.0f} bytes on the card, one copy of its table is "
             f"{copy} (logical shards must be views of one copy)")
    print(f"mesh [{name}] (2, 4) mesh of 8 logical shards of the card; {len(engines)} engines "
          f"bound in {bind_s:.1f} s (host); each holds {held:.0f} bytes on the card, one copy "
          f"of its table {copy} (shards are views), the single-device engine "
          f"{table_bytes(one.arrays)} + tile mask + bias", flush=True)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()  # count only the mesh path's launches
    for (noc, spmd), eng in engines.items():
        if (eng.noc_config, eng.spmd, eng.fuse_epilogue) != (noc, spmd, False):
            fail(f"mesh {noc}/{spmd}: engine resolved to {eng.noc_config}/{eng.spmd}, "
                 f"fused bias {eng.fuse_epilogue}")
        rows = {s.low.shape[0] for row in eng.shards for s in row}
        for b, x in batches.items():
            m = counted_call(lambda: cm.raw_margin(x, mesh=mesh, noc_config=noc, spmd=spmd),
                             mesh.size, f"mesh {noc}/{spmd} raw_margin B={b}")
            p = counted_call(lambda: cm.predict(x, mesh=mesh, noc_config=noc, spmd=spmd),
                             mesh.size, f"mesh {noc}/{spmd} predict B={b}")
            if not (np.array_equal(m, want_m[b]) and np.array_equal(p, want_p[b])):
                fail(f"mesh {noc}/{spmd} B={b}: differs from the single-device engine")
            if not np.array_equal(m[:64], trav[b]):
                fail(f"mesh {noc}/{spmd} B={b}: margins differ from Ensemble.raw_margin")
        print(f"mesh [{name}] {noc}/{spmd}: rows a shard {sorted(rows)}, batch_multiple "
              f"{eng.batch_multiple}; raw_margin + predict at B = 1, 37, 256, 1024 == the "
              f"single-device engine (all rows) and Ensemble.raw_margin (64 rows), "
              f"{mesh.size} launches a call", flush=True)
    torch.cuda.synchronize()
    launches = K.cam_match_cuda.launches
    if launches == 0:
        fail("mesh: the mesh path never launched the cam_match kernel")
    print(f"mesh [{name}] mesh path: {launches} cam_match launches over "
          f"{2 * len(batches) * len(engines)} calls; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)

    x = batches[256]
    q1 = one._prep_queries(x)
    base = program_ms(lambda: one._margin_padded(q1))
    times = {}
    for (noc, spmd), eng in engines.items():
        qp = eng._prep_queries(x)
        times[f"{noc}/{spmd}"] = program_ms(lambda: eng._margin_padded(qp))
    print(f"mesh [{name}] B=256 median ms a call — whole call on an idle card / the card "
          f"alone (enqueued behind a spin) / the host's enqueue (host clock); CUDA events, warm; "
          f"8 logical shards of one card, so the partitioned program's own cost, not "
          f"scale-out; queries on the card: single device "
          f"{base[0]:.4f} / {base[1]:.4f} / {base[2]:.4f}; " + "; ".join(
              f"{k} {w:.4f} / {d:.4f} / {h:.4f} (card alone {d / base[1]:.3f}x)"
              for k, (w, d, h) in times.items()), flush=True)

    # the axis-order trap: the batch splits by the batch spec, not the mesh's order
    trap = card_mesh((4, 2), ("model", "data"))
    eng = cm.engine(mesh=trap, noc_config="accumulate")
    got = counted_call(lambda: cm.raw_margin(x, mesh=trap, noc_config="accumulate"), 8,
                       "mesh (4, 2) ('model', 'data')")
    if not np.array_equal(got, want_m[256]) or len(eng.shards) != 2:
        fail("mesh (4, 2) ('model', 'data') accumulate: differs from the single-device engine")
    print(f"mesh [{name}] (4, 2) mesh with axes ('model', 'data'), accumulate: 2 batch "
          f"groups over 'data' x 4 row shards over 'model'; B=256 == the single-device "
          f"engine, 8 launches", flush=True)

    # the dry-run hook: its fn runs the placed table through the kernels
    specs = {}
    for (noc, spmd), eng in engines.items():
        fn, ins, out_spec = eng.serve_step_for_dryrun()
        spec, q = eng.input_specs(256), eng._prep_queries(x)
        if (q.shape, q.dtype, spec.device.type) != (spec.shape, spec.dtype, "meta"):
            fail(f"dry-run hook {noc}/{spmd}: input_specs(256) {spec} is not the padded "
                 f"queries' {tuple(q.shape)} {q.dtype}")
        a = eng.arrays
        got = counted_call(lambda: fn(q, a.low, a.high, a.leaf, a.cells), mesh.size,
                           f"dry-run hook {noc}/{spmd}")
        if not torch.equal(got[:256], eng.raw_margin(x)):
            fail(f"dry-run hook {noc}/{spmd}: fn differs from engine.raw_margin")
        specs[noc] = (tuple(ins[0]), tuple(ins[1]))
    print(f"mesh [{name}] dry-run hook: serve_step_for_dryrun()'s fn on input_specs(256) "
          f"queries == engine.raw_margin bit for bit under every program, {mesh.size} kernel "
          f"launches a call; (batch, row) specs {specs}", flush=True)


def uncertainty_bound(mom: np.ndarray, dmom: np.ndarray, C: int) -> np.ndarray:
    """(B, C) limit on |uncertainty - uncertainty'| when the float32 moments
    ``[m1 | m2 | mass]`` agree within ``dmom``: to first order
    ``|d var| <= (d m2 + (m2/mass) d mass + 2|mean| (d m1 + |mean| d mass))
    / mass``, a factor 2 for the second-order terms; the std moves by at
    most ``min(sqrt|d var|, |d var| / std)``, and each side's float32 cast
    by ``u std`` (tests/test_torch_soft.py derives the same)."""
    m1, m2 = mom[:, :C], mom[:, C:2 * C]
    mass = np.maximum(mom[:, 2 * C:3 * C], 1e-12)
    d1, d2, dmass = dmom[:, :C], dmom[:, C:2 * C], dmom[:, 2 * C:3 * C]
    mean = np.abs(m1 / mass)
    dvar = 2.0 * (d2 + (m2 / mass) * dmass + 2.0 * mean * (d1 + mean * dmass)) / mass
    std = np.sqrt(np.maximum(m2 / mass - mean * mean, 0.0))
    return np.minimum(np.sqrt(dvar), dvar / np.maximum(std, 1e-300)) + 2.0 * F32_EPS * std


def phase_mesh_soft(cm, soft, batches, name) -> None:
    """Phase 9, step 2: the soft tau = 0.1 artifact on the (2, 4) mesh,
    within the derived bound of the single-device engine; tau = 0 bit-equal
    to the hard ('direct'-equal) margins."""
    mesh = card_mesh()
    t0 = time.perf_counter()
    eng, one = soft.engine(mesh=mesh), soft.engine()
    bind_s = time.perf_counter() - t0
    a = one.arrays
    extra = K.n_splits(a.r_pad) + 8  # the split merges, the shard adds, the bias add
    reset_launches()
    worst = 0.0
    for b in (1, 37):
        x = batches[b]
        qp = one._prep_queries(x)
        scores = ref.soft_scores_ref(qp, a.low, a.high, tau=SOFT_TAU)
        lim = ref.summation_bound(scores, a.leaf, extra)[:, :8].cpu().numpy()
        dmom = ref.summation_bound(scores, one._moments, extra)[:, :24].cpu().numpy()
        m = counted_call(lambda: soft.raw_margin(x, mesh=mesh), 8, f"soft mesh B={b}")
        err = np.abs(m.astype(np.float64) - one.raw_margin(x).cpu().numpy())
        p = counted_call(lambda: soft.predict_proba(x, mesh=mesh), 8, f"soft mesh proba B={b}")
        perr = np.abs(p.astype(np.float64) - soft.predict_proba(x))
        plim = 0.5 * lim.max(axis=1, keepdims=True) + 2.0 * 2.0 ** -24
        mom = counted_call(lambda: eng.raw_moments(x), 8, f"soft mesh moments B={b}")
        mom1 = one.raw_moments(x).cpu().numpy().astype(np.float64)
        merr = np.abs(mom.cpu().numpy() - mom1)
        u = counted_call(lambda: eng.uncertainty(x), 8, f"soft mesh uncertainty B={b}")
        uerr = np.abs(u.numpy().astype(np.float64) - one.uncertainty(x).numpy())
        ulim = uncertainty_bound(mom1, dmom, 8)
        for label, e, l in (("margins", err, lim), ("predict_proba", perr, plim),
                            ("raw_moments", merr, dmom), ("uncertainty", uerr, ulim)):
            if (e > l).any():
                fail(f"soft mesh B={b}: {label} off the single-device engine by "
                     f"{e.max()}, worst err/bound {(e / l).max()}")
            worst = max(worst, float((e / l).max()))
    # tau = 0: the exact limit, bit-equal to the hard main path ('direct' bits)
    for b in (37, 256):
        m0 = counted_call(lambda: soft.raw_margin(batches[b], mesh=mesh, tau=0.0), 8,
                          f"soft mesh tau=0 B={b}")
        if not np.array_equal(m0, cm.raw_margin(batches[b])):
            fail(f"soft mesh tau=0 B={b}: margins differ from the hard main path")
    print(f"mesh [{name}] soft tau={SOFT_TAU} on the (2, 4) mesh (bound in {bind_s:.1f} s, "
          f"host): margins, predict_proba, raw_moments and uncertainty at "
          f"B = 1, 37 within the derived bound of the single-device engine (summation bound, "
          f"extra {extra}; worst err/bound {worst:.3g}); tau=0 == the hard main path at "
          f"B = 37, 256; {K.cam_match_soft_cuda.launches} soft launches", flush=True)


def phase_mesh_tiers(cm, name, stats) -> None:
    """Phase 9, step 3: the tiers on the (2, 4) mesh, each equal to phase 6."""
    from dataclasses import replace

    from repro_torch.score import score_file
    from repro_torch.serve import ClusterServer, ServeLoop, TableRegistry, replay_trace

    mesh = card_mesh()
    xs_score, want_score = stats["score_rows"]
    with tempfile.TemporaryDirectory() as tmp:
        cm.save(Path(tmp) / "xtime")
        loaded = repro_torch.CompiledModel.load(Path(tmp) / "xtime")
        x = xs_score[:1024]
        if not np.array_equal(loaded.predict(x, mesh=mesh), want_score[:1024]):
            fail("mesh: save -> load -> engine(mesh=) predictions differ")
        del loaded
        print(f"mesh [{name}] save -> load -> engine(mesh=) at B=1024 == cm.predict", flush=True)

        trace, xs = serve_trace()
        trace = replace(trace, requests=trace.requests[:MESH_REQUESTS])
        want = np.concatenate(stats["serve_results"][:MESH_REQUESTS])
        reg = TableRegistry(mesh=mesh)
        if reg.register("xtime", cm).engine is not cm.engine(mesh=mesh):
            fail("mesh serving: the registry bound a second engine")
        loop = ServeLoop(reg, flush_rows=256)
        reset_launches()
        res = replay_trace(loop.submit, trace, {"xtime": xs}, speed=1.0)
        loop.drain()
        launches = counted("mesh serving")
        if not np.array_equal(np.concatenate([loop.result(h) for h in res.handles]), want):
            fail("mesh serving: ServeLoop results differ from phase 6's")
        print(f"mesh [{name}] TableRegistry(mesh=) + ServeLoop(flush_rows=256), the first "
              f"{MESH_REQUESTS} requests of phase 6's trace at its pace: "
              f"{latency(loop.stats('xtime'))}; {launches} launches; == phase 6", flush=True)

        with ClusterServer(n_replicas=2, mesh=mesh, flush_rows=256) as srv:
            srv.register("xtime", cm)
            reset_launches()
            res = replay_trace(srv.submit, trace, {"xtime": xs}, speed=1.0)
            srv.drain(timeout=120)
            launches = counted("mesh cluster")
            got = np.concatenate([h.result(10) for h in res.handles])
            s = srv.stats("xtime")
        if not np.array_equal(got, want):
            fail("mesh cluster: results differ from phase 6's")
        print(f"mesh [{name}] ClusterServer(mesh=, n_replicas=2), the same requests: "
              f"{latency(s)}; {launches} launches; == phase 6", flush=True)

        path = Path(tmp) / "rows.npy"
        np.save(path, xs_score)
        reset_launches()
        r = score_file(cm, path, kind="predict", chunk_rows=SCORE_CHUNK, mesh=mesh)
        launches = counted("mesh scoring")
        if not np.array_equal(r.values, want_score) or launches != 8 * r.n_chunks:
            fail(f"mesh scoring: == cm.predict {np.array_equal(r.values, want_score)}, "
                 f"{launches} launches for {r.n_chunks} chunks")
        print(f"mesh [{name}] score_file(mesh=) {SCORE_ROWS} x 130 rows, chunk_rows "
              f"{SCORE_CHUNK} (bucket {r.bucket}), {r.engine['noc_config']}/{r.engine['spmd']} "
              f"over {r.engine['devices']} shards: {r.rows_per_s} rows/s ({r.elapsed_s} s, "
              f"{launches} launches); phase 6 on one device: "
              f"{', '.join(str(v) for v in stats['score_rps'])} rows/s; == cm.predict",
              flush=True)


def phase_checkpoint(name) -> None:
    """Phase 9, step 5: checkpoint and restart on the card."""
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.ft.runtime import FaultTolerantRunner, InjectedFailure

    dev = CARD
    g = torch.Generator(device=dev).manual_seed(SEED)
    tree = {"params": {"w": torch.randn(1024, 512, device=dev, generator=g),
                       "emb": torch.randn(4096, 64, device=dev, generator=g).to(torch.bfloat16)},
            "opt": {"step": torch.arange(1000, device=dev, dtype=torch.int64)}}
    mesh = card_mesh()
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(tmp, 3, tree)
        _, back = restore_checkpoint(tmp, tree)
        _, placed = restore_checkpoint(tmp, tree, placer=lambda t: [
            {k: v.to(d) for k, v in t["params"].items()} for d in mesh.devices.flat])
        for t, leaves in ((back["params"], "card"), *((p, "mesh device") for p in placed)):
            for k, v in t.items():
                want = tree["params"][k]
                if not (v.device == dev and v.dtype == want.dtype and torch.equal(v, want)):
                    fail(f"checkpoint: {k} restored onto the {leaves} differs")
        step_leaf = back["opt"]["step"]
        if not (step_leaf.device == dev and torch.equal(step_leaf, tree["opt"]["step"])):
            fail("checkpoint: the int64 leaf differs")

        def step(state, i):
            new = {"x": state["x"] * 1.01 + i, "n": state["n"] + 1}
            return new, {"loss": float(new["x"].sum())}

        def init():
            return {"x": torch.ones(256, device=dev), "n": torch.zeros((), dtype=torch.int32,
                                                                       device=dev)}

        run, ref_dir = str(Path(tmp) / "run"), str(Path(tmp) / "ref")
        try:
            FaultTolerantRunner(run, step, init, ckpt_every=5).run(20, failure_at=12)
            fail("checkpoint: the injected failure did not stop the run")
        except InjectedFailure:
            pass
        s2, h2 = FaultTolerantRunner(run, step, init, ckpt_every=5).run(20)
        s3, h3 = FaultTolerantRunner(ref_dir, step, init, ckpt_every=5).run(20)
        by_step = {h["step"]: h["loss"] for h in h3}
        if not (s2["x"].device == dev and torch.equal(s2["x"], s3["x"]) and h2[0]["step"] == 10
                and all(h["loss"] == by_step[h["step"]] for h in h2)):
            fail("checkpoint: the resumed run's history differs from an uninterrupted run's")
    print(f"checkpoint [{name}] nested CUDA tensors (float32, bfloat16, int64) saved and "
          f"restored onto the card and onto the mesh's devices through a placer, bit-exact; "
          f"FaultTolerantRunner on the card crashed after step 12, resumed from step 10, "
          f"history == an uninterrupted run's", flush=True)


def start_entry_points() -> tuple[dict, list, float]:
    """The two entry points that need a mesh, as subprocesses on the card."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "2"
    cmds = {"paper_scale_smoke": [sys.executable, "-m", "repro_torch.tools.paper_scale_smoke"],
            "torch_xtime_multichip": [sys.executable,
                                      str(ROOT / "examples" / "torch_xtime_multichip.py")]}
    return cmds, start_together(list(cmds.values()), env), time.perf_counter()


def finish_entry_points(started, name) -> None:
    cmds, procs, t0 = started
    for label, (rc, out, err, secs) in zip(cmds, wait_together(procs, t0, timeout=300)):
        if rc != 0:
            fail(f"{label}: rc {rc}\n{out[-2000:]}{err[-2000:]}")
        print(f"mesh [{name}] {label} on the card: rc 0, {secs:.1f} s (both started "
              f"together); " + " | ".join(out.strip().splitlines()), flush=True)


def phase_mesh_all(ens, cm, soft, batches, name, stats) -> None:
    """Phase 9: the mesh path, the tiers on it, then the two entry points
    (in the background, once the timed steps are done), soft on the mesh
    and checkpoint and restart."""
    phase_mesh(ens, cm, batches, name)
    phase_mesh_tiers(cm, name, stats)
    started = start_entry_points()
    try:
        phase_mesh_soft(cm, soft, batches, name)
        phase_checkpoint(name)
    finally:
        finish_entry_points(started, name)


# -- phase 10: LM serving ----------------------------------------------------------------

LM_BATCH, LM_PROMPT, LM_NEW = 4, 128, 32
BF16_FLOPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak (data sheet)
FIXTURE_LM = ROOT / "tests" / "fixtures" / "torch_lm"
FIXTURE_TRANSFORMERS = ["llama3.2-3b", "gemma3-1b", "deepseek-v3-671b", "llava-next-mistral-7b"]
FIXTURE_FAMILIES = ["zamba2-2.7b", "rwkv6-1.6b", "whisper-tiny"]
WHISPER_FRAMES, WHISPER_PROMPT = 1500, 64  # the 30 s window; the decoder's prompt
LONG_PROMPT = 4096  # phase 11's long prompt: 32 SSD chunks of 128, 256 WKV chunks of 16


def lm_free() -> None:
    """Return the cached blocks of the models just dropped to the card."""
    gc.collect()
    torch.cuda.empty_cache()


def lm_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    """max|got - ref| / max|ref| in float64 on the host."""
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30))


def lm_param_bytes(params, cfg, batch: int) -> int:
    """Bytes of the parameters one decode step must read: every weight but
    the mtp block (and whisper's encoder and cross k/v projections, used at
    prefill only), the untied embedding's gathered rows only (whisper's
    head is its embedding), and of each MoE layer's experts at most batch
    x top_k (the routed ones)."""
    total = 0
    for key, p in params.named_parameters():
        n = p.numel() * p.element_size()
        if key.startswith(("mtp.", "enc.", "enc_norm")) or key.endswith(("xattn.wk",
                                                                        "xattn.wv")):
            continue
        if key == "embed" and not (cfg.tie_embeddings or cfg.is_encoder_decoder):
            n = batch * p.shape[1] * p.element_size()
        elif ".ffn.w_" in key and p.ndim == 3:  # (E, ., .) expert weights
            n = n * min(cfg.n_experts, batch * cfg.moe_top_k) // cfg.n_experts
        total += n
    return total


def lm_kv_bytes(cfg, batch: int, pos: int) -> int:
    """Cache bytes attention must read at position ``pos`` (each layer's
    window where it has one)."""
    per_pos = ((cfg.kv_lora_rank + cfg.qk_rope_dim) if cfg.use_mla
               else 2 * cfg.n_kv_heads * cfg.resolved_head_dim)
    item = torch.tensor([], dtype=lm_common.dtype_of(cfg.dtype)).element_size()
    total = 0
    for kind, n, off in lm_transformer.segments_of(cfg):
        windows, _ = lm_transformer.layer_meta(cfg, n, off)
        total += sum(min(int(w), pos + 1) if w > 0 else pos + 1 for w in windows)
    return total * per_pos * item * batch


def lm_state_bytes(cfg, batch: int, pos: int, enc_len: int = 0) -> int:
    """State and cache bytes a decode step at ``pos`` must move: the
    recurrent states read and written (zamba2's ssm and conv states, rwkv's
    S and token shifts), attention's k/v read (zamba2's shared block once a
    group, whisper's self and cross caches), else ``lm_kv_bytes``."""
    item = torch.tensor([], dtype=lm_common.dtype_of(cfg.dtype)).element_size()
    if cfg.family == "hybrid":
        _, h, conv_dim = lm_mamba2.dims(cfg)
        ssm = h * cfg.ssm_head_dim * cfg.ssm_state * 4 + (cfg.ssm_conv_width - 1) * conv_dim * item
        kv = (pos + 1) * 2 * cfg.n_kv_heads * cfg.resolved_head_dim * item
        return batch * (2 * cfg.n_layers * ssm + cfg.n_layers // cfg.shared_attn_period * kv)
    if cfg.family == "ssm":
        h = cfg.d_model // cfg.rwkv_head_dim
        per_layer = h * cfg.rwkv_head_dim ** 2 * 4 + 2 * cfg.d_model * item
        return batch * 2 * cfg.n_layers * per_layer
    if cfg.is_encoder_decoder:
        return (batch * cfg.n_layers * (pos + 1 + enc_len) * 2 * cfg.n_kv_heads
                * cfg.resolved_head_dim * item)
    return lm_kv_bytes(cfg, batch, pos)


def lm_on_card(bundle, batch: dict) -> dict:
    """A prompt dict (numpy) on the model's device: integers as int64,
    floats (embeddings, frames) in the model's dtype."""
    return lm_train.on_device(batch, bundle.device, lm_common.dtype_of(bundle.cfg.dtype))


def lm_times(bundle, params, batch, toks) -> tuple[float, list[float]]:
    """CUDA-event ms of the prefill of ``batch`` (a prompt dict; median of
    3) and of each decode step of ``toks`` fed back (the work of a greedy
    run), on the card."""
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    with torch.inference_mode():
        p = lm_on_card(bundle, batch)
        t = torch.as_tensor(toks, device=bundle.device).long()
        s, n = p["tokens"].shape[1], t.shape[1]
        pre = []
        for _ in range(3):
            a, b = ev(), ev()
            a.record()
            _, cache = bundle.prefill(params, p)
            b.record()
            pre.append((a, b))
        cache = lm_serve._pad_cache_seq(bundle.cfg, cache, s, s + n)
        steps = []
        for i in range(n - 1):
            a, b = ev(), ev()
            a.record()
            bundle.decode_step(params, cache, t[:, i], s + i)
            b.record()
            steps.append((a, b))
        torch.cuda.synchronize()
    pre_ms = float(np.median([a.elapsed_time(b) for a, b in pre]))
    return pre_ms, [a.elapsed_time(b) for a, b in steps]


def lm_device_ms(bundle, params, batch, toks, steps: int = 4) -> tuple[float, float]:
    """Device time and kernels a decode step, from ``torch.profiler`` over
    ``steps`` steps fed ``toks`` after the prompt dict ``batch`` (NaN where
    the trace holds no device event)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        p = lm_on_card(bundle, batch)
        t = torch.as_tensor(toks, device=bundle.device).long()
        s = p["tokens"].shape[1]
        _, cache = bundle.prefill(params, p)
        cache = lm_serve._pad_cache_seq(bundle.cfg, cache, s, s + steps + 1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(steps):
                bundle.decode_step(params, cache, t[:, i], s + i)
            torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return float("nan"), float("nan")
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    return busy_us / 1e3 / steps, len(kernels) / steps


def whisper_frames(cfg, batch: int, seed: int) -> np.ndarray:
    """(batch, 1,500, d_model) stub frame embeddings from a numpy seed."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((batch, WHISPER_FRAMES, cfg.d_model)).astype(np.float32)


def lm_prompt(cfg, batch: int, prompt_len: int, seed: int) -> dict:
    """Token prompts, and whisper's frames beside its decoder prompt."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, prompt_len))}
    if cfg.is_encoder_decoder:
        out["frames"] = whisper_frames(cfg, batch, seed + 1)
    return out


def lm_greedy(bundle, params, batch: dict, n: int) -> np.ndarray:
    """``n`` greedy tokens: ``generate`` for token prompts, else (whisper)
    ``prefill`` + ``decode_step`` fed each argmax, as a user serves it."""
    if set(batch) == {"tokens"}:
        return lm_serve.generate(bundle, params, batch["tokens"], max_new=n)
    with torch.inference_mode():
        p = lm_on_card(bundle, batch)
        s = p["tokens"].shape[1]
        logits, cache = bundle.prefill(params, p)
        cache = lm_serve._pad_cache_seq(bundle.cfg, cache, s, s + n)
        out = [logits.argmax(-1)]
        for i in range(n - 1):
            logits, cache = bundle.decode_step(params, cache, out[-1], s + i)
            out.append(logits.argmax(-1))
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()


def lm_serve_run(label, cfg, prompt_len, name, stats, seed=0) -> tuple:
    """A model at full width from the port's seeded initialiser: B = 4
    prompts served greedily twice (bit-equal), prefill and decode steps
    timed beside their bounds; for the O(1)-state families also one
    4,096-token prompt at B = 1.  Appends an ``lm`` line to stats and
    returns what ``lm_profile`` takes."""
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    bundle = lm_build(cfg)
    params = bundle.init_params(seed)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    batch = lm_prompt(cfg, LM_BATCH, prompt_len, SEED + 20)
    runs = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = lm_greedy(bundle, params, batch, LM_NEW)
        runs.append((toks, time.perf_counter() - t0))
    peak = torch.cuda.max_memory_allocated() - base
    if not np.array_equal(runs[0][0], runs[1][0]):
        fail(f"{label}: two greedy runs differ")
    toks = runs[0][0]
    if toks.shape != (LM_BATCH, LM_NEW) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"{label}: generated tokens of shape {toks.shape} outside the vocabulary")
    pre_ms, steps = lm_times(bundle, params, batch, toks)
    step_ms = float(np.median(steps))
    gen_s = min(r[1] for r in runs)
    enc_len = WHISPER_FRAMES if cfg.is_encoder_decoder else 0
    pbytes = lm_param_bytes(params, cfg, LM_BATCH)
    state = float(np.mean([lm_state_bytes(cfg, LM_BATCH, prompt_len + i, enc_len)
                           for i in range(LM_NEW - 1)]))
    dec_bound = (pbytes + state) / HBM_BYTES_PER_S * 1e3
    # whisper's prefill cell: the frames are its sequence (model_flops' rule)
    cell_len = WHISPER_FRAMES if cfg.is_encoder_decoder else prompt_len
    flops = lm_flops.model_flops(cfg, ShapeCell("prefill", cell_len, LM_BATCH, "prefill"),
                                 bundle)
    all_bytes = sum(p.numel() * p.element_size() for k, p in params.named_parameters()
                    if not k.startswith("mtp."))
    pre_ops, pre_bytes = flops / BF16_FLOPS_PER_S * 1e3, all_bytes / HBM_BYTES_PER_S * 1e3
    pre_bound, pre_by = max((pre_ops, "operations"), (pre_bytes, "bytes"))
    line = {"model": label, "dtype": cfg.dtype, "layers": cfg.n_layers, "batch": LM_BATCH,
            "prompt": prompt_len, "frames": enc_len or None, "new": LM_NEW,
            "init_s": t_init, "generate_s": [r[1] for r in runs],
            "tokens_per_s": LM_BATCH * LM_NEW / gen_s, "prefill_ms": pre_ms,
            "prefill_bound_ms": pre_bound, "prefill_bound_by": pre_by,
            "prefill_ops_ms": pre_ops, "prefill_bytes_ms": pre_bytes,
            "prefill_share": pre_bound / pre_ms, "decode_ms": step_ms,
            "decode_ms_min": min(steps), "decode_ms_max": max(steps),
            "decode_bound_ms": dec_bound, "decode_share": dec_bound / step_ms,
            "param_bytes_read": pbytes, "state_bytes_moved": state, "model_flops": flops,
            "peak_bytes": peak, "card": name}
    print(f"lm [{name}] {label}: {cfg.n_layers} layers {cfg.dtype}, init {t_init:.1f} s; "
          f"B={LM_BATCH} prompt {prompt_len}" + (f" + {enc_len} frames" if enc_len else "")
          + f" + {LM_NEW} new greedy {runs[0][1]:.3f} / {runs[1][1]:.3f} s (bit-equal), "
          f"{line['tokens_per_s']:.1f} tokens/s; prefill {pre_ms:.3f} ms (bound "
          f"{pre_bound:.3f} ms by {pre_by}, {100 * pre_bound / pre_ms:.1f}%); decode "
          f"{step_ms:.3f} ms/step median ({min(steps):.3f}-{max(steps):.3f}; bound "
          f"{dec_bound:.3f} ms, {100 * dec_bound / step_ms:.1f}%); peak {peak / 2**30:.2f} GiB",
          flush=True)
    if cfg.family in ("hybrid", "ssm"):
        long = lm_prompt(cfg, 1, LONG_PROMPT, SEED + 21)
        long_toks = np.random.default_rng(SEED + 22).integers(0, cfg.vocab_size, (1, 9))
        torch.cuda.reset_peak_memory_stats()
        long_pre, long_steps = lm_times(bundle, params, long, long_toks)
        long_peak = torch.cuda.max_memory_allocated() - base
        line.update(long_prompt=LONG_PROMPT, long_prefill_ms=long_pre,
                    long_decode_ms=float(np.median(long_steps)), long_peak_bytes=long_peak)
        print(f"lm [{name}] {label}: B=1 prompt {LONG_PROMPT}: prefill {long_pre:.3f} ms, "
              f"decode {line['long_decode_ms']:.3f} ms/step median of 8 (prompt "
              f"{prompt_len} at B={LM_BATCH}: {step_ms:.3f}); peak "
              f"{long_peak / 2**30:.2f} GiB", flush=True)
    stats.setdefault("lm", []).append(line)
    del bundle, params
    lm_free()
    return label, cfg, prompt_len, line


def lm_decode_equals_forward(label, cfg, batch_size, prompt_len, name, seed=1) -> None:
    """Float32: a greedy run's teacher-forced steps give its tokens, and a
    prefill over prompt + generated[:-1] gives the last step's logits
    within 2e-3 of their largest and the last token as argmax."""
    bundle = lm_build(cfg)
    params = bundle.init_params(seed)
    batch = lm_prompt(cfg, batch_size, prompt_len, SEED + 23)
    toks = lm_greedy(bundle, params, batch, LM_NEW)
    steps = lm_serve.teacher_forced(bundle, params, batch, toks)
    if not np.array_equal(steps.argmax(-1).T.cpu().numpy(), toks):
        fail(f"{label}: the teacher-forced decode's argmax differs from the greedy tokens")
    full = {**batch, "tokens": np.concatenate([batch["tokens"], toks[:, :-1]], axis=1)}
    with torch.inference_mode():
        logits, _ = bundle.prefill(params, lm_on_card(bundle, full))
    if not np.array_equal(logits.argmax(-1).cpu().numpy(), toks[:, -1]):
        fail(f"{label}: the last greedy token != argmax of prefill over the sequence")
    err = lm_rel(steps[-1], logits)
    if not err < 2e-3:
        fail(f"{label}: decode logits vs the full forward max|d|/max|ref| {err:.3g} >= 2e-3")
    print(f"lm [{name}] {label} float32 B={batch_size}: greedy last token == argmax of prefill "
          f"over {full['tokens'].shape[1]} tokens; decode vs full forward max|d|/max|ref| "
          f"{err:.3g} (< 2e-3)", flush=True)
    del bundle, params, steps, logits
    lm_free()


def lm_card_equals_cpu(label, cfg, name) -> None:
    """Float32, TF32 off: prefill and 4 teacher-forced decode steps on the
    card within 1e-4 of the port on the CPU, one set of weights."""
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on for float32 products")
    bundle = lm_build(cfg)
    params = bundle.init_params(2)
    batch = lm_prompt(cfg, 2, 32, SEED + 24)
    nxt = np.random.default_rng(SEED + 25).integers(0, cfg.vocab_size, (2, 5))
    t0 = time.perf_counter()
    got = lm_serve.teacher_forced(bundle, params, batch, nxt).cpu()
    on_cpu = lm_build(cfg, "cpu")
    params_cpu = on_cpu.model.empty_params()
    params_cpu.load_state_dict(params.state_dict())
    ref = lm_serve.teacher_forced(on_cpu, params_cpu, batch, nxt)
    err = lm_rel(got, ref)
    if not err < 1e-4:
        fail(f"{label} card vs CPU: max|d|/max|ref| {err:.3g} >= 1e-4")
    print(f"lm [{name}] {label} float32 B=2 S=32: prefill + 4 teacher-forced decode steps: "
          f"card vs CPU max|d|/max|ref| {err:.3g} (< 1e-4), TF32 off "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    del bundle, params, params_cpu
    lm_free()


def lm_profile(label, cfg, prompt_len, name, line, seed=0) -> None:
    """The card's busy time and kernels a decode step (``torch.profiler``),
    after every timed run: a profiler run may leave its tracing hooks
    on the launches that follow it."""
    bundle = lm_build(cfg)
    params = bundle.init_params(seed)
    rng = np.random.default_rng(SEED + 13)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (LM_BATCH, prompt_len))}
    if cfg.is_encoder_decoder:
        batch["frames"] = whisper_frames(cfg, LM_BATCH, SEED + 13)
    toks = rng.integers(0, cfg.vocab_size, (LM_BATCH, LM_NEW))
    busy_ms, kernels = lm_device_ms(bundle, params, batch, toks)
    line.update(decode_device_ms=busy_ms, decode_kernels=kernels,
                decode_device_share=busy_ms / line["decode_ms"])
    print(f"lm [{name}] {label}: a decode step keeps the card busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / line['decode_ms']:.1f}% of its {line['decode_ms']:.3f} ms), "
          f"{kernels:.0f} kernels a step (torch.profiler over 4 steps)", flush=True)
    print("lm " + json.dumps(line), flush=True)
    del bundle, params
    lm_free()


def lm_build(cfg, device=None):
    return lm_registry.build_model(cfg, device=CARD if device is None else device)


def lm_fixture(name, archs) -> None:
    """The JAX package's recorded answers for the smoke configs ``archs``
    (tests/fixtures/torch_lm), replayed on the card from the same numpy
    seed: equal weight checksums, equal greedy tokens, each teacher-forced
    step's logits within 1e-4."""
    manifest = json.loads((FIXTURE_LM / "manifest.json").read_text())
    out = []
    for arch in archs:
        entry = manifest["configs"][arch]
        with np.load(FIXTURE_LM / entry["file"]) as z:
            fx = {k: z[k] for k in z.files}
        cfg = importlib.import_module(
            f"repro_torch.configs.{entry['file'].removesuffix('.npz')}").smoke().replace(
            dtype="float32")
        tree = seeded_numpy_params(cfg, entry["seed"])
        if leaf_checksums(tree) != entry["checksums"]:
            fail(f"fixture {arch}: the seeded weights' checksums differ (numpy stream?)")
        bundle = lm_build(cfg)
        params = lm_params_from_numpy(cfg, tree, device=CARD)
        batch = {k: fx[k] for k in ("tokens", "embeds", "frames") if k in fx}
        logits = lm_serve.teacher_forced(bundle, params, batch, fx["greedy"]).cpu()
        err = lm_rel(logits, torch.from_numpy(fx["logits"]))
        if not err < 1e-4:
            fail(f"fixture {arch}: logits vs the reference max|d|/max|ref| {err:.3g}")
        if not np.array_equal(logits.argmax(-1).T.numpy(), fx["greedy"]):
            fail(f"fixture {arch}: greedy tokens differ from the reference's")
        if set(batch) == {"tokens"} and not np.array_equal(
                lm_serve.generate(bundle, params, fx["tokens"],
                                  max_new=fx["greedy"].shape[1]), fx["greedy"]):
            fail(f"fixture {arch}: generate's tokens differ from the reference's")
        out.append(f"{arch} {err:.2g}")
    print(f"lm [{name}] the JAX package's answers (tests/fixtures/torch_lm) on the card: "
          f"greedy tokens equal, teacher-forced logits max|d|/max|ref| " + ", ".join(out),
          flush=True)


def phase_lm(name, stats) -> None:
    """Phase 10: the LM half's serving path at full width (the profiles of
    its models wait for ``phase_lm_profiles``)."""
    llama = get_config("llama3.2-3b")
    gemma = get_config("gemma3-1b")
    # deepseek-v3 cut to depth 2 (1 dense + 1 MoE layer), every width kept
    deepseek = get_config("deepseek-v3-671b").replace(n_layers=2, first_dense_layers=1)
    # (label, config, prompt length): gemma's 1,024-token prompt is two
    # 512-token flash blocks, past its 512 window
    runs = [("llama3.2-3b", llama, LM_PROMPT), ("gemma3-1b", gemma, 2 * gemma.sliding_window),
            ("deepseek-v3-671b depth 2", deepseek, LM_PROMPT)]
    stats["lm_profiles"] = [lm_serve_run(label, cfg, prompt_len, name, stats)
                            for label, cfg, prompt_len in runs]
    lm_decode_equals_forward("llama3.2-3b", llama.replace(dtype="float32"), LM_BATCH,
                             LM_PROMPT, name)
    lm_decode_equals_forward("gemma3-1b", gemma.replace(dtype="float32"), LM_BATCH,
                             gemma.sliding_window + 64, name)
    # one sequence, and room for every prefill token in every expert: no
    # assignment dropped on either side, so the two paths compute alike
    lm_decode_equals_forward(
        "deepseek-v3-671b depth 2",
        deepseek.replace(dtype="float32",
                         capacity_factor=deepseek.n_experts / deepseek.moe_top_k),
        1, LM_PROMPT, name)
    lm_card_equals_cpu("llama3.2-3b depth 2", llama.replace(n_layers=2, dtype="float32"), name)
    lm_fixture(name, FIXTURE_TRANSFORMERS)


# -- phase 11: the LM half's last three families ------------------------------------------


def phase_lm_families(name, stats) -> None:
    """Phase 11: zamba2, rwkv6 and whisper at full width and depth."""
    zamba = get_config("zamba2-2.7b")
    rwkv = get_config("rwkv6-1.6b")
    whisper = get_config("whisper-tiny")
    for label, cfg, prompt_len in (("zamba2-2.7b", zamba, LM_PROMPT),
                                   ("rwkv6-1.6b", rwkv, LM_PROMPT),
                                   ("whisper-tiny", whisper, WHISPER_PROMPT)):
        stats["lm_profiles"].append(lm_serve_run(label, cfg, prompt_len, name, stats))
    # 225 + 31 = 256 positions: two SSD chunks of 128, 16 WKV chunks
    for label, cfg, prompt_len in (("zamba2-2.7b", zamba, 225), ("rwkv6-1.6b", rwkv, 225),
                                   ("whisper-tiny", whisper, WHISPER_PROMPT)):
        lm_decode_equals_forward(label, cfg.replace(dtype="float32"), LM_BATCH, prompt_len,
                                 name)
    # depth 2: zamba2 one group of 2 mamba layers + the shared block
    for label, cfg in (("zamba2-2.7b depth 2", zamba.replace(n_layers=2, shared_attn_period=2)),
                       ("rwkv6-1.6b depth 2", rwkv.replace(n_layers=2)),
                       ("whisper-tiny", whisper)):
        lm_card_equals_cpu(label, cfg.replace(dtype="float32"), name)
    lm_fixture(name, FIXTURE_FAMILIES)


def phase_lm_profiles(name, stats) -> None:
    """The card's busy share and kernels a decode step of every phase 10
    and 11 model, after all their timed runs."""
    for label, cfg, prompt_len, line in stats["lm_profiles"]:
        lm_profile(label, cfg, prompt_len, name, line)


# -- phase 12: LM training on the card ---------------------------------------------------

TRAIN_B, TRAIN_S, TRAIN_STEPS = 8, 1024, 6  # llama3.2-3b's main path: _chunked_ce's 2 chunks
FAMILY_B, FAMILY_S = 4, 1024  # zamba2 / rwkv6 depth 2: 8 SSD chunks of 128, 64 WKV chunks
FIXTURE_TRAIN = FIXTURE_LM / "train.json"


class TimedAdamW(lm_adamw.AdamW):
    """``AdamW`` with its update bracketed by CUDA events: the optimizer's
    ms on its own."""

    def __init__(self, cfg):
        super().__init__(cfg)
        self.events = []

    def update(self, grads, state, params, **kw):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = super().update(grads, state, params, **kw)
        b.record()
        self.events.append((a, b))
        return out


def train_opt_cfg(steps: int):
    """The ``AdamWConfig`` ``train()`` builds for ``steps`` steps."""
    return lm_adamw.AdamWConfig(warmup_steps=max(5, steps // 20), decay_steps=steps)


def train_run(bundle, params, batches, opt) -> tuple[list, list, list]:
    """``make_train_step`` over ``batches`` (numpy) on the card: (losses,
    grad norms, (start, end) CUDA events of each step), read after one
    synchronise."""
    step_fn = lm_train.make_train_step(bundle, opt)
    state = opt.init(params)
    dt = lm_common.dtype_of(bundle.cfg.dtype)
    out, events = [], []
    for b in batches:
        batch = lm_train.on_device(b, bundle.device, dt)
        a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        params, state, _, m = step_fn(params, state, None, batch)
        e.record()
        out.append((m["loss"], m["grad_norm"]))
        events.append((a, e))
    torch.cuda.synchronize()
    return [float(x) for x, _ in out], [float(g) for _, g in out], events


KERNEL_KINDS = (("gemm", ("gemm", "xmma", "cutlass", "nvjet")), ("reduce", ("reduce",)),
                ("elementwise", ("elementwise", "vectorized")),
                ("index", ("index", "scatter", "gather")), ("copy/cat", ("cat", "copy")))


def kernel_kind(kernel_name: str) -> str:
    low = kernel_name.lower()
    return next((kind for kind, keys in KERNEL_KINDS if any(k in low for k in keys)), "other")


def profiled_steps(run, n_steps: int) -> tuple[float, float, dict]:
    """Device busy ms and kernels a step, from ``torch.profiler`` over
    ``run()`` (``n_steps`` steps; NaN where the trace holds no device
    event), and the busy ms a step of each kind of kernel (GEMMs,
    reductions, elementwise, ..., by the kernels' names).  Only the card's
    activity is traced: the host's op events cost seconds a step to
    collect at the mesh step's ~130,000 launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return float("nan"), float("nan"), {}
    kinds: dict = {}
    for e in kernels:
        kind = kernel_kind(e.name)
        kinds[kind] = kinds.get(kind, 0.0) + e.time_range.elapsed_us() / 1e3 / n_steps
    return (sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n_steps,
            len(kernels) / n_steps, kinds)


def train_device_ms(bundle, params, batches) -> tuple[float, float, dict]:
    """``profiled_steps`` of one-device train steps over ``batches``."""
    opt = lm_adamw.AdamW(train_opt_cfg(TRAIN_STEPS))
    step_fn = lm_train.make_train_step(bundle, opt)
    state = opt.init(params)
    dt = lm_common.dtype_of(bundle.cfg.dtype)
    on_card = [lm_train.on_device(b, bundle.device, dt) for b in batches]

    def run():
        nonlocal params, state
        for batch in on_card:
            params, state, _, _ = step_fn(params, state, None, batch)

    return profiled_steps(run, len(batches))


def finite(label: str, losses, norms) -> None:
    if not all(np.isfinite(losses)) or not all(np.isfinite(norms)):
        fail(f"{label}: a loss or gradient norm is not finite: {losses} {norms}")


def lm_train_main(name, stats) -> None:
    """The main path: llama3.2-3b at full width and depth (28 layers),
    bfloat16, remat on, float32 moments, ``TokenPipeline`` batches of
    8 x 1,024, ``TRAIN_STEPS`` steps of ``make_train_step`` with the
    ``AdamWConfig`` ``train()`` builds; then 2 profiled steps, and 3 steps
    again from the same seed, whose losses must equal the first 3."""
    cfg = get_config("llama3.2-3b")
    if not cfg.remat or cfg.dtype != "bfloat16":
        fail("llama3.2-3b: the full config trains in bfloat16 with remat")
    pipe = lm_tokens.TokenPipeline(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=SEED)
    batches = [pipe.batch(i) for i in range(TRAIN_STEPS + 2)]
    base = torch.cuda.memory_allocated()
    bundle = lm_build(cfg)
    t0 = time.perf_counter()
    params = bundle.init_params(SEED)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    before = [params.final_norm.detach().clone(), params.segs[0][0].attn.wq.detach()[:4].clone()]
    opt = TimedAdamW(train_opt_cfg(TRAIN_STEPS))
    torch.cuda.reset_peak_memory_stats()
    losses, norms, events = train_run(bundle, params, batches[:TRAIN_STEPS], opt)
    peak = torch.cuda.max_memory_allocated() - base
    finite("llama3.2-3b train", losses, norms)
    after = [params.final_norm.detach(), params.segs[0][0].attn.wq.detach()[:4]]
    if any(torch.equal(a, b) for a, b in zip(before, after)):
        fail("llama3.2-3b train: parameters unchanged after the steps")
    steps_ms = [a.elapsed_time(b) for a, b in events]
    opt_ms = [a.elapsed_time(b) for a, b in opt.events]
    step_ms, upd_ms = float(np.median(steps_ms[1:])), float(np.median(opt_ms[1:]))
    busy_ms, kernels, kinds = train_device_ms(bundle, params, batches[TRAIN_STEPS:])
    flops = lm_flops.model_flops(cfg, ShapeCell("train", TRAIN_S, TRAIN_B, "train"), bundle)
    bound = flops / BF16_FLOPS_PER_S * 1e3
    n_params = sum(p.numel() for p in params.parameters())
    del params, opt, bundle
    lm_free()
    # run-to-run equality: 3 steps again from the same seed
    bundle = lm_build(cfg)
    again, _, _ = train_run(bundle, bundle.init_params(SEED), batches[:3],
                            lm_adamw.AdamW(train_opt_cfg(TRAIN_STEPS)))
    del bundle
    lm_free()
    if again != losses[:3]:
        fail(f"llama3.2-3b train: two runs from one seed differ: {again} vs {losses[:3]}")
    line = {"model": "llama3.2-3b", "layers": cfg.n_layers, "dtype": cfg.dtype, "remat": True,
            "batch": TRAIN_B, "seq": TRAIN_S, "params": n_params, "init_s": t_init,
            "losses": losses, "grad_norms": norms, "step_ms": steps_ms, "step_ms_median": step_ms,
            "optimizer_ms": opt_ms, "optimizer_ms_median": upd_ms, "bound_ms": bound,
            "bound_by": "operations", "model_flops": flops, "share": bound / step_ms,
            "optimizer_share": upd_ms / step_ms, "busy_ms": busy_ms,
            "busy_share": busy_ms / step_ms, "kernels_per_step": kernels,
            "busy_ms_by_kind": kinds,
            "tokens_per_s": TRAIN_B * TRAIN_S / (step_ms / 1e3), "peak_bytes": peak,
            "card": name}
    stats["lm_train"] = [line]
    print(f"lm train [{name}] llama3.2-3b: {cfg.n_layers} layers bfloat16, remat, {n_params:,} "
          f"params, B={TRAIN_B} x S={TRAIN_S}, {TRAIN_STEPS} steps: loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}, grad norm {norms[0]:.3f} -> {norms[-1]:.3f}; "
          f"{step_ms:.3f} ms a step (median of steps 2-{TRAIN_STEPS}; bound {bound:.3f} ms by "
          f"operations, {100 * bound / step_ms:.1f}%), optimizer {upd_ms:.3f} ms "
          f"({100 * upd_ms / step_ms:.1f}%), card busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / step_ms:.1f}%), {kernels:.0f} kernels a step, "
          f"{line['tokens_per_s']:.1f} tokens/s, peak {peak / 2**30:.2f} GiB; 3 steps again "
          f"from the seed: losses equal; busy ms a step by kernel kind: "
          + ", ".join(f"{k} {v:.1f}" for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])),
          flush=True)


def lm_grads(bundle, params, batch: dict) -> tuple[float, list]:
    """loss_fn + backward: (loss, each JAX-layout leaf's gradient tensors)."""
    loss, _, grads = lm_train.loss_and_grads(
        bundle, params,
        lm_train.on_device(batch, bundle.device, lm_common.dtype_of(bundle.cfg.dtype)))
    return float(loss), [lm_leaf_tensors(leaf) for _, leaf in lm_tree_leaves(grads)]


CARD_CPU_S = 64  # the card-vs-CPU training check's sequence (its CPU side is the slow one)


def lm_train_card_equals_cpu(name) -> None:
    """llama3.2-3b at full width cut to depth 2, float32, TF32 off: one
    loss_fn + backward on the card and on the port's CPU path, one set of
    weights: loss within 1e-5 relative, each gradient leaf within
    max|d|/max|ref| < 1e-4."""
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on for float32 products")
    cfg = get_config("llama3.2-3b").replace(n_layers=2, dtype="float32")
    batch = lm_tokens.TokenPipeline(cfg.vocab_size, 2, CARD_CPU_S, seed=SEED + 30).batch(0)
    t0 = time.perf_counter()
    bundle = lm_build(cfg)
    params = bundle.init_params(5)
    loss, grads = lm_grads(bundle, params, batch)
    on_cpu = lm_build(cfg, "cpu")
    params_cpu = on_cpu.model.empty_params()
    params_cpu.load_state_dict(params.state_dict())
    del params, bundle
    lm_free()
    ref_loss, ref_grads = lm_grads(on_cpu, params_cpu, batch)
    worst = 0.0
    for got, ref in zip(grads, ref_grads):
        scale = max(float(r.abs().max()) for r in ref)
        err = max(float((g.cpu() - r).abs().max()) for g, r in zip(got, ref))
        worst = max(worst, err / scale if scale > 0 else err)
    if not abs(loss - ref_loss) <= 1e-5 * abs(ref_loss) or not worst < 1e-4:
        fail(f"llama3.2-3b depth 2 train card vs CPU: loss {loss} vs {ref_loss}, gradients "
             f"max|d|/max|ref| {worst:.3g}")
    print(f"lm train [{name}] llama3.2-3b depth 2 float32 B=2 S={CARD_CPU_S}: loss_fn + backward card "
          f"vs CPU: loss {loss:.6f} vs {ref_loss:.6f}, gradients max|d|/max|ref| {worst:.3g} "
          f"(< 1e-4), TF32 off ({time.perf_counter() - t0:.1f} s)", flush=True)
    del grads, ref_grads, params_cpu


def lm_train_family(label, cfg, batches, name, stats) -> None:
    """Two bfloat16 train steps with remat at full width: losses and
    gradient norms finite (zamba2's SSD at chunk 128 included), the second
    step timed."""
    if not cfg.remat:
        fail(f"{label}: the full config trains with remat")
    base = torch.cuda.memory_allocated()
    bundle = lm_build(cfg)
    params = bundle.init_params(SEED)
    torch.cuda.reset_peak_memory_stats()
    losses, norms, events = train_run(bundle, params, batches,
                                      lm_adamw.AdamW(train_opt_cfg(TRAIN_STEPS)))
    peak = torch.cuda.max_memory_allocated() - base
    finite(label, losses, norms)
    ms = events[-1][0].elapsed_time(events[-1][1])
    shape = {k: tuple(v.shape) for k, v in batches[0].items()}
    stats["lm_train"].append({"model": label, "layers": cfg.n_layers, "batch": shape,
                              "losses": losses, "grad_norms": norms, "step_ms": ms,
                              "peak_bytes": peak, "card": name})
    print(f"lm train [{name}] {label} bfloat16, remat, {shape}: losses {losses}, grad norms "
          f"{[round(g, 4) for g in norms]} finite; step 2 {ms:.3f} ms; peak "
          f"{peak / 2**30:.2f} GiB", flush=True)
    del params, bundle
    lm_free()


def fixture_batch(cfg, seed: int, b: int, s: int) -> dict:
    """The recorded answers' batch, the recipe of tests/_torch_lm_batch.py's
    ``lm_batch``."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.is_encoder_decoder:
        return {"frames": rng.standard_normal((b, 40, cfg.d_model)).astype(np.float32),
                "tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
                "labels": labels}
    if cfg.embeddings_input:
        embeds = rng.standard_normal((b, s, cfg.d_model)) * cfg.d_model ** -0.5
        return {"embeds": embeds.astype(np.float32), "labels": labels}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
            "labels": labels}


def lm_train_fixture(name) -> None:
    """The JAX package's recorded training answers (tests/fixtures/torch_lm/
    train.json) on the card, float32, TF32 off: each config's loss, metrics
    and gradient norm within 1e-5 relative, and the 3 recorded train steps'
    (microbatch 2, int8 compression) losses within 1e-5."""
    fx = json.loads(FIXTURE_TRAIN.read_text())
    files = json.loads((FIXTURE_LM / "manifest.json").read_text())["configs"]
    def smoke(arch):
        module = files[arch]["file"].removesuffix(".npz")
        return importlib.import_module(f"repro_torch.configs.{module}").smoke().replace(
            dtype="float32")

    fb = fx["batch"]
    out = []
    for arch, ans in fx["configs"].items():
        cfg = smoke(arch)
        bundle = lm_registry.build_model(cfg, flash_blk=fb["flash_blk"], device=CARD)
        params = lm_params_from_numpy(cfg, seeded_numpy_params(cfg, fb["seed"]), device=CARD)
        batch = lm_train.on_device(fixture_batch(cfg, fb["seed"], fb["b"], fb["s"]), CARD,
                                   torch.float32)
        loss, metrics, grads = lm_train.loss_and_grads(bundle, params, batch)
        got = {"loss": float(loss), "grad_norm": float(lm_adamw.global_norm(grads)),
               **{f"metrics.{k}": float(v) for k, v in metrics.items()}}
        want = {"loss": ans["loss"], "grad_norm": ans["grad_norm"],
                **{f"metrics.{k}": v for k, v in ans["metrics"].items()}}
        if got.keys() != want.keys():
            fail(f"train fixture {arch}: metrics {sorted(got)} != {sorted(want)}")
        errs = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-3) for k in want}
        if max(errs.values()) >= 1e-5:
            fail(f"train fixture {arch}: {got} vs the reference's {want}")
        out.append(f"{arch} {max(errs.values()):.2g}")
    st = fx["train_steps"]
    cfg = smoke(st["config"])
    bundle = lm_build(cfg)
    params = lm_params_from_numpy(cfg, seeded_numpy_params(cfg, st["seed"]), device=CARD)
    opt = lm_adamw.AdamW(lm_adamw.AdamWConfig(**st["opt"]))
    step_fn = lm_train.make_train_step(bundle, opt, microbatch=st["microbatch"],
                                       compress=st["compress"])
    state, residual = opt.init(params), None
    pipe = lm_tokens.TokenPipeline(cfg.vocab_size, st["global_batch"], st["seq_len"],
                                   seed=st["seed"])
    losses = []
    for i in range(st["n_steps"]):
        params, state, residual, m = step_fn(
            params, state, residual, lm_train.on_device(pipe.batch(i), CARD, torch.float32))
        losses.append(float(m["loss"]))
    if not np.allclose(losses, st["losses"], rtol=1e-5, atol=0):
        fail(f"train fixture steps: {losses} vs the reference's {st['losses']}")
    print(f"lm train [{name}] the JAX package's training answers (tests/fixtures/torch_lm/"
          f"train.json) on the card: loss, metrics and gradient norm max rel err "
          + ", ".join(out) + f"; 3 steps (microbatch 2, int8) losses {losses} (rtol 1e-5)",
          flush=True)


def lm_train_restart(name) -> None:
    """``train()`` on the card at ``_scaled(llama3.2-3b, 0.05)``: 10 steps,
    a checkpoint every 4, a crash injected after step 6 and resumed; the
    resumed losses equal an uninterrupted run's (rtol 1e-6)."""
    cfg = lm_train._scaled(get_config("llama3.2-3b"), 0.05)
    kw = dict(global_batch=4, seq_len=128, ckpt_every=4, seed=SEED, log_every=100, device=CARD)
    run = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        with contextlib.redirect_stdout(io.StringIO()):  # train()'s own JSON lines
            try:
                lm_train.train(cfg, steps=10, run_dir=f"{run}/a", failure_at=6, **kw)
                fail("train(failure_at=6) did not crash")
            except InjectedFailure:
                pass
            resumed = lm_train.train(cfg, steps=10, run_dir=f"{run}/a", **kw)
            whole = lm_train.train(cfg, steps=10, run_dir=f"{run}/b", **kw)
    finally:
        shutil.rmtree(run, ignore_errors=True)
    ref = {h["step"]: h["loss"] for h in whole}
    if [h["step"] for h in resumed] != list(range(4, 10)) or not all(
            np.isclose(h["loss"], ref[h["step"]], rtol=1e-6, atol=0) for h in resumed):
        fail(f"train() resumed on the card: {[(h['step'], h['loss']) for h in resumed]} "
             f"vs uninterrupted {ref}")
    print(f"lm train [{name}] train() {cfg.n_layers} layers d={cfg.d_model} bfloat16: crash "
          f"after step 6, resumed from the step-4 checkpoint: losses of steps 4-9 equal the "
          f"uninterrupted run's (rtol 1e-6): {[round(h['loss'], 4) for h in resumed]}",
          flush=True)


def phase_lm_train(name, stats) -> None:
    """Phase 12: the LM half's training path on the card."""
    lm_free()
    print(f"LM training: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated "
          f"after phases 1-11", flush=True)
    lm_train_main(name, stats)
    lm_train_card_equals_cpu(name)
    def token_batches(cfg):
        pipe = lm_tokens.TokenPipeline(cfg.vocab_size, FAMILY_B, FAMILY_S, seed=SEED)
        return [pipe.batch(i) for i in range(2)]

    zamba = get_config("zamba2-2.7b").replace(n_layers=2, shared_attn_period=2)
    rwkv = get_config("rwkv6-1.6b").replace(n_layers=2)
    whisper = get_config("whisper-tiny")
    audio = lm_tokens.EmbeddingPipeline(whisper.d_model, FAMILY_B, WHISPER_FRAMES,
                                        whisper.vocab_size, seed=SEED)
    for label, cfg, batches in (
            ("zamba2-2.7b depth 2 (one group of 2 + the shared block)", zamba,
             token_batches(zamba)),
            ("rwkv6-1.6b depth 2", rwkv, token_batches(rwkv)),
            ("whisper-tiny (4 + 4 layers, 1,500 frames)", whisper,
             [audio.batch(i, kind="audio") for i in range(2)])):
        lm_train_family(label, cfg, batches, name, stats)
    print(f"lm train [{name}] deepseek-v3-671b is left out: even at depth 2 its ~14.5 B "
          f"parameters need ~116 GB of float32 moments (the card has 80 GB)", flush=True)
    lm_train_fixture(name)
    lm_train_restart(name)
    for line in stats["lm_train"]:
        print("lm train " + json.dumps(line), flush=True)


MESH_SHAPE = (4, 2)  # phase 13's training mesh: 4 data groups x 2 model shards
MESH_TRAIN_LAYERS = 8  # the llama3.2-3b mesh train step's depth (of 28)
MESH_STEPS = 3  # ms a step: the median of steps 2-3
MESH_AGAIN = 2  # steps run again from the seed, bit-equal
MESH_CHECK_S = 256  # the float32 depth-2 checks' sequence (B = TRAIN_B)
# deepseek-v3's float32 depth-2 check on (2, 4): 1 dense + 1 MoE layer and the
# MTP block at full width, experts and vocab cut to fit one device's float32
# step beside nothing else; capacity 0.5, so tokens drop
DEEPSEEK_CHECK = dict(n_layers=2, first_dense_layers=1, n_experts=16, vocab_size=32768,
                      capacity_factor=0.5, dtype="float32")
DECODE_B, DECODE_S, DECODE_POS = 4, 32768, 16000  # gemma3-1b decode: H 4, KV 1, D 256
MOE_B, MOE_S = 4, 128  # deepseek-v3's MoE widths: d 7,168, E 256, f 2,048, top-8, 1 shared


def mesh_bytes(params) -> list[int]:
    """The bytes each mesh device's shards of a placed tree hold."""
    shards = lm_tree_tensors(params)
    n = shards[0].shards.size
    return [sum(sh.local(k).numel() * sh.local(k).element_size() for sh in shards)
            for k in range(n)]


def mesh_run(cfg, mesh, batches, opt, seed=SEED, profiled=()):
    """``place_params`` of the seeded model and ``make_train_step(mesh=)``
    over ``batches`` on the card, then ``profiled_steps`` over the steps
    of ``profiled``: (losses, grad norms, per-step CUDA events, bytes each
    device holds, the profile)."""
    bundle = lm_build(cfg)
    bundle.model.shard_x = lm_partition.activation_sharder(mesh)
    params = lm_train.place_params(mesh, cfg, bundle.init_params(seed))
    lm_free()  # the whole initial copy
    held = mesh_bytes(params)
    step_fn = lm_train.make_train_step(bundle, opt, mesh)
    state = opt.init(params)
    dt = lm_common.dtype_of(cfg.dtype)
    out, events = [], []
    for b in batches:
        batch = lm_train.place_batch(mesh, lm_train.on_device(b, CARD, dt))
        a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        params, state, _, m = step_fn(params, state, None, batch)
        e.record()
        out.append((m["loss"], m["grad_norm"]))
        events.append((a, e))
    torch.cuda.synchronize()
    busy = (float("nan"), float("nan"), {})
    if profiled:
        placed = [lm_train.place_batch(mesh, lm_train.on_device(b, CARD, dt)) for b in profiled]

        def run():
            nonlocal params, state
            for batch in placed:
                params, state, _, _ = step_fn(params, state, None, batch)

        busy = profiled_steps(run, len(placed))
    del params, state, step_fn, bundle
    lm_free()
    return [float(x) for x, _ in out], [float(g) for _, g in out], events, held, busy


def lm_mesh_train(name, stats) -> None:
    """(a) llama3.2-3b at full width, cut to ``MESH_TRAIN_LAYERS`` layers,
    as phase 12 trains it otherwise (bfloat16, remat, float32 moments,
    ``TokenPipeline`` 8 x 1,024, the same ``AdamWConfig``), on a (4, 2) mesh
    of logical shards of the card: ``place_params`` ->
    ``make_train_step(mesh=)``, the split program (each shard computes its
    group's rows with its model slices); the bytes each shard holds against
    the specs' reckoning (``attach``), ms a step beside one device's at the
    same depth, the optimizer's ms (its 8 shard updates), tokens/s, kernels
    a step, peak; ``MESH_AGAIN`` steps again from the seed, bit-equal."""
    cfg = get_config("llama3.2-3b").replace(n_layers=MESH_TRAIN_LAYERS)
    mesh = make_host_mesh(*MESH_SHAPE, devices=[CARD] * 8)
    pipe = lm_tokens.TokenPipeline(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=SEED)
    batches = [pipe.batch(i) for i in range(MESH_STEPS + 1)]
    meta = lm_build(cfg, "meta")
    shapes = meta.params_shape()
    specs = lm_partition.param_pspecs(shapes, cfg, lm_partition.MeshAxes(mesh))
    reckoned = sum(s.local_bytes() for _, s in lm_partition.leaves_with_path(
        lm_partition.attach(mesh, shapes, specs)))
    lm_free()
    bundle = lm_build(cfg)
    one_losses, _, one_events = train_run(bundle, bundle.init_params(SEED), batches[:MESH_STEPS],
                                          lm_adamw.AdamW(train_opt_cfg(TRAIN_STEPS)))
    one_busy, one_kernels, _ = train_device_ms(bundle, bundle.init_params(SEED),
                                               batches[MESH_STEPS:])
    one_ms = float(np.median([a.elapsed_time(b) for a, b in one_events][1:]))
    del bundle
    lm_free()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    opt = TimedAdamW(train_opt_cfg(TRAIN_STEPS))
    losses, norms, events, held, (busy_ms, kernels, kinds) = mesh_run(
        cfg, mesh, batches[:MESH_STEPS], opt, profiled=batches[MESH_STEPS:])
    peak = torch.cuda.max_memory_allocated() - base
    finite("llama3.2-3b mesh train", losses, norms)
    if held != [reckoned] * 8:
        fail(f"mesh shards hold {held} bytes, the specs give {reckoned} each")
    steps_ms = [a.elapsed_time(b) for a, b in events]
    upd = [a.elapsed_time(b) for a, b in opt.events[:8 * MESH_STEPS]]  # 8 updates a step
    opt_ms = [sum(upd[i:i + 8]) for i in range(0, len(upd), 8)]
    step_ms, upd_ms = float(np.median(steps_ms[1:])), float(np.median(opt_ms[1:]))
    again, _, _, _, _ = mesh_run(cfg, mesh, batches[:MESH_AGAIN],
                              lm_adamw.AdamW(train_opt_cfg(TRAIN_STEPS)))
    if again != losses[:MESH_AGAIN]:
        fail(f"llama3.2-3b mesh train: two runs from one seed differ: {again} vs "
             f"{losses[:MESH_AGAIN]}")
    flops = lm_flops.model_flops(cfg, ShapeCell("train", TRAIN_S, TRAIN_B, "train"), meta)
    bound = flops / BF16_FLOPS_PER_S * 1e3
    line = {"model": "llama3.2-3b", "mesh": list(MESH_SHAPE), "logical_shards_of": name,
            "layers": cfg.n_layers, "dtype": cfg.dtype, "remat": True, "batch": TRAIN_B,
            "seq": TRAIN_S, "losses": losses, "grad_norms": norms, "step_ms": steps_ms,
            "step_ms_median": step_ms, "one_device_step_ms": one_ms,
            "one_device_losses": one_losses, "optimizer_ms": opt_ms,
            "optimizer_ms_median": upd_ms, "bound_ms": bound, "bound_by": "operations",
            "share": bound / step_ms, "busy_ms": busy_ms, "busy_share": busy_ms / step_ms,
            "kernels_per_step": kernels, "busy_ms_by_kind": kinds,
            "one_device_busy_ms": one_busy, "one_device_kernels_per_step": one_kernels,
            "tokens_per_s": TRAIN_B * TRAIN_S / (step_ms / 1e3),
            "peak_bytes": peak, "bytes_per_shard": held, "spec_bytes_per_shard": reckoned,
            "program": "split", "card": name}
    stats["lm_mesh"] = [line]
    print(f"lm mesh [{name}] llama3.2-3b ({cfg.n_layers} layers) on a {MESH_SHAPE[0]} x "
          f"{MESH_SHAPE[1]} mesh of logical "
          f"shards of the card: {held[0]:,} bytes a shard (the specs' {reckoned:,}); B="
          f"{TRAIN_B} x S={TRAIN_S}, {MESH_STEPS} steps: loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f} (one device: {one_losses[0]:.4f} -> "
          f"{one_losses[-1]:.4f}); {step_ms:.3f} ms a step (median of steps "
          f"2-{MESH_STEPS}; one device {one_ms:.3f}; bound {bound:.3f} ms, "
          f"{100 * bound / step_ms:.1f}%), optimizer {upd_ms:.3f} ms "
          f"({100 * upd_ms / step_ms:.1f}%), card busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / step_ms:.1f}%), {kernels:.0f} kernels a step (one device "
          f"{one_kernels:.0f}), {line['tokens_per_s']:.1f} tokens/s, peak "
          f"{peak / 2**30:.2f} GiB (the split program); {MESH_AGAIN} steps again from the "
          f"seed: losses equal; "
          f"busy ms a step by kernel kind: "
          + ", ".join(f"{k} {v:.1f}" for k, v in sorted(kinds.items(), key=lambda kv: -kv[1])),
          flush=True)


def worst_leaf(got, ref) -> tuple[str, float]:
    """The leaf of ``got`` (a parameter tree in the JAX layout) farthest from
    ``ref``'s, and its largest error over its scale in ``ref`` (at least 1:
    the bound of the mesh tests)."""
    worst = ("", 0.0)
    for (path, g), (_, r) in zip(lm_tree_leaves(got), lm_tree_leaves(ref), strict=True):
        for a, b in zip(lm_leaf_tensors(g), lm_leaf_tensors(r), strict=True):
            b = b.to(a.device).float()
            err = float((a.float() - b).abs().max()) / max(1.0, float(b.abs().max()))
            if err > worst[1]:
                worst = (".".join(map(str, path)), err)
    return worst


def mesh_first_step(cfg, shape, batch, seed: int):
    """The first step on one device and on a ``shape`` mesh of logical
    shards of the card from the same weights and batch (float32, TF32
    off): (one device's metrics, the mesh's, the worst updated leaf
    (``worst_leaf``), the assignments one device's MoE layers drop, the
    mesh's)."""
    mesh = make_host_mesh(*shape, devices=[CARD] * 8)
    opt = lm_adamw.AdamW(train_opt_cfg(TRAIN_STEPS))
    bundle = lm_build(cfg)
    params = bundle.init_params(seed)
    placed = lm_train.place_params(mesh, cfg, params)
    on_card = lm_train.on_device(batch, CARD, torch.float32)
    seen = []
    if cfg.is_moe:
        route = lm_moe.route_logits

        def counted(*a, **kw):
            r = route(*a, **kw)
            seen.append(int((~r.keep).sum()))
            return r

        lm_moe.route_logits = counted
        try:
            with torch.no_grad():
                bundle.loss_fn(params, on_card)
        finally:
            lm_moe.route_logits = route
    params, _, _, one = lm_train.make_train_step(bundle, opt)(
        params, opt.init(params), None, on_card)
    ref = lm_common.tree_map(lambda leaf: lm_common.stack_map(lambda t: t.detach().cpu(), leaf),
                             params.jax_layout())
    del params
    lm_free()
    bundle.model.shard_x = lm_partition.activation_sharder(mesh)
    step = lm_train.make_train_step(bundle, opt, mesh)
    placed, _, _, on_mesh = step(placed, opt.init(placed), None,
                                 lm_train.place_batch(mesh, on_card))
    worst = worst_leaf(lm_placement.gather_tree(placed, CARD), ref)
    dropped = (sum(int(n) for n in step.routing.dropped.values())
               if getattr(step, "routing", None) is not None else 0)
    del placed, bundle, step, ref
    lm_free()
    return one, on_mesh, worst, sum(seen), dropped


def check_first_step(label, one, on_mesh, worst) -> tuple[float, float, float, float]:
    """Fails unless the mesh's loss and gradient norm are within rtol 2e-4
    of one device's and every updated leaf within 2e-4 of its scale.
    Returns (the mesh's loss, its gradient norm, one device's, one
    device's)."""
    a, b = float(one["loss"]), float(on_mesh["loss"])
    ga, gb = float(one["grad_norm"]), float(on_mesh["grad_norm"])
    if abs(b - a) > 2e-4 * abs(a) or abs(gb - ga) > 2e-4 * abs(ga) or worst[1] > 2e-4:
        fail(f"{label}: mesh step vs one device: loss {b} vs {a}, grad norm {gb} vs {ga}, "
             f"updated leaf {worst[0]} off by {worst[1]:.3e} of its scale")
    return b, gb, a, ga


def first_step_line(a, ga, b, gb, worst) -> str:
    return (f"first step on the mesh loss {b:.7f} grad norm {gb:.6f}, one device {a:.7f} / "
            f"{ga:.6f} (rel {abs(b - a) / abs(a):.2e} / {abs(gb - ga) / abs(ga):.2e}; rtol "
            f"2e-4); updated parameters: the worst leaf {worst[0]} off by {worst[1]:.2e} of "
            f"its scale (2e-4)")


def lm_mesh_equals_one_device(name) -> None:
    """(a) llama3.2-3b cut to depth 2 in float32, TF32 off: the first
    step's loss and gradient norm on the (4, 2) mesh within rtol 2e-4 of
    one device's on the same batch and weights (the bound the JAX
    package's mesh test holds), every updated parameter within 2e-4 of
    its scale."""
    cfg = get_config("llama3.2-3b").replace(n_layers=2, dtype="float32")
    batch = lm_tokens.TokenPipeline(cfg.vocab_size, TRAIN_B, MESH_CHECK_S, seed=SEED + 40).batch(0)
    one, on_mesh, worst, _, _ = mesh_first_step(cfg, MESH_SHAPE, batch, 6)
    b, gb, a, ga = check_first_step("llama3.2-3b depth 2", one, on_mesh, worst)
    print(f"lm mesh [{name}] llama3.2-3b depth 2 float32, B={TRAIN_B} x S={MESH_CHECK_S}: "
          + first_step_line(a, ga, b, gb, worst), flush=True)


def lm_mesh_moe_equals_one_device(name) -> None:
    """(a) deepseek-v3 cut to depth 2 in float32 (``DEEPSEEK_CHECK``: one
    dense and one MoE layer, MLA and the MTP block at full width), TF32
    off: the first step on a (2, 4) mesh against one device's on the same
    batch and weights as ``lm_mesh_equals_one_device``'s, and the MoE
    layer's dropped assignments equal to one device's."""
    cfg = get_config("deepseek-v3-671b").replace(**DEEPSEEK_CHECK)
    batch = lm_tokens.TokenPipeline(cfg.vocab_size, TRAIN_B, MESH_CHECK_S, seed=SEED + 42).batch(0)
    one, on_mesh, worst, seen, dropped = mesh_first_step(cfg, (2, 4), batch, 7)
    b, gb, a, ga = check_first_step("deepseek-v3 depth 2", one, on_mesh, worst)
    if dropped != seen or dropped == 0:
        fail(f"deepseek-v3 mesh step: {dropped} assignments dropped, one device {seen}")
    print(f"lm mesh [{name}] deepseek-v3 depth 2 float32 ({cfg.n_experts} experts, vocab "
          f"{cfg.vocab_size}, capacity {cfg.capacity_factor}), B={TRAIN_B} x S={MESH_CHECK_S} on "
          f"(2, 4): " + first_step_line(a, ga, b, gb, worst)
          + f"; {dropped} assignments dropped, one device {seen}", flush=True)


def lm_mesh_family(label, cfg, batches, name, stats) -> None:
    """(a) One family's mesh step in float32, TF32 off, on the (4, 2) mesh:
    the first step against one device's as ``lm_mesh_equals_one_device``;
    then ``MESH_AGAIN`` steps and one profiled step: the second step's ms
    and kernels a step beside one device's, peak; ``MESH_AGAIN`` steps
    again from the seed, bit-equal.  The program is the family's: split
    over `model` (``SPLIT_FAMILIES``) or gathered (whole parameters on a
    data group's device)."""
    program = "split" if cfg.family in lm_train.SPLIT_FAMILIES else "gathered"
    one, on_mesh, worst, _, _ = mesh_first_step(cfg, MESH_SHAPE, batches[0], SEED)
    b, gb, a, ga = check_first_step(label, one, on_mesh, worst)

    bundle = lm_build(cfg)
    _, _, one_events = train_run(bundle, bundle.init_params(SEED), batches[:MESH_AGAIN],
                                 lm_adamw.AdamW(train_opt_cfg(TRAIN_STEPS)))
    one_ms = one_events[-1][0].elapsed_time(one_events[-1][1])
    _, one_kernels, _ = train_device_ms(bundle, bundle.init_params(SEED), batches[MESH_AGAIN:])
    del bundle
    lm_free()
    mesh = make_host_mesh(*MESH_SHAPE, devices=[CARD] * 8)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, norms, events, _, (busy_ms, kernels, _) = mesh_run(
        cfg, mesh, batches[:MESH_AGAIN], lm_adamw.AdamW(train_opt_cfg(TRAIN_STEPS)),
        profiled=batches[MESH_AGAIN:])
    peak = torch.cuda.max_memory_allocated() - base
    finite(f"{label} mesh train", losses, norms)
    again, _, _, _, _ = mesh_run(cfg, mesh, batches[:MESH_AGAIN],
                                 lm_adamw.AdamW(train_opt_cfg(TRAIN_STEPS)))
    if again != losses:
        fail(f"{label} mesh train: two runs from one seed differ: {again} vs {losses}")
    ms = events[-1][0].elapsed_time(events[-1][1])
    line = {"model": label, "layers": cfg.n_layers, "dtype": cfg.dtype,
            "mesh": list(MESH_SHAPE), "batch": TRAIN_B, "seq": MESH_CHECK_S,
            "program": program, "first_step_loss": b, "one_device_first_step_loss": a,
            "worst_leaf_err": worst[1], "losses": losses, "step_ms": ms,
            "one_device_step_ms": one_ms, "busy_ms": busy_ms, "kernels_per_step": kernels,
            "one_device_kernels_per_step": one_kernels,
            "peak_bytes": peak, "card": name}
    stats["lm_mesh"].append(line)
    print(f"lm mesh [{name}] {label} float32 on the {program} program, B={TRAIN_B} x "
          f"S={MESH_CHECK_S} on {MESH_SHAPE}: " + first_step_line(a, ga, b, gb, worst)
          + f"; step 2 {ms:.3f} ms (one device {one_ms:.3f}), card busy {busy_ms:.3f} ms, "
          f"{kernels:.0f} kernels a step (one device {one_kernels:.0f}), peak "
          f"{peak / 2**30:.2f} GiB; {MESH_AGAIN} steps again "
          f"from the seed: losses equal", flush=True)


def lm_mesh_families(name, stats) -> None:
    """(a) The recurrent and audio families on the split program
    (zamba2-2.7b cut to depth 2, one group of 2 mamba layers + the shared
    block: the SSD scan by heads, 80 on 2 shards; rwkv6-1.6b cut to depth
    2: 32 WKV heads on 2; whisper-tiny whole, 4 + 4 layers: its encoder
    over the frames and its decoder over the tokens split by query rows,
    the cross-attention's k/v column-parallel) (``lm_mesh_family``)."""
    for label, cfg, seed in (
            ("zamba2-2.7b depth 2",
             get_config("zamba2-2.7b").replace(n_layers=2, shared_attn_period=2), 44),
            ("rwkv6-1.6b depth 2", get_config("rwkv6-1.6b").replace(n_layers=2), 45),
            ("whisper-tiny", get_config("whisper-tiny"), 46)):
        cfg = cfg.replace(dtype="float32")
        if cfg.family not in lm_train.SPLIT_FAMILIES:
            fail(f"{cfg.name}: the {cfg.family} family is not on the split program")
        get = lm_train.batch_source(cfg, TRAIN_B, MESH_CHECK_S, SEED + seed)
        t0 = time.perf_counter()
        lm_mesh_family(label, cfg, [get(i) for i in range(MESH_AGAIN + 1)], name, stats)
        print(f"lm mesh {label} {time.perf_counter() - t0:.1f} s", flush=True)


def lm_flash_decode(name, stats) -> None:
    """(b) the flash-decode merge at gemma3-1b's decode widths (H 4, KV 1,
    D 256), B 4, a 32,768-position cache split over `model` of a (2, 4)
    mesh, ``pos`` mid-cache, float32: within 1e-5 x scale of
    ``decode_attention``; the ms of both (CUDA events)."""
    cfg = get_config("gemma3-1b")
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    mesh = make_host_mesh(2, 4, devices=[CARD] * 8)
    g = torch.Generator(device=CARD).manual_seed(SEED + 41)
    q = torch.randn((DECODE_B, 1, h, d), generator=g, device=CARD)
    k, v = (torch.randn((DECODE_B, DECODE_S, kv, d), generator=g, device=CARD)
            for _ in range(2))
    got = flash_decode_shardmap(mesh, q, k, v, DECODE_POS)
    ref = lm_decode_attention(q, k, v, DECODE_POS)
    scale = max(1.0, float(ref.abs().max()))
    err = float((got - ref).abs().max())
    if not err < 1e-5 * scale:
        fail(f"flash decode merge vs decode_attention: {err} (scale {scale})")
    ms = sync_time(lambda: flash_decode_shardmap(mesh, q, k, v, DECODE_POS), 20)
    plain = sync_time(lambda: lm_decode_attention(q, k, v, DECODE_POS), 20)
    line = {"config": "gemma3-1b decode", "heads": h, "kv_heads": kv, "head_dim": d,
            "batch": DECODE_B, "cache": DECODE_S, "pos": DECODE_POS, "mesh": [2, 4],
            "max_abs_err": err, "scale": scale, "ms": ms, "decode_attention_ms": plain,
            "card": name}
    stats["lm_mesh"].append(line)
    del q, k, v, got, ref
    lm_free()
    print(f"lm mesh [{name}] flash-decode merge, gemma3-1b widths (H {h}, KV {kv}, D {d}), "
          f"B {DECODE_B}, cache {DECODE_S:,} split over 4 shards, pos {DECODE_POS}: max |d| "
          f"{err:.3e} (scale {scale:.3f}; 1e-5 x scale), {ms:.4f} ms a call vs "
          f"decode_attention {plain:.4f} ms", flush=True)


def lm_shardmap_moe(name, stats) -> None:
    """(c) the all-to-all MoE at deepseek-v3's widths (d 7,168, E 256, f
    2,048, top-8, 1 shared expert), B x S = 4 x 128 on a (2, 4) mesh,
    float32, TF32 off: at cf 16 (no drops) the output within 1e-4 x scale,
    aux within 1e-5 and the gradients of x, the router and the shared
    expert within 1e-4 x scale of ``moe_forward`` (the experts' own
    gradients would need another 45 GB); at cf 1.25 the dropped count, two
    runs bit-equal; the ms of both forwards at cf 1.25."""
    cfg = get_config("deepseek-v3-671b")
    d, e, f, k = cfg.d_model, cfg.n_experts, cfg.moe_d_ff, cfg.moe_top_k
    mesh = make_host_mesh(2, 4, devices=[CARD] * 8)
    gen = torch.Generator(device=CARD).manual_seed(SEED + 42)
    t0 = time.perf_counter()
    p = LMMoEParams(d, f, e, cfg.n_shared_experts, torch.float32, device=CARD, generator=gen)
    for w in (p.w_gate, p.w_up, p.w_down):
        w.requires_grad_(False)
    x = torch.randn((MOE_B, MOE_S, d), generator=gen, device=CARD).requires_grad_(True)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    sm = make_shardmap_moe(mesh)
    wrt = [x, p.router, *p.shared.parameters()]

    def run(fn):
        y, aux = fn(p, x, top_k=k, capacity_factor=16.0)
        grads = torch.autograd.grad((y.float() ** 2).mean() + 0.01 * aux, wrt)
        return y.detach(), aux.detach(), grads

    y, aux, grads = run(sm)
    if int(sm.dropped):
        fail(f"shard-map MoE dropped {int(sm.dropped)} assignments at cf 16")
    ry, raux, rgrads = run(lm_moe_forward)
    scale = max(1.0, float(ry.abs().max()))
    out_err, aux_err = float((y - ry).abs().max()), abs(float(aux - raux))
    grad_err = max(float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
                   for a, b in zip(grads, rgrads))
    if not (out_err < 1e-4 * scale and aux_err < 1e-5 and grad_err < 1e-4):
        fail(f"shard-map MoE vs moe_forward at cf 16: out {out_err} (scale {scale}), aux "
             f"{aux_err}, grads {grad_err}")
    del y, ry, grads, rgrads
    with torch.no_grad():
        first, _ = sm(p, x, top_k=k, capacity_factor=cfg.capacity_factor)
        dropped = int(sm.dropped)
        again, _ = sm(p, x, top_k=k, capacity_factor=cfg.capacity_factor)
        if not torch.equal(first, again):
            fail("shard-map MoE at cf 1.25: two runs differ")
        ms = sync_time(lambda: sm(p, x, top_k=k, capacity_factor=cfg.capacity_factor), 5)
        plain = sync_time(lambda: lm_moe_forward(p, x, top_k=k,
                                                 capacity_factor=cfg.capacity_factor), 5)
    line = {"config": "deepseek-v3 MoE", "d": d, "experts": e, "d_ff": f, "top_k": k,
            "tokens": MOE_B * MOE_S, "mesh": [2, 4], "init_s": t_init, "out_err": out_err,
            "scale": scale, "aux_err": aux_err, "grad_rel_err": grad_err,
            "dropped_cf_1.25": dropped, "assignments": MOE_B * MOE_S * k, "ms_cf_1.25": ms,
            "moe_forward_ms_cf_1.25": plain, "card": name}
    stats["lm_mesh"].append(line)
    del p, x, first, again, sm
    lm_free()
    print(f"lm mesh [{name}] shard-map MoE, deepseek-v3 widths (d {d}, E {e}, f {f}, top-{k}, "
          f"1 shared), {MOE_B} x {MOE_S} tokens on a 2 x 4 mesh, float32: cf 16 vs moe_forward "
          f"out {out_err:.3e} (scale {scale:.3f}), aux {aux_err:.3e}, grads of x / router / "
          f"shared {grad_err:.3e}; cf {cfg.capacity_factor}: {dropped} of "
          f"{MOE_B * MOE_S * k} assignments dropped, two runs equal; {ms:.3f} ms a forward "
          f"vs moe_forward {plain:.3f} ms", flush=True)


MESH_SERVE_SHAPE = (2, 4)  # phase 13's serve mesh: 2 data groups x 4 model shards
MESH_SERVE_PROFILED = 1  # decode steps profiled for the busy share and kernels a step
MESH_SERVE_LLAMA_NEW = 4  # llama3.2-3b's greedy tokens on the mesh (phase 10: 32)
MESH_SERVE_GEMMA_NEW = 3  # gemma3-1b's (phase 10: 32): a cache of 1,028, which 4 divides
MESH_SERVE_CHECK_NEW = 4  # the float32 serve checks' greedy tokens after the prompt
MESH_SERVE_RECURRENT_NEW = 4  # zamba2-2.7b's and rwkv6-1.6b's greedy tokens on the mesh
MESH_SERVE_WHISPER_NEW = 4  # whisper-tiny's, after its 64-token prompt over 1,500 frames
MESH_FORCED_NEW = 4  # llama3.2-3b's teacher-forced steps at full depth, float32 and bfloat16
MESH_FORCED_RECURRENT = 2  # zamba2-2.7b's and rwkv6-1.6b's, float32
MESH_FORCED_WHISPER = 4  # whisper-tiny's, float32


def cache_leaf_bytes(cache) -> dict:
    """The bytes the mesh's first device holds of each leaf of a placed
    cache, by its path."""
    return {"/".join(map(str, path)): sh.local(0).numel() * sh.local(0).element_size()
            for path, sh in lm_partition.leaves_with_path(cache)}


def spec_cache_bytes(cfg, mesh, batch: int, seq: int, enc_len=None) -> dict:
    """The bytes one device holds of each leaf of the cache by
    ``cache_pspecs`` (the recurrent states' float32 included; whisper's
    cross cache of ``enc_len`` frames), by its path."""
    kw = {} if enc_len is None else {"enc_len": enc_len}
    shape = lm_build(cfg, "meta").model.init_cache(batch, seq, device="meta", **kw)
    specs = lm_partition.cache_pspecs(shape, cfg, lm_partition.MeshAxes(mesh))
    return {"/".join(map(str, path)):
            lm_partition.ShardedShape(tuple(t.shape), t.dtype, spec, mesh).local_bytes()
            for (path, t), (_, spec) in zip(lm_partition.leaves_with_path(shape),
                                            lm_partition.leaves_with_path(specs), strict=True)}


def lm_mesh_serve_run(label, cfg, prompt_len, name, stats, new: int = LM_NEW) -> None:
    """(d) The split serve program at full width and depth in bfloat16, as
    phase 10 or 11 serves the model (seeded weights, B = 4, its prompt,
    ``new`` greedy tokens), on a (2, 4) mesh of logical shards of the card:
    ``place_params`` -> ``MeshServe`` (each group's 4 shards compute its
    rows with their model slices, the cache in ``cache_pspecs``'s layout:
    KV heads or chunks, the recurrent states by heads), greedy as
    ``generate`` runs it: prefill ms (median of 3) and
    ms a decode step (median of the ``new`` - 1 steps) beside phase 10's one
    device, kernels a step and the busy share over ``MESH_SERVE_PROFILED``
    more steps, peak, the cache's bytes a shard against the specs' (leaf
    by leaf), and how many greedy tokens agree with one device's (bfloat16
    sums in another order may flip one, and a flipped token changes the
    rest of its row, so the count is reported, not held).  whisper's
    prompt is its frames and decoder tokens (``lm_prompt``)."""
    mesh = make_host_mesh(*MESH_SERVE_SHAPE, devices=[CARD] * 8)
    batch = lm_prompt(cfg, LM_BATCH, prompt_len, SEED + 20)
    total = prompt_len + new + MESH_SERVE_PROFILED
    bundle = lm_build(cfg)
    params = bundle.init_params(SEED)
    one = lm_greedy(bundle, params, batch, new)
    lm_free()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    placed = lm_train.place_params(mesh, cfg, params)
    del params
    lm_free()
    serve = lm_serve.MeshServe(bundle, mesh)
    prompt = lm_on_card(bundle, batch)
    ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    pre, steps = [], []
    with torch.inference_mode():
        for _ in range(3):
            a, b = ev(), ev()
            a.record()
            logits, cache = serve.prefill(placed, prompt, total)
            b.record()
            pre.append((a, b))
        out = [logits.argmax(-1)]
        for i in range(new - 1):
            a, b = ev(), ev()
            a.record()
            logits, cache = serve.decode_step(placed, cache, out[-1], prompt_len + i)
            b.record()
            steps.append((a, b))
            out.append(logits.argmax(-1))
        toks = torch.stack(out, dim=1).to(torch.int32).cpu().numpy()

        def run():
            for i in range(MESH_SERVE_PROFILED):
                serve.decode_step(placed, cache, out[i], prompt_len + new - 1 + i)

        busy_ms, kernels, _ = profiled_steps(run, MESH_SERVE_PROFILED)
    peak = torch.cuda.max_memory_allocated() - base
    held_leaves = cache_leaf_bytes(cache)
    held = sum(held_leaves.values())
    del placed, cache, serve, bundle, logits
    lm_free()
    frames = batch["frames"].shape[1] if "frames" in batch else None
    reckoned_leaves = spec_cache_bytes(cfg, mesh, LM_BATCH, total, frames)
    reckoned = sum(reckoned_leaves.values())
    if held_leaves != reckoned_leaves:
        fail(f"{label} mesh serve: a cache shard holds {held_leaves} bytes, cache_pspecs "
             f"{reckoned_leaves}")
    if toks.shape != one.shape or toks.min() < 0 or toks.max() >= cfg.vocab_size:
        fail(f"{label} mesh serve: tokens of shape {toks.shape} outside the vocabulary")
    pre_ms = float(np.median([a.elapsed_time(b) for a, b in pre]))
    step_ms = float(np.median([a.elapsed_time(b) for a, b in steps]))
    agree = int((toks == one).sum())
    ref = next(x for x in stats.get("lm", []) if x["model"] == label)
    line = {"model": label, "mesh": list(MESH_SERVE_SHAPE), "logical_shards_of": name,
            "program": "split serve", "layers": cfg.n_layers, "dtype": cfg.dtype,
            "batch": LM_BATCH, "prompt": prompt_len, "frames": frames, "new": new,
            "cache_len": total, "cache_bytes_per_leaf": held_leaves,
            "prefill_ms": pre_ms, "one_device_prefill_ms": ref["prefill_ms"],
            "decode_ms": step_ms, "one_device_decode_ms": ref["decode_ms"],
            "busy_ms": busy_ms, "busy_share": busy_ms / step_ms, "kernels_per_step": kernels,
            "peak_bytes": peak, "cache_bytes_per_shard": held,
            "spec_cache_bytes_per_shard": reckoned, "tokens_agree": agree,
            "tokens": int(toks.size), "card": name}
    stats["lm_mesh"].append(line)
    print(f"lm mesh [{name}] {label} serve on a {MESH_SERVE_SHAPE[0]} x {MESH_SERVE_SHAPE[1]} "
          f"mesh of logical shards of the card (split program, {cfg.n_layers} layers "
          f"{cfg.dtype}), B={LM_BATCH} prompt {prompt_len} + {new} greedy: prefill "
          f"{pre_ms:.3f} ms (one device {ref['prefill_ms']:.3f}), decode {step_ms:.3f} ms a "
          f"step (one device {ref['decode_ms']:.3f}), card busy {busy_ms:.3f} ms "
          f"({100 * busy_ms / step_ms:.1f}%), {kernels:.0f} kernels a step, peak "
          f"{peak / 2**30:.2f} GiB (the placed shards included), cache of {total} positions "
          + (f"and {frames} frames " if frames else "")
          + f"{held:,} bytes a shard (cache_pspecs {reckoned:,}; by leaf "
          + ", ".join(f"{k} {v:,}" for k, v in held_leaves.items())
          + f"); {agree} of {toks.size} greedy tokens equal one device's", flush=True)


def lm_mesh_serve_check(label, cfg, prompt_len, name, seed: int, decode_capacity=None) -> None:
    """(e) Float32, TF32 off: prefill of B = 4 x ``prompt_len`` and
    ``MESH_SERVE_CHECK_NEW`` greedy decode steps on one device and on the split
    serve program of a (2, 4) mesh of logical shards of the card, fed one
    device's tokens: every step's logits within 1e-4 of their scale, the
    greedy tokens equal, the MoE layers' drops equal (``decode_capacity``:
    the decode's capacity factor for this check), two mesh runs
    bit-equal; ``generate(mesh=)``'s tokens one device's."""
    mesh = make_host_mesh(*MESH_SERVE_SHAPE, devices=[CARD] * 8)
    bundle = lm_build(cfg)
    params = bundle.init_params(seed)
    tokens = torch.as_tensor(lm_prompt(cfg, LM_BATCH, prompt_len, SEED + 50)["tokens"],
                             device=CARD)
    total = prompt_len + MESH_SERVE_CHECK_NEW
    drops, route = [], lm_moe.route_logits
    prev_cf = lm_transformer.DECODE_CAPACITY_FACTOR
    if decode_capacity is not None:
        lm_transformer.DECODE_CAPACITY_FACTOR = decode_capacity

    def counted(*a, **kw):
        r = route(*a, **kw)
        drops.append(int((~r.keep).sum()))
        return r

    try:
        lm_moe.route_logits = counted
        with torch.inference_mode():
            logits, cache = bundle.prefill(params, {"tokens": tokens})
            cache = lm_serve._pad_cache_seq(cfg, cache, prompt_len, total)
            ref, toks = [logits], [logits.argmax(-1)]
            for i in range(MESH_SERVE_CHECK_NEW):
                logits, cache = bundle.decode_step(params, cache, toks[-1], prompt_len + i)
                ref.append(logits)
                toks.append(logits.argmax(-1))
        lm_moe.route_logits = route
        del cache
        placed = lm_train.place_params(mesh, cfg, params)
        del params
        lm_free()
        serve = lm_serve.MeshServe(bundle, mesh)
        runs = []
        for _ in range(2):
            logits, cache = serve.prefill(placed, {"tokens": tokens}, total)
            got, mesh_drops = [logits], serve.drops()
            for i in range(MESH_SERVE_CHECK_NEW):
                logits, cache = serve.decode_step(placed, cache, toks[i], prompt_len + i)
                got.append(logits)
                mesh_drops += serve.drops()
            runs.append((got, mesh_drops))
            del cache
        gen = lm_serve.generate(bundle, placed, tokens, max_new=MESH_SERVE_CHECK_NEW + 1,
                                mesh=mesh)
    finally:
        lm_moe.route_logits = route
        lm_transformer.DECODE_CAPACITY_FACTOR = prev_cf
    got, mesh_drops = runs[0]
    worst = max(float((g - r).abs().max()) / max(1.0, float(r.abs().max()))
                for g, r in zip(got, ref))
    equal_toks = all(torch.equal(g.argmax(-1), t) for g, t in zip(got, toks))
    if not worst < 1e-4 or not equal_toks:
        fail(f"{label} mesh serve vs one device: logits off by {worst:.3e} of their scale, "
             f"tokens equal {equal_toks}")
    if mesh_drops != drops or (cfg.is_moe and sum(drops) == 0):
        fail(f"{label} mesh serve: drops {mesh_drops}, one device {drops}")
    if not all(torch.equal(a, b) for a, b in zip(runs[1][0], got)):
        fail(f"{label} mesh serve: two runs differ")
    if not np.array_equal(gen, torch.stack(toks, dim=1).to(torch.int32).cpu().numpy()):
        fail(f"{label}: generate(mesh=) tokens differ from one device's")
    del placed, serve, bundle, runs, got, ref
    lm_free()
    print(f"lm mesh [{name}] {label} float32 serve, B={LM_BATCH} prompt {prompt_len} + "
          f"{MESH_SERVE_CHECK_NEW} greedy on {MESH_SERVE_SHAPE} (split program) vs one device: "
          f"logits within {worst:.2e} of their scale (1e-4), tokens equal"
          + (f", {sum(drops)} assignments dropped (decode capacity {decode_capacity}) as one "
             f"device's" if cfg.is_moe else "") + "; two runs bit-equal", flush=True)


def lm_mesh_teacher_forced(label, cfg, dtypes, steps, name, stats,
                           prompt_len: int = LM_PROMPT) -> None:
    """(f) A model at full width and depth, TF32 off, in each of
    ``dtypes``: one device's greedy tokens (``steps`` after a prompt of
    B = 4 x ``prompt_len``, whisper's beside its frames) teacher-forced
    through ``teacher_forced`` on one device and
    on the split serve step of a (2, 4) mesh of logical shards
    (``teacher_forced(mesh=)``): each step's logits' largest gap over their
    scale.  Float32 fails above 1e-4; a bfloat16 gap is reported (whether
    another order of bfloat16 sums explains the greedy runs' token
    disagreement)."""
    mesh = make_host_mesh(*MESH_SERVE_SHAPE, devices=[CARD] * 8)
    batch = lm_prompt(cfg, LM_BATCH, prompt_len, SEED + 20)
    line = {"model": label, "mesh": list(MESH_SERVE_SHAPE), "program": "split serve",
            "layers": cfg.n_layers, "batch": LM_BATCH, "prompt": prompt_len, "steps": steps,
            "teacher_forced": True, "card": name}
    for dtype in dtypes:
        cfg = cfg.replace(dtype=dtype)
        bundle = lm_build(cfg)
        params = bundle.init_params(SEED)
        toks = lm_greedy(bundle, params, batch, steps)
        ref = lm_serve.teacher_forced(bundle, params, lm_on_card(bundle, batch), toks)
        placed = lm_train.place_params(mesh, cfg, params)
        del params
        lm_free()
        got = lm_serve.teacher_forced(bundle, placed, lm_on_card(bundle, batch), toks, mesh=mesh)
        gaps = [float((g - r).abs().max()) / max(1.0, float(r.abs().max()))
                for g, r in zip(got, ref, strict=True)]
        agree = int((got.argmax(-1) == ref.argmax(-1)).sum())
        del placed, bundle, got, ref
        lm_free()
        line[dtype] = {"gap_per_step": gaps, "worst_gap": max(gaps), "argmax_agree": agree}
        print(f"lm mesh [{name}] {label} {dtype} full depth, teacher-forced B={LM_BATCH} "
              f"prompt {prompt_len} + {steps} steps on {MESH_SERVE_SHAPE} (split serve) "
              f"vs one device: worst gap {max(gaps):.3e} of scale; per step "
              + ", ".join(f"{g:.2e}" for g in gaps)
              + f"; {agree} of {toks.size} argmaxes equal", flush=True)
        if dtype == "float32" and not max(gaps) <= 1e-4:
            fail(f"{label} float32 split serve vs one device: logits off by {max(gaps):.3e} "
                 f"of their scale (1e-4)")
    stats["lm_mesh"].append(line)


def lm_mesh_serve(name, stats) -> None:
    """Phase 13's serve steps: (d) llama3.2-3b (KV heads on `model`: 8 on
    4) and gemma3-1b (one KV head: sequence chunks, windows, its tied
    vocab-parallel head) at full width, zamba2-2.7b (the SSM state by its
    80 heads, the shared block's KV heads, the conv tails whole) and
    rwkv6-1.6b (the state by its 32 heads, x_prev whole) at full width
    and depth, whisper-tiny (4 + 4 layers, 1,500 frames, a 64-token
    prompt: the self cache by sequence chunks or whole, the cross cache's
    6 KV heads by chunks of the frames) at full width and depth; (e)
    llama3.2-3b, gemma3-1b and deepseek-v3 (``DEEPSEEK_CHECK``'s cut:
    MLA's latent cache by sequence, MoE) at depth 2 in float32 against one
    device; (f) llama3.2-3b (float32 and bfloat16), zamba2-2.7b, rwkv6-1.6b
    and whisper-tiny (float32) at full depth teacher-forced against one
    device."""
    llama, gemma = get_config("llama3.2-3b"), get_config("gemma3-1b")
    for label, cfg, prompt_len, new in (
            ("llama3.2-3b", llama, LM_PROMPT, MESH_SERVE_LLAMA_NEW),
            ("gemma3-1b", gemma, 2 * gemma.sliding_window, MESH_SERVE_GEMMA_NEW),
            ("zamba2-2.7b", get_config("zamba2-2.7b"), LM_PROMPT, MESH_SERVE_RECURRENT_NEW),
            ("rwkv6-1.6b", get_config("rwkv6-1.6b"), LM_PROMPT, MESH_SERVE_RECURRENT_NEW),
            ("whisper-tiny", get_config("whisper-tiny"), WHISPER_PROMPT,
             MESH_SERVE_WHISPER_NEW)):
        t0 = time.perf_counter()
        lm_mesh_serve_run(label, cfg, prompt_len, name, stats, new)
        print(f"lm mesh serve {label} {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    lm_mesh_serve_check("llama3.2-3b depth 2", llama.replace(n_layers=2, dtype="float32"),
                        LM_PROMPT, name, 8)
    lm_mesh_serve_check("gemma3-1b depth 2", gemma.replace(n_layers=2, dtype="float32"),
                        2 * gemma.sliding_window, name, 9)
    # decode capacity 0.5: 1 slot an expert for B = 4, so the decode drops too
    lm_mesh_serve_check("deepseek-v3 depth 2", get_config("deepseek-v3-671b").replace(
        **DEEPSEEK_CHECK), LM_PROMPT, name, 10, decode_capacity=0.5)
    print(f"lm mesh serve float32 checks {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    lm_mesh_teacher_forced("llama3.2-3b", llama, ("float32", "bfloat16"), MESH_FORCED_NEW, name,
                           stats)
    for label in ("zamba2-2.7b", "rwkv6-1.6b"):
        lm_mesh_teacher_forced(label, get_config(label), ("float32",), MESH_FORCED_RECURRENT,
                               name, stats)
    lm_mesh_teacher_forced("whisper-tiny", get_config("whisper-tiny"), ("float32",),
                           MESH_FORCED_WHISPER, name, stats, WHISPER_PROMPT)
    print(f"lm mesh teacher-forced checks {time.perf_counter() - t0:.1f} s", flush=True)


def phase_lm_mesh(name, stats) -> None:
    """Phase 13: the LM mesh on logical shards of the card."""
    lm_free()
    t0 = time.perf_counter()
    lm_mesh_train(name, stats)
    print(f"lm mesh training {time.perf_counter() - t0:.1f} s", flush=True)
    lm_mesh_equals_one_device(name)
    lm_mesh_moe_equals_one_device(name)
    lm_mesh_families(name, stats)
    lm_flash_decode(name, stats)
    lm_shardmap_moe(name, stats)
    t0 = time.perf_counter()
    lm_mesh_serve(name, stats)
    print(f"lm mesh serving {time.perf_counter() - t0:.1f} s", flush=True)
    for line in stats["lm_mesh"]:
        print("lm mesh " + json.dumps(line), flush=True)


DRY_CELLS = [("llama3.2-3b", "train_4k"), ("deepseek-v3-671b", "train_4k"),
             ("deepseek-v3-671b", "decode_32k"), ("llama3.2-3b", "prefill_32k"),
             ("zamba2-2.7b", "decode_32k"), ("whisper-tiny", "decode_32k"),
             ("xtime-tabular", "serve_1m")]  # phase 14's production cells, 16 x 16
# traced on the gathered program too
DRY_GATHERED = [("zamba2-2.7b", "decode_32k"), ("whisper-tiny", "decode_32k")]


def held_bytes(*trees) -> int:
    """Bytes of the distinct storages of the tensors (or a placed tree's
    shards) in ``trees``."""
    seen, total = set(), 0
    for tree in trees:
        for t in lm_tree_tensors(tree):
            for shard in (t.shards.flat if hasattr(t, "shards") else [t]):
                st = shard.untyped_storage()
                if st.data_ptr() not in seen:
                    seen.add(st.data_ptr())
                    total += st.nbytes()
    return total


def dry_one_device(name, stats) -> None:
    """(a) llama3.2-3b as phase 12 trains it (28 layers, bfloat16, remat,
    float32 moments, B = 8 x 1,024) on a (1, 1) mesh of the card: the dry
    run's reckoning (a meta trace of the program ``MeshStep`` runs) against
    the card.  The argument bytes must equal the bytes of the parameters,
    moments, step and batch the card holds; the trace's dot FLOPs must
    equal ``FlopCounterMode`` over one real ``make_train_step(mesh=)``
    step; its bytes a device beside the next step's peak, its roofline
    bound beside that step's ms."""
    cfg = get_config("llama3.2-3b")
    cell = ShapeCell("train", TRAIN_S, TRAIN_B, "train")
    mesh = Mesh(np.array([[CARD]], dtype=object), ("data", "model"))
    base = torch.cuda.memory_allocated()
    bundle = lm_build(cfg)
    t0 = time.perf_counter()
    cost, r = lm_dryrun.reckon_lm(cfg, cell, mesh, flash_blk=bundle.model.flash_blk)
    trace_s = time.perf_counter() - t0
    res = lm_dryrun.result_of(cost, {"n_compute_devices": 1, "memory": r["memory"],
                                     "transfer": r["transfer"], "model_flops_total": 0.0})
    want_args = lm_dryrun.argument_bytes(cfg, cell, mesh)

    opt = lm_adamw.AdamW(train_opt_cfg(TRAIN_STEPS))
    if opt.cfg.moment_dtype != lm_dryrun._moe_moment_dtype(cfg):
        fail("dry run llama3.2-3b: the step's moments are not the dry run's dtype")
    params = lm_train.place_params(mesh, cfg, bundle.init_params(SEED))
    lm_free()  # the whole initial copy
    state = opt.init(params)
    pipe = lm_tokens.TokenPipeline(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=SEED)
    batches = [lm_train.place_batch(mesh, {k: torch.as_tensor(v).to(CARD)  # int32, as the specs
                                           for k, v in pipe.batch(i).items()}) for i in range(2)]
    held = held_bytes(params, state["m"], state["v"], state["step"], batches[0])
    if held != want_args:
        fail(f"dry run llama3.2-3b (1, 1): argument bytes {want_args} reckoned, the card "
             f"holds {held}")
    step_fn = lm_train.make_train_step(bundle, opt, mesh)
    with FlopCounterMode(display=False) as fcm:
        params, state, _, m = step_fn(params, state, None, batches[0])
        torch.cuda.synchronize()
    card_flops = fcm.get_total_flops()
    if card_flops != cost.dot_flops:
        fail(f"dry run llama3.2-3b (1, 1): {cost.dot_flops:.6e} dot FLOPs on meta, "
             f"FlopCounterMode {card_flops:.6e} on the card")
    torch.cuda.reset_peak_memory_stats()
    a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    params, state, _, m2 = step_fn(params, state, None, batches[1])
    e.record()
    torch.cuda.synchronize()
    step_ms, peak = a.elapsed_time(e), torch.cuda.max_memory_allocated() - base
    finite("dry run llama3.2-3b (1, 1)", [float(m["loss"]), float(m2["loss"])],
           [float(m["grad_norm"]), float(m2["grad_norm"])])
    del params, state, step_fn, bundle, batches, m, m2
    lm_free()
    mem, roof = res["memory"], res["roofline"]
    arg_temp = mem["argument_bytes"] + mem["temp_bytes"]
    total = arg_temp + mem["gathered_bytes"] + mem["sum_bytes"]
    line = {"model": "llama3.2-3b", "mesh": "(1, 1) of the card", "batch": TRAIN_B,
            "seq": TRAIN_S, "trace_s": trace_s, "argument_bytes": want_args,
            "held_bytes": held, "dot_flops": cost.dot_flops, "flop_counter_flops": card_flops,
            "n_ops": cost.n_ops, "temp_bytes": mem["temp_bytes"],
            "gathered_bytes": mem["gathered_bytes"], "sum_bytes": mem["sum_bytes"],
            "argument_plus_temp_bytes": arg_temp, "reckoned_bytes": total, "peak_bytes": peak,
            "reckoned_share_of_peak": total / peak, "bound_s": roof["bound_s"],
            "dominant": roof["dominant"], "compute_s": roof["compute_s"],
            "memory_s": roof["memory_s"], "step_ms": step_ms,
            "bound_share": roof["bound_s"] * 1e3 / step_ms, "card": name}
    stats["dryrun"] = [line]
    print(f"dry run [{name}] llama3.2-3b on a (1, 1) mesh of the card, B = {TRAIN_B} x "
          f"{TRAIN_S}: meta trace {trace_s:.1f} s ({cost.n_ops} ops); argument bytes "
          f"{want_args} reckoned == {held} held on the card; dot FLOPs {cost.dot_flops:.6e} "
          f"on meta == FlopCounterMode {card_flops:.6e} over a real step; argument + temp "
          f"{arg_temp / 2**30:.3f} GiB, with the gathered copy and the float32 sums "
          f"{total / 2**30:.3f} GiB, beside the step's peak {peak / 2**30:.3f} GiB "
          f"({100 * total / peak:.1f}%); roofline bound {1e3 * roof['bound_s']:.3f} ms "
          f"({roof['dominant']}) beside the step's {step_ms:.3f} ms "
          f"({100 * line['bound_share']:.1f}%)", flush=True)


def start_dry_cells() -> tuple:
    """The production cells, traced on meta devices (no card, host only):
    the dry run's command line for each cell, in processes of their own at
    the lowest priority, started together while phase 13 runs on the card
    (one core each; the card's host thread keeps its own).  Each writes its
    result to ``results/dryrun_torch``."""
    out_dir = ROOT / "results" / "dryrun_torch"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.update(OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
         "--out-dir", str(out_dir)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=env, cwd=str(ROOT), preexec_fn=lambda: os.nice(19)) for arch, shape in DRY_CELLS]
    return out_dir, procs, time.perf_counter()


def dry_production_cells(name, stats, started) -> None:
    """(b) the production cells on a 16 x 16 mesh of meta devices
    (``start_dry_cells``), each timed, each printing the reference's three
    lines."""
    out_dir, procs, t0 = started
    for (arch, shape), (rc, out, err, _) in zip(DRY_CELLS, wait_together(procs, t0, 900)):
        if rc != 0:
            fail(f"dry run {arch} {shape}: rc {rc}\n{out[-2000:]}{err[-2000:]}")
        res = json.loads((out_dir / f"{arch}__{shape}__single.json").read_text())
        wall = res["wall_s"]
        if res["status"] != "ok":
            fail(f"dry run {arch} {shape}: {res['status']} {res.get('error')}\n"
                 f"{res.get('traceback', '')}")
        brief = {k: v for k, v in res.items()
                 if k in ("arch", "shape", "mesh", "status", "trace_s", "wall_s")}
        mem = res["memory"]
        print(f"dry run [{name}] {arch} {shape} on 16 x 16 meta devices ({wall:.1f} s): "
              f"n_compute_devices {res['n_compute_devices']}, the fullest device holds "
              f"{mem['total_per_device_gib']} GiB (fits 80 GiB: {mem['fits_h100_80gib']}), "
              f"dominant {res['roofline']['dominant']}", flush=True)
        print(json.dumps(brief), flush=True)
        print("memory_analysis:", json.dumps(res["memory"]), flush=True)
        print("roofline:", json.dumps(res["roofline"]), flush=True)
        stats["dryrun"].append({"cell": f"{arch} {shape}", "seconds": wall,
                                "n_compute_devices": res["n_compute_devices"],
                                "memory": res["memory"], "counted": res["counted"],
                                "roofline": res["roofline"]})
        if (arch, shape) in DRY_GATHERED:
            dry_gathered_cell(arch, shape, res, name, stats)


def dry_gathered_cell(arch, shape, split, name, stats) -> None:
    """A cell of a family the split program took over, traced once more as
    the gathered program runs it (one compute device a data group, whole
    parameters gathered onto it): its fullest device beside the split
    program's."""
    out_dir = tempfile.mkdtemp(prefix="dryrun_gathered_")
    families = lm_dryrun.SPLIT_FAMILIES
    lm_dryrun.SPLIT_FAMILIES = ("dense", "moe", "vlm")  # the transformers only
    try:
        t0 = time.perf_counter()
        res = lm_dryrun.run_cell(arch, shape, False, out_dir)
    finally:
        lm_dryrun.SPLIT_FAMILIES = families
        shutil.rmtree(out_dir, ignore_errors=True)
    if res["status"] != "ok":
        fail(f"dry run {arch} {shape} gathered: {res['status']} {res.get('error')}")
    if not split["n_compute_devices"] == split["n_devices"] > res["n_compute_devices"]:
        fail(f"dry run {arch} {shape}: {split['n_compute_devices']} compute devices on the "
             f"split program, {res['n_compute_devices']} on the gathered one")
    mem, smem = res["memory"], split["memory"]
    print(f"dry run [{name}] {arch} {shape} on the gathered program ({time.perf_counter() - t0:.1f}"
          f" s): n_compute_devices {res['n_compute_devices']}, the fullest device holds "
          f"{mem['total_per_device_gib']} GiB (fits 80 GiB: {mem['fits_h100_80gib']}), dominant "
          f"{res['roofline']['dominant']}; the split program: {split['n_compute_devices']}, "
          f"{smem['total_per_device_gib']} GiB ({smem['fits_h100_80gib']}), dominant "
          f"{split['roofline']['dominant']}", flush=True)
    print("memory_analysis (gathered):", json.dumps(mem), flush=True)
    stats["dryrun"].append({"cell": f"{arch} {shape} gathered",
                            "n_compute_devices": res["n_compute_devices"], "memory": mem,
                            "counted": res["counted"], "roofline": res["roofline"]})


def phase_dryrun(name, stats, started) -> None:
    """Phase 14: the dry run, held against the card; ``started``: the
    production cells' processes (``start_dry_cells``)."""
    lm_free()
    dry_one_device(name, stats)
    dry_production_cells(name, stats, started)


def kernel_entry(name, source, launches, err, ms, plain_ms, bnd, by) -> dict:
    """One object of the kernels line: ``source`` a file of kernels/csrc,
    every time measured in this run, no single PyTorch call to compare."""
    return {"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": "src/repro/kernels/cam_match.py:90", "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd,
            "bound_by": by, "library_ms": None}


def main() -> int:
    t_start = time.perf_counter()
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
    phase_direct_packed_times(cm, batches, name)
    phase_soft_times(soft, batches, name, stats)
    for label, phase in (("serving", lambda: phase_serving(cm, soft, name, stats)),
                         ("cluster", lambda: phase_cluster(cm, name, stats)),
                         ("scoring", lambda: phase_scoring(cm, name, stats)),
                         ("traversal", lambda: phase_traversal(ens, cm, batches, name)),
                         ("goldens", lambda: phase_goldens(name)),
                         ("ingested", lambda: phase_ingested(ens, name, stats)),
                         ("compression levels", lambda: phase_compress_levels(name, stats)),
                         ("degenerate tables", lambda: phase_degenerate(name)),
                         ("trained", lambda: phase_trained(name)),
                         ("wide model", lambda: phase_wide_model(name, stats)),
                         ("968 features", lambda: phase_bosch_width(name, stats)),
                         ("operator's tools", lambda: phase_tools(cm, soft, batches, name,
                                                                  stats)),
                         ("mesh and checkpoint", lambda: phase_mesh_all(ens, cm, soft, batches,
                                                                        name, stats))):
        t0 = time.perf_counter()
        phase()
        print(f"{label} phase {time.perf_counter() - t0:.1f} s", flush=True)
    # the LM models need the card's memory: drop the tabular artifacts first
    del ens, cm, soft, batches, phase
    lm_free()
    print(f"LM serving: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still allocated "
          f"after phases 1-9", flush=True)
    t0 = time.perf_counter()
    phase_lm(name, stats)
    print(f"LM serving phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_lm_families(name, stats)
    print(f"LM families phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_lm_profiles(name, stats)
    print(f"LM profiles {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    phase_lm_train(name, stats)
    print(f"LM training phase {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    dry_cells = start_dry_cells()  # host only: traced while phase 13 runs on the card
    try:
        phase_lm_mesh(name, stats)
        print(f"LM mesh phase {time.perf_counter() - t0:.1f} s", flush=True)
        t0 = time.perf_counter()
        phase_dryrun(name, stats, dry_cells)
        print(f"dry run phase {time.perf_counter() - t0:.1f} s", flush=True)
    finally:
        for proc in dry_cells[1]:  # ended on every path
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all", flush=True)

    lines = [stats["kernel_line"], stats["soft_kernel_line"], *stats["variant_lines"],
             *stats["soft_variant_lines"], *stats["wide_lines"], *stats["bosch_lines"]]
    print(json.dumps({"kernels": lines}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

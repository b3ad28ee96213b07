"""The Hopper CAM-match kernels: build, ctypes binding and launch wrappers.

They replace the Pallas TPU kernel ``_cam_match_kernel``
(``cam_match_pallas`` in ``src/repro/kernels/cam_match.py``):
``csrc/cam_match.cu`` for the four hard cell modes, ``csrc/cam_match_soft.cu``
for the soft mode on float32 tables (and, over the moments matrix, the
uncertainty pass).  ``nvcc`` compiles each source for ``sm_90a`` (all at
once, one process each) and links them into one shared library with a
plain C interface at first use, under ``build/repro_torch/`` in the
checkout, keyed on a hash of every source and the flags — so a fresh
checkout builds it on its own and a rebuilt source never loads a stale
library.  Nothing here runs at import time: the CPU tests import this
module on machines with no ``nvcc`` and no card.

Both kernels read the table as its per-row cell list (``ops.CellList``,
built by ``ops.binding_cells`` at bind time): each row's non-wildcard
cells, in ascending feature order, and nothing of the dense tables (the
uint8 tables' kernel reads each cell as one packed word,
``CellList.words``).  The
wrappers take CUDA tensors only; they check device, dtype, shape and
contiguity (the list checked its own counts when it was made), allocate
the outputs and the split workspace with ``torch.empty``, launch on the
current stream, raise on a non-zero ``cudaError_t`` and count their
launches (``<wrapper>.launches``).  The build and the load run under one
lock: threads of a process that first launch at once build the library
once, and the others wait for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.precision import soft_inv
from repro_torch.kernels.ops import CellList

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "cam_match.cu", CSRC / "cam_match_soft.cu")
HEADERS = (CSRC / "cam_match_common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
# no --use_fast_math: the soft kernel's expf/log1pf are the accurate ones
NVCC_FLAGS = (ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# rows per block of the match kernels (a multiple of their 128-row chunk):
# the split count — and so the float summation order — depends on R alone
ROWS_PER_SPLIT = 1024
QUERIES_PER_TILE = 32
# a uint8 list whose span is at most this runs the bit-parallel kernel (its
# bitmaps' shared-memory window, `kMaxWindow` in cam_match.cu); a wider one
# the lane-per-query kernel
BITMAP_FEATURES = 223

_DTYPE_CODE = {torch.uint8: 0, torch.uint16: 1, torch.int32: 2}
_MODE_CODE = {"direct": 0, "inclusive": 1, "msb_lsb": 2, "two_cycle": 3}
_INT32_ONLY = ("msb_lsb", "two_cycle")

# re-entrant: _library() builds under it, and build() takes it too
_BUILD_LOCK = threading.RLock()
_LIB: ctypes.CDLL | None = None
_COUNT_LOCK = threading.Lock()


@dataclass(frozen=True)
class BuildInfo:
    path: Path
    seconds: float  # 0.0 when an earlier build of the same sources was reused
    log: str  # nvcc's output: ptxas registers, shared memory and spills


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the "
        "cam_match kernel is built from csrc/ with the CUDA toolkit"
    )


def _run(cmds: list[list[str]]) -> str:
    """Run the commands side by side; return their output, or raise with
    the first failure's."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    outs = [(*p.communicate(), p.returncode) for p in procs]
    for cmd, (out, err, rc) in zip(cmds, outs):
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}{err}")
    return "".join(out + err for out, err, _ in outs)


def build() -> BuildInfo:
    """Compile the kernel library unless these exact sources are built:
    one ``nvcc -c`` per source, started together, then one link.  One
    thread at a time: the others wait and then find the library built."""
    with _BUILD_LOCK:
        return _build_locked()


def _build_locked() -> BuildInfo:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (*SOURCES, *HEADERS):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    tag = digest.hexdigest()[:16]
    lib = BUILD_DIR / f"cam_match_{tag}.so"
    log = lib.with_suffix(".log")
    if lib.is_file():
        return BuildInfo(lib, 0.0, log.read_text() if log.is_file() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, pid = _nvcc(), os.getpid()
    objs = [BUILD_DIR / f"{src.stem}_{tag}.{pid}.o" for src in SOURCES]
    tmp = lib.with_name(f"{lib.stem}.{pid}.tmp.so")
    t0 = time.perf_counter()
    text = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                 for src, o in zip(SOURCES, objs)])
    text += _run([[nvcc, ARCH, "-shared", "-o", str(tmp), *map(str, objs)]])
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink()
    log.write_text(text)
    os.replace(tmp, lib)  # atomic: a concurrent build never loads half a file
    return BuildInfo(lib, seconds, text)


def _library() -> ctypes.CDLL:
    """The loaded kernel library, built and bound on first use (once per
    process, whichever thread comes first)."""
    global _LIB
    lib = _LIB
    if lib is None:
        with _BUILD_LOCK:
            if _LIB is None:
                _LIB = _bind(ctypes.CDLL(str(build().path)))
            lib = _LIB
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    cells = [p, p, p, p, i]  # count, feat, lo, hi, K
    rest = [
        p, p,  # leaf, bias
        i, i, i, i, i,  # B, R, F, C, rows_per_split
        p, p, p, p,  # ws, out, bits or scores, stream
    ]
    # dtype, mode, q, count, feat, lo, hi, words, span, K
    lib.xtime_cam_match.argtypes = [i, i, p, *cells[:4], p, i, i, *rest]
    lib.xtime_cam_match.restype = i
    # tau_zero, inv, lattice, span, q
    lib.xtime_cam_match_soft.argtypes = [i, ctypes.c_float, i, i, p, *cells, *rest]
    lib.xtime_cam_match_soft.restype = i
    lib.xtime_error_string.argtypes = [i]
    lib.xtime_error_string.restype = ctypes.c_char_p
    return lib


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _check_cells(q, cells, table_dtype) -> None:
    """Device, layout and shapes of the query block and the cell list."""
    if not isinstance(cells, CellList):
        raise ValueError(f"the kernels take the table as an ops.CellList, got {type(cells).__name__}")
    tensors = {"q": q, "count": cells.count, "feat": cells.feat, "lo": cells.lo, "hi": cells.hi}
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dim() != 2 or q.shape[1] != cells.width:
        raise ValueError(f"q {tuple(q.shape)} must be (B, {cells.width}), the cell list's width")
    if q.dtype != table_dtype or cells.lo.dtype != table_dtype:
        raise ValueError(
            f"q and the cell bounds must be {table_dtype}; got {q.dtype}/{cells.lo.dtype}"
        )


def _check_hard(q, cells, mode) -> None:
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"q must be one of {list(_DTYPE_CODE)}; got {q.dtype}")
    _check_cells(q, cells, q.dtype)
    if mode not in _MODE_CODE:
        raise ValueError(f"mode {mode!r} has no kernel; kernel modes: {list(_MODE_CODE)}")
    if mode in _INT32_ONLY and q.dtype != torch.int32:
        raise ValueError(f"mode {mode!r} runs on int32 tables only, got {q.dtype}")
    if q.dtype == torch.uint8 and (cells.words is None or not cells.words.is_cuda
                                   or cells.words.device != q.device
                                   or not cells.words.is_contiguous()):
        raise ValueError("a uint8 cell list needs its packed words (CellList.words) "
                         f"contiguous on {q.device}")


def _check_soft(q, cells, tau) -> None:
    _check_cells(q, cells, torch.float32)
    if not (isinstance(tau, (int, float)) and np.isfinite(tau) and tau >= 0.0):
        raise ValueError(f"tau must be a finite temperature >= 0, got {tau!r}")


def _check_leaf_bias(q, cells, leaf, bias) -> None:
    R, C = leaf.shape
    if (leaf.dtype != torch.float32 or not leaf.is_contiguous()
            or leaf.device != q.device or R != cells.count.shape[0] or C == 0):
        raise ValueError(
            f"leaf must be a contiguous float32 ({cells.count.shape[0]}, C_pad) tensor "
            f"on {q.device}, got {leaf.dtype} {tuple(leaf.shape)} on {leaf.device}"
        )
    if bias is not None:
        if (bias.dtype != torch.float32 or bias.device != q.device
                or tuple(bias.shape) != (1, C) or not bias.is_contiguous()):
            raise ValueError(f"bias must be a contiguous float32 (1, {C}) tensor on {q.device}")


def _launch(entry: str, head: tuple, q, cells: CellList, leaf, bias, *, ws, out,
            extra) -> None:
    """Call the C entry ``entry`` (its own leading arguments ``head``, then
    the operands every entry takes, with ``extra`` its second output) on
    ``q``'s device and current stream; raise on a non-zero cudaError_t."""
    lib = _library()
    B, F = q.shape
    R, K = cells.feat.shape
    C = 0 if leaf is None else leaf.shape[1]
    listed = [_ptr(cells.count), _ptr(cells.feat), _ptr(cells.lo), _ptr(cells.hi)]
    if entry == "xtime_cam_match":
        listed += [_ptr(cells.words), cells.span]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, entry)(
            *head, _ptr(q), *listed, K, _ptr(leaf), _ptr(bias), B, R, F, C,
            ROWS_PER_SPLIT, _ptr(ws), _ptr(out), _ptr(extra), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"{entry} kernel launch failed: {lib.xtime_error_string(rc).decode()} ({rc})"
        )


def _counted(wrapper) -> None:
    """One more launch of ``wrapper``'s kernel; replica threads launch at once."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def _hard(q, mode) -> tuple:
    return _DTYPE_CODE[q.dtype], _MODE_CODE[mode]


def _soft(tau, cells: CellList) -> tuple:
    """tau_zero, inv = float32(1 / tau) as the plain version computes it,
    whether the list's bounds lie on the kernel's lattice, and its span."""
    if tau == 0.0:
        return 1, 0.0, 0, cells.width
    return 0, soft_inv(tau), int(cells.lattice), cells.span


def n_splits(n_rows: int) -> int:
    return -(-n_rows // ROWS_PER_SPLIT)


def cam_match_cuda(
    q: torch.Tensor,  # (B, F_pad) table dtype
    cells: CellList,  # the table's cell list on q's device, (R_pad, K)
    leaf: torch.Tensor,  # (R_pad, C_pad) float32
    bias: torch.Tensor | None = None,  # (1, C_pad) float32, added once
    *,
    mode: str = "direct",
) -> torch.Tensor:
    """(B, C_pad) float32 leaf sums on the card."""
    _check_hard(q, cells, mode)
    _check_leaf_bias(q, cells, leaf, bias)
    R, C = leaf.shape
    B = q.shape[0]
    out = torch.empty((B, C), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    ws = torch.empty((n_splits(R), B, C), dtype=torch.float32, device=q.device)
    _launch("xtime_cam_match", _hard(q, mode), q, cells, leaf, bias, ws=ws, out=out,
            extra=None)
    _counted(cam_match_cuda)
    return out


cam_match_cuda.launches = 0


def cam_match_bits_cuda(q: torch.Tensor, cells: CellList, *, mode: str = "direct") -> torch.Tensor:
    """(B, R) boolean match lines from the same kernel (no leaf product)."""
    _check_hard(q, cells, mode)
    B, R = q.shape[0], cells.count.shape[0]
    if B == 0:
        return torch.zeros((0, R), dtype=torch.bool, device=q.device)
    n_words = -(-B // QUERIES_PER_TILE)
    words = torch.empty((n_words, R), dtype=torch.int32, device=q.device)
    _launch("xtime_cam_match", _hard(q, mode), q, cells, None, None, ws=None, out=None,
            extra=words)
    _counted(cam_match_bits_cuda)
    shifts = torch.arange(QUERIES_PER_TILE, device=q.device, dtype=torch.int32)
    unpacked = (words[:, None, :] >> shifts[None, :, None]) & 1  # (words, 32, R)
    return unpacked.reshape(n_words * QUERIES_PER_TILE, R)[:B].to(torch.bool)


cam_match_bits_cuda.launches = 0


def cam_match_soft_cuda(
    q: torch.Tensor,  # (B, F_pad) float32 bins
    cells: CellList,  # the soft table's cell list on q's device, (R_pad, K)
    leaf: torch.Tensor,  # (R_pad, C_pad) float32 (or the moments matrix)
    bias: torch.Tensor | None = None,  # (1, C_pad) float32, added once
    *,
    tau: float,
) -> torch.Tensor:
    """(B, C_pad) float32 soft leaf sums ``SUM_r score[b, r] * leaf[r, :]``
    on the card; ``tau`` in bin units, 0 the exact indicator."""
    _check_soft(q, cells, tau)
    _check_leaf_bias(q, cells, leaf, bias)
    R, C = leaf.shape
    B = q.shape[0]
    out = torch.empty((B, C), dtype=torch.float32, device=q.device)
    if B == 0:
        return out
    ws = torch.empty((n_splits(R), B, C), dtype=torch.float32, device=q.device)
    _launch("xtime_cam_match_soft", _soft(tau, cells), q, cells, leaf, bias, ws=ws, out=out,
            extra=None)
    _counted(cam_match_soft_cuda)
    return out


cam_match_soft_cuda.launches = 0


def soft_scores_cuda(q: torch.Tensor, cells: CellList, *, tau: float) -> torch.Tensor:
    """(B, R) float32 row scores from the soft kernel (no leaf product)."""
    _check_soft(q, cells, tau)
    B, R = q.shape[0], cells.count.shape[0]
    scores = torch.empty((B, R), dtype=torch.float32, device=q.device)
    if B == 0:
        return scores
    _launch("xtime_cam_match_soft", _soft(tau, cells), q, cells, None, None, ws=None, out=None,
            extra=scores)
    _counted(soft_scores_cuda)
    return scores


soft_scores_cuda.launches = 0

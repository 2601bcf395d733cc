"""The tile blend's hand-written CUDA kernels, their build and launchers.

  * csrc/blend_fwd.cu, `hidegs_blend_fwd`: the forward blend; replaces the
    JAX package's Pallas kernel hidegs_tpu/raster/pallas_blend.py:_forward_kernel.
  * csrc/blend_bwd.cu, `hidegs_blend_bwd`: the backward blend, one gradient
    row per instance, written at the instance's expansion slot (each
    gaussian's rows contiguous); replaces
    hidegs_tpu/raster/pallas_vjp.py:_passB_kernel.
  * csrc/blend_bwd.cu, `hidegs_fold_rows`: the per-gaussian sum of those
    rows, in a fixed order (no float atomics).
  * csrc/blend_common.cuh, included by both sources: the packed-row layout,
    the map from threads to pixels and the warp-block mask
    (blend_plain.block_masks is its plain version), and the bf16 rows.

Both blends take their rows in either of two modes, chosen by the rows'
dtype: float32 (N, 16) packed rows (`hidegs_blend_fwd`, `hidegs_blend_bwd`),
or the (N, 16) bfloat16 rows of the bf16 stream (blend_plain.bf16_rows;
`hidegs_blend_fwd_bf16`, `hidegs_blend_bwd_bf16`), which the kernels re-base
to each tile and widen as they stage them. A launch of either mode counts
as a launch of that kernel.

Each source is compiled by `nvcc` for sm_90a into build/kernels/ at first
use (all sources at once, one process each), loaded with ctypes, and
launched on PyTorch's current stream. Every launcher checks its inputs,
raises on a failed launch, and counts its launches.

`blend_tile_out` and `grad_attrs` are the CUDA halves of the autograd
Function in raster/blend_autograd.py; their plain PyTorch versions are in
raster/blend_plain.py.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Tuple

import torch

from hidegs_tpu_torch.raster.binning import TileBinning
from hidegs_tpu_torch.raster import blend_plain
from hidegs_tpu_torch.raster.blend_plain import ATTR, OUT_CH

# Launches in this process, one per call of the launcher named beside it.
LAUNCHES = 0  # launch_blend_fwd
BWD_LAUNCHES = 0  # launch_blend_bwd
FOLD_LAUNCHES = 0  # launch_fold_rows

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"blend_fwd": CSRC / "blend_fwd.cu", "blend_bwd": CSRC / "blend_bwd.cu"}
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# -fmad=false: see the FMA note in the sources.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
TILES = (16, 32)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = Path(CUDA_HOME) / "bin" / "nvcc"
        if path.exists():
            return str(path)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _lib_path(src: Path) -> Path:
    """The library of source `src`, named by a hash of the source, every
    header beside it (which the sources include) and the flags, so that a
    changed header never loads a stale library."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:16]}.so"


def build(sources: Dict[str, Path] = SOURCES) -> Dict[str, Path]:
    """Compile every source whose library (same source, same headers, same
    flags) is not in build/kernels/ yet, each library once, all nvcc
    processes at once; returns
    the library paths by name. Each compiler's register/shared-memory report
    lands next to its library as a .log file."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources.values():
        lib = _lib_path(src)
        if lib.exists() or any(lib == job[3] for job in jobs):  # two names for one source build once
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((proc, cmd, tmp, lib))
    failed = []
    for proc, cmd, tmp, lib in jobs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
            continue
        lib.with_suffix(".log").write_text(out + err)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _lib_path(src) for name, src in sources.items()}


@functools.cache
def bind(lib: Path, symbol: str, n_ptr_head: int, n_int: int, n_ptr_tail: int):
    """C entry point `symbol` of library `lib`: n_ptr_head pointers, n_int
    ints, n_ptr_tail pointers (the stream last); returns a cudaError code."""
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr_head + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p] * n_ptr_tail)
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _fn(name: str, symbol: str, n_ptr_head: int, n_int: int, n_ptr_tail: int):
    return bind(build()[name], symbol, n_ptr_head, n_int, n_ptr_tail)


def _check(name, x, dtype, shape, device):
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_spans(attrs, gauss_id, tile_start, tile_count, tiles_x, tile):
    dev = attrs.device
    if dev.type != "cuda":
        raise ValueError(f"the blend kernels need CUDA tensors, got {dev}")
    if tile not in TILES:
        raise ValueError(f"tile must be one of {TILES}, got {tile}")
    T = tile_start.shape[0]
    dtype = torch.bfloat16 if attrs.dtype == torch.bfloat16 else torch.float32
    _check("attrs", attrs, dtype, (attrs.shape[0], ATTR), dev)
    _check("gauss_id", gauss_id, torch.int32, (gauss_id.shape[0],), dev)
    _check("tile_start", tile_start, torch.int32, (T,), dev)
    _check("tile_count", tile_count, torch.int32, (T,), dev)
    if T % tiles_x:
        raise ValueError(f"{T} tiles is not a multiple of tiles_x={tiles_x}")
    return dev, T


def _symbol(name: str, attrs: torch.Tensor) -> str:
    """The entry point of the rows' mode: `name`, or its bf16 variant."""
    return f"{name}_bf16" if attrs.dtype == torch.bfloat16 else name


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def launch_blend_fwd(
    attrs: torch.Tensor,
    gauss_id: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tiles_x: int,
    tile: int,
    out: torch.Tensor,
    observe: torch.Tensor,
) -> None:
    """Launch the forward kernel once on the current stream. Writes `out`
    (T, P, 16) and the per-instance counts into `observe` (I,), which must
    be zeroed. `attrs` is float32 packed rows or bfloat16 `bf16_rows`."""
    global LAUNCHES
    dev, T = _check_spans(attrs, gauss_id, tile_start, tile_count, tiles_x, tile)
    _check("out", out, torch.float32, (T, tile * tile, OUT_CH), dev)
    _check("observe", observe, torch.int32, gauss_id.shape, dev)
    fn = _fn("blend_fwd", _symbol("hidegs_blend_fwd", attrs), 4, 3, 3)
    with torch.cuda.device(dev):
        rc = fn(attrs.data_ptr(), gauss_id.data_ptr(), tile_start.data_ptr(),
                tile_count.data_ptr(), T, tiles_x, tile, out.data_ptr(),
                observe.data_ptr(), _stream(dev))
    LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"blend_fwd kernel launch failed: cudaError {rc}")


def launch_blend_bwd(
    attrs: torch.Tensor,
    gauss_id: torch.Tensor,
    tile_start: torch.Tensor,
    tile_count: torch.Tensor,
    tiles_x: int,
    tile: int,
    slot_s: torch.Tensor,
    g_aug: torch.Tensor,
    rows: torch.Tensor,
) -> None:
    """Launch the backward kernel once on the current stream (`attrs` as in
    launch_blend_fwd). `g_aug` (T, P, 16) holds the augmented cotangents
    (blend_plain.augment_cotangents);
    writes the gradient row of sorted instance k into row `slot_s[k]` of
    `rows` (I, 16), which must be zeroed. `slot_s` must be a permutation of
    [0, I) (TileBinning.slot_s is)."""
    global BWD_LAUNCHES
    dev, T = _check_spans(attrs, gauss_id, tile_start, tile_count, tiles_x, tile)
    _check("slot_s", slot_s, torch.int32, gauss_id.shape, dev)
    _check("g_aug", g_aug, torch.float32, (T, tile * tile, OUT_CH), dev)
    _check("rows", rows, torch.float32, (gauss_id.shape[0], ATTR), dev)
    fn = _fn("blend_bwd", _symbol("hidegs_blend_bwd", attrs), 4, 3, 4)
    with torch.cuda.device(dev):
        rc = fn(attrs.data_ptr(), gauss_id.data_ptr(), tile_start.data_ptr(),
                tile_count.data_ptr(), T, tiles_x, tile, slot_s.data_ptr(),
                g_aug.data_ptr(), rows.data_ptr(), _stream(dev))
    BWD_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"blend_bwd kernel launch failed: cudaError {rc}")


def launch_fold_rows(rows_exp: torch.Tensor, g_start: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the fold kernel once on the current stream: out[g] = Σ of
    rows_exp over [g_start[g], g_start[g+1]), in slot order (bitwise
    blend_plain.fold_rows)."""
    global FOLD_LAUNCHES
    dev = rows_exp.device
    if dev.type != "cuda":
        raise ValueError(f"the fold kernel needs CUDA tensors, got {dev}")
    N = out.shape[0]
    _check("rows_exp", rows_exp, torch.float32, (rows_exp.shape[0], ATTR), dev)
    _check("g_start", g_start, torch.int32, (N + 1,), dev)
    _check("out", out, torch.float32, (N, ATTR), dev)
    fn = _fn("blend_bwd", "hidegs_fold_rows", 2, 1, 2)
    with torch.cuda.device(dev):
        rc = fn(rows_exp.data_ptr(), g_start.data_ptr(), N, out.data_ptr(), _stream(dev))
    FOLD_LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"fold_rows kernel launch failed: cudaError {rc}")


def visited_count(binning: TileBinning, max_blocks: int) -> torch.Tensor:
    """(T,) int32 span lengths with tiles past the block budget set to 0,
    the kernels' `tile_count`."""
    return blend_plain.visited_and_count(binning, max_blocks)[1].contiguous()


def blend_tile_out(
    attrs: torch.Tensor,
    binning: TileBinning,
    count: torch.Tensor,
    tiles_y: int,
    tiles_x: int,
    tile: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on packed rows: (T, P, 16) tile planes and (N,)
    int32 per-gaussian observe counts. `count` is `visited_count`."""
    dev = attrs.device
    N = attrs.shape[0]
    I = binning.gauss_id.shape[0]
    out = torch.empty((tiles_y * tiles_x, tile * tile, OUT_CH), dtype=torch.float32, device=dev)
    obs = torch.zeros((I,), dtype=torch.int32, device=dev)
    launch_blend_fwd(attrs, binning.gauss_id.contiguous(), binning.tile_start.contiguous(),
                     count, tiles_x, tile, out, obs)
    # instances of invalid slots carry gauss_id N and a zero count: row N
    # drops. Integer adds commute, so this index_add_ is deterministic.
    observe = torch.zeros((N + 1,), dtype=torch.int32, device=dev)
    observe.index_add_(0, binning.gauss_id.long(), obs)
    return out, observe[:N]


def instance_rows(
    attrs: torch.Tensor,
    binning: TileBinning,
    count: torch.Tensor,
    g_aug: torch.Tensor,
    tiles_x: int,
    tile: int,
) -> torch.Tensor:
    """The backward kernel: (I, 16) gradient rows in expansion order, the
    plain `expansion_rows(blend_tiles_bwd(...), slot_s)`'s layout."""
    rows = torch.zeros((binning.gauss_id.shape[0], ATTR), dtype=torch.float32, device=attrs.device)
    launch_blend_bwd(attrs, binning.gauss_id.contiguous(), binning.tile_start.contiguous(),
                     count, tiles_x, tile, binning.slot_s.contiguous(), g_aug, rows)
    return rows


def fold(rows_exp: torch.Tensor, binning: TileBinning, num_gaussians: int) -> torch.Tensor:
    """Expansion-order rows → (N, 16) per-gaussian sums with the fold kernel."""
    out = torch.empty((num_gaussians, ATTR), dtype=torch.float32, device=rows_exp.device)
    launch_fold_rows(rows_exp, binning.g_start.contiguous(), out)
    return out


def grad_attrs(
    attrs: torch.Tensor,
    binning: TileBinning,
    count: torch.Tensor,
    g_aug: torch.Tensor,
    tiles_x: int,
    tile: int,
) -> torch.Tensor:
    """Gradient of the blend with respect to the packed rows, (N, 16): the
    backward kernel, then the fold kernel. Bitwise reproducible."""
    rows_exp = instance_rows(attrs, binning, count, g_aug, tiles_x, tile)
    return fold(rows_exp, binning, attrs.shape[0])

"""Visibility-masked sparse Adam.

Port of hidegs_tpu/model/adam.py: a dense masked update (the reference's
OurAdam gathers the visible rows, updates and scatters back). Moments and
parameters of rows outside the mask stay exactly as they were, including
the bias-correction step count, which is therefore kept per row.

`masked_adam_update` checks its arguments, then runs `masked_adam_plain`
(the update in PyTorch ops, the CPU path and the kernel's reference) on
CPU tensors, and on CUDA tensors one launch of csrc/masked_adam.cu, which
is bitwise the plain body on the card (its source says how); nothing
falls back. The source builds with the package's other kernels
(kernel_sources.py). The update returns new tensors and
leaves its inputs untouched, unless the caller owns them and asks for it
`in_place` (a step that donates its state).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Tuple

import torch

from hidegs_tpu_torch import kernel_sources
from hidegs_tpu_torch.model.gaussians import GaussianParams
from hidegs_tpu_torch.raster import cuda_blend

# Launches of the kernel in this process, one per call of launch_masked_adam.
LAUNCHES = 0

CHUNK = 4  # floats a thread loads at once


class AdamState(NamedTuple):
    m: GaussianParams  # first moments, same leaves as the params
    v: GaussianParams  # second moments
    step: torch.Tensor  # (C,) int32 per-row step count


def init_adam(params: GaussianParams) -> AdamState:
    C = params.xyz.shape[0]
    return AdamState(
        m=GaussianParams(*(torch.zeros_like(p) for p in params)),
        v=GaussianParams(*(torch.zeros_like(p) for p in params)),
        step=torch.zeros((C,), dtype=torch.int32, device=params.xyz.device),
    )


def _bcast(vec: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a (C,) vector over the trailing dims of `like`."""
    return vec.reshape(vec.shape + (1,) * (like.ndim - 1))


def bias_corrections(step: torch.Tensor, visible: torch.Tensor, b1: float, b2: float):
    """The new (C,) step counts and the per-row bias corrections
    c1 = 1 - b1^t and c2 = 1 - b2^t at t = max(step, 1)."""
    step = step + visible.to(torch.int32)
    t = torch.clamp(step, min=1).to(torch.float32)
    return step, 1.0 - b1 ** t, 1.0 - b2 ** t


def masked_adam_plain(
    params: GaussianParams,
    grads: GaussianParams,
    opt: AdamState,
    lr: GaussianParams,
    visible: torch.Tensor,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-15,
):
    """The update in PyTorch ops: `masked_adam_update`'s CPU path and the
    kernel's reference. Returns (new_params, new_opt)."""
    step, c1, c2 = bias_corrections(opt.step, visible, b1, b2)

    new_p, new_m, new_v = {}, {}, {}
    for name in GaussianParams._fields:
        p, g = getattr(params, name), getattr(grads, name)
        m, v = getattr(opt.m, name), getattr(opt.v, name)
        msk = _bcast(visible, p)
        m_new = torch.where(msk, b1 * m + (1.0 - b1) * g, m)
        v_new = torch.where(msk, b2 * v + (1.0 - b2) * (g * g), v)
        m_hat = m_new / _bcast(c1, p)
        v_hat = v_new / _bcast(c2, p)
        upd = getattr(lr, name) * m_hat / (torch.sqrt(v_hat) + eps)
        new_p[name] = torch.where(msk, p - upd, p)
        new_m[name] = m_new
        new_v[name] = v_new
    return GaussianParams(**new_p), AdamState(m=GaussianParams(**new_m), v=GaussianParams(**new_v), step=step)


def _grad_row_stride(name: str, g: torch.Tensor, p: torch.Tensor) -> int:
    """The row stride of gradient `g`, which may be a column slice of a
    wider matrix but must be float32, shaped as its param `p`, on its
    device, with each row's floats contiguous."""
    if g.device != p.device or g.dtype != torch.float32 or g.shape != p.shape:
        raise ValueError(f"gradient {name} is {g.dtype} {tuple(g.shape)} on {g.device}, "
                         f"expected torch.float32 {tuple(p.shape)} on {p.device}")
    expect = 1
    for size, stride in reversed(list(zip(g.shape[1:], g.stride()[1:]))):
        if size != 1 and stride != expect:
            raise ValueError(f"gradient {name} must have contiguous rows, has strides {g.stride()}")
        expect *= size
    return g.stride(0)


def _check_args(params: GaussianParams, grads: GaussianParams, opt: AdamState, visible: torch.Tensor) -> None:
    """What the kernel takes, checked on every device: float32 contiguous
    params and moments of C rows each, gradients shaped as their params
    with contiguous rows, a (C,) bool mask and (C,) int32 steps, all on the
    params' device."""
    dev = params.xyz.device
    C = params.xyz.shape[0] if params.xyz.ndim else -1
    for name in GaussianParams._fields:
        p = getattr(params, name)
        if p.ndim == 0 or p.shape[0] != C:
            raise ValueError(f"param {name} has shape {tuple(p.shape)}, expected {C} rows")
        for what, x in (("param", p), ("first moment", getattr(opt.m, name)), ("second moment", getattr(opt.v, name))):
            cuda_blend._check(f"{what} {name}", x, torch.float32, p.shape, dev)
        _grad_row_stride(name, getattr(grads, name), p)
    cuda_blend._check("visible", visible, torch.bool, (C,), dev)
    cuda_blend._check("step", opt.step, torch.int32, (C,), dev)


def masked_adam_update(
    params: GaussianParams,
    grads: GaussianParams,
    opt: AdamState,
    lr: GaussianParams,
    visible: torch.Tensor,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-15,
    in_place: bool = False,
):
    """One sparse-Adam step over the `visible` mask. `lr` holds one scalar
    learning rate per leaf (a float or a 0-d tensor). Returns (new_params,
    new_opt); eps is OurAdam's 1e-15. With `in_place` the new params,
    moments and steps are written into `params` and `opt`, which are
    returned (on a card rows outside the mask are then neither read nor
    written). Raises ValueError on arguments the kernel does not take, on
    any device."""
    _check_args(params, grads, opt, visible)
    if params.xyz.device.type == "cpu":
        new_params, new_opt = masked_adam_plain(params, grads, opt, lr, visible, b1, b2, eps)
        if not in_place:
            return new_params, new_opt
        for dst, src in zip((*params, *opt.m, *opt.v, opt.step), (*new_params, *new_opt.m, *new_opt.v, new_opt.step)):
            dst.copy_(src)
        return params, opt
    step, c1, c2 = bias_corrections(opt.step, visible, b1, b2)
    if in_place:
        opt.step.copy_(step)
        out = (params, opt.m, opt.v)
    else:
        out = tuple(GaussianParams(*(torch.empty_like(x) for x in leaves)) for leaves in (params, opt.m, opt.v))
    launch_masked_adam(params, grads, opt.m, opt.v, lr, visible, c1, c2, *out, b1, b2, eps)
    return out[0], AdamState(m=out[1], v=out[2], step=opt.step if in_place else step)


def leaf_table(widths: List[int], rows: int) -> List[Tuple[int, int, int]]:
    """The kernel's map of the leaves laid end to end: per leaf (width,
    floats, running end of its CHUNK-float chunks). Chunk c belongs to the
    first leaf whose end exceeds it and covers that leaf's floats from
    CHUNK * (c - the previous leaf's end), CHUNK of them or up to its last;
    float e of a leaf lies in its row e // width."""
    table, end = [], 0
    for w in widths:
        n = rows * w
        end += -(-n // CHUNK)
        table.append((w, n, end))
    if CHUNK * end >= 1 << 31:
        raise ValueError(f"{rows} rows of widths {widths} are too many floats for the kernel's int32 indices")
    return table


def _lr_arg(lr, dev: torch.device):
    """(device pointer or 0, float) of one leaf's learning rate: a 0-d
    float32 tensor on the device is read by the kernel, never by the host."""
    if isinstance(lr, torch.Tensor):
        if lr.numel() != 1:
            raise ValueError(f"a learning rate has {lr.numel()} elements, expected 1")
        if lr.device == dev:
            if lr.dtype != torch.float32:
                raise ValueError(f"a learning rate on {dev} has dtype {lr.dtype}, expected torch.float32")
            return lr.data_ptr(), 0.0
        if lr.device.type != "cpu":
            raise ValueError(f"a learning rate is on {lr.device}, expected {dev} or the CPU")
    return 0, float(lr)


@functools.cache
def _fn():
    return cuda_blend.bind(cuda_blend.build(kernel_sources.SOURCES)["masked_adam"], "hidegs_masked_adam",
                           6, 1, 5, 1)


def launch_masked_adam(params, grads, m, v, lr, visible, c1, c2, out_p, out_m, out_v, b1, b2, eps) -> None:
    """Launch the kernel once on the current stream: writes the new params
    and moments into `out_p`, `out_m` and `out_v` (GaussianParams shaped as
    `params`; they may be `params`, `m` and `v` themselves). `c1` and `c2`
    are `bias_corrections`' (C,) rows; the rest as `masked_adam_update`'s
    arguments, checked there."""
    global LAUNCHES
    dev = params.xyz.device
    if dev.type != "cuda":
        raise ValueError(f"the masked Adam kernel needs CUDA tensors, got {dev}")
    C = params.xyz.shape[0]
    names = GaussianParams._fields
    cuda_blend._check("c1", c1, torch.float32, (C,), dev)
    cuda_blend._check("c2", c2, torch.float32, (C,), dev)
    for what, leaves in (("output param", out_p), ("output first moment", out_m), ("output second moment", out_v)):
        for name in names:
            cuda_blend._check(f"{what} {name}", getattr(leaves, name), torch.float32, getattr(params, name).shape, dev)
    lrs = [_lr_arg(getattr(lr, name), dev) for name in names]
    table = leaf_table([math.prod(getattr(params, name).shape[1:]) for name in names], C)
    g_strides = [_grad_row_stride(name, getattr(grads, name), getattr(params, name)) for name in names]
    if C and max(s * (C - 1) + w for s, (w, _, _) in zip(g_strides, table)) >= 1 << 31:
        raise ValueError("a gradient's rows lie too far apart for the kernel's int32 indices")
    ptrs = (ctypes.c_uint64 * (8 * len(names)))(*(
        x for name, (lr_ptr, _) in zip(names, lrs)
        for x in (*(getattr(t, name).data_ptr() for t in (params, grads, m, v, out_p, out_m, out_v)), lr_ptr)))
    ints = (ctypes.c_int * (4 * len(names)))(*(x for row, s in zip(table, g_strides) for x in (*row, s)))
    floats = (ctypes.c_float * len(names))(*(f for _, f in lrs))
    fn = _fn()
    with torch.cuda.device(dev):
        rc = fn(ctypes.addressof(ptrs), ctypes.addressof(ints), ctypes.addressof(floats), visible.data_ptr(),
                c1.data_ptr(), c2.data_ptr(), len(names), b1, 1.0 - b1, b2, 1.0 - b2, eps, cuda_blend._stream(dev))
    LAUNCHES += 1
    if rc != 0:
        raise RuntimeError(f"masked_adam kernel launch failed: cudaError {rc}")


def reset_opacity_moments(opt: AdamState) -> AdamState:
    """Zero the opacity leaf's moments, as the reference's reset_opacity
    replaces that optimizer tensor with zeroed state."""
    return opt._replace(
        m=opt.m._replace(opacity=torch.zeros_like(opt.m.opacity)),
        v=opt.v._replace(opacity=torch.zeros_like(opt.v.opacity)),
    )


def reset_moments_at(opt: AdamState, mask: torch.Tensor) -> AdamState:
    """Zero the Adam state of the rows in `mask` (the padded-buffer form of
    the reference's optimizer surgery on densify and prune)."""

    def zero(leaf):
        return torch.where(_bcast(mask, leaf), torch.zeros_like(leaf), leaf)

    return AdamState(
        m=GaussianParams(*(zero(x) for x in opt.m)),
        v=GaussianParams(*(zero(x) for x in opt.v)),
        step=torch.where(mask, torch.zeros_like(opt.step), opt.step),
    )

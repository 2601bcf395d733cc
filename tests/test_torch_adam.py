"""The masked sparse Adam's wrapper on the CPU: the plain path, the checks
that run before it dispatches by device, and the leaf table the kernel
(hidegs_tpu_torch/model/csrc/masked_adam.cu) walks. The kernel itself is
held bitwise against the plain body in tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from hidegs_tpu_torch.model import adam
from hidegs_tpu_torch.model.gaussians import GaussianParams

SHAPES = dict(xyz=(3,), sh_dc=(3,), sh_rest=(15, 3), scaling=(3,), rotation=(4,), opacity=())


def _leaves(gen, C):
    return GaussianParams(*(torch.randn((C, *SHAPES[f]), generator=gen) for f in GaussianParams._fields))


def _problem(C=37, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = _leaves(gen, C)
    opt = adam.AdamState(m=_leaves(gen, C), v=GaussianParams(*(x.abs() for x in _leaves(gen, C))),
                         step=torch.randint(0, 1 << 20, (C,), generator=gen, dtype=torch.int32))
    opt.step[:3] = torch.tensor([0, 1, 0], dtype=torch.int32)
    grads = _leaves(gen, C)
    visible = torch.rand(C, generator=gen) > 0.5
    visible[:2] = True
    lr = GaussianParams(xyz=torch.tensor(1.6e-4), sh_dc=2.5e-3, sh_rest=2.5e-3 / 20, scaling=5e-3, rotation=1e-3,
                        opacity=5e-2)
    return params, grads, opt, lr, visible


def _tensors(params, opt):
    return [*params, *opt.m, *opt.v, opt.step]


@pytest.mark.parametrize("in_place", [False, True])
def test_cpu_update_is_the_plain_body_and_launches_nothing(in_place):
    """On CPU tensors the wrapper is masked_adam_plain bitwise, out of place
    (its inputs untouched) or in place (the given tensors, written), and
    the kernel's launch counter does not move."""
    params, grads, opt, lr, visible = _problem()
    before = [x.clone() for x in _tensors(params, opt)]
    want_p, want_opt = adam.masked_adam_plain(params, grads, opt, lr, visible)
    launches = adam.LAUNCHES
    got_p, got_opt = adam.masked_adam_update(params, grads, opt, lr, visible, in_place=in_place)
    assert adam.LAUNCHES == launches
    for got, want in zip(_tensors(got_p, got_opt), _tensors(want_p, want_opt), strict=True):
        assert torch.equal(got, want)
    given = _tensors(params, opt)
    if in_place:
        assert all(a is b for a, b in zip(_tensors(got_p, got_opt), given))
    else:
        assert all(torch.equal(a, b) for a, b in zip(given, before))
    off = ~visible
    for new, old in zip(_tensors(got_p, got_opt), before):
        assert torch.equal(new[off], old[off]), "a row outside the mask changed"


def _strided(x, extra):
    """`x` as a column slice of a wider matrix: rows `extra` floats apart."""
    C = x.shape[0]
    wide = torch.zeros((C, x[0].numel() + extra))
    wide[:, :x[0].numel()] = x.reshape(C, -1)
    return wide[:, :x[0].numel()].reshape(x.shape)


def test_gradients_may_be_column_slices():
    """Gradients sliced out of a packed matrix (rows farther apart than
    their width, as the post-opt step's and the SH split's are) are taken
    and give the contiguous gradients' update."""
    params, grads, opt, lr, visible = _problem()
    sliced = GaussianParams(*(_strided(g, 5) for g in grads))
    assert not sliced.sh_rest.is_contiguous()
    want = adam.masked_adam_update(params, grads, opt, lr, visible)
    got = adam.masked_adam_update(params, sliced, opt, lr, visible)
    for a, b in zip(_tensors(*got), _tensors(*want), strict=True):
        assert torch.equal(a, b)


def _noncontiguous(x):
    wide = torch.zeros((*x.shape[:-1], 2 * x.shape[-1])) if x.ndim > 1 else torch.zeros(2 * x.shape[0])
    out = wide[..., ::2]
    out.copy_(x)
    return out


BAD = {
    "float64 param": lambda p, g, o, v: (p._replace(xyz=p.xyz.double()), g, o, v),
    "float64 gradient": lambda p, g, o, v: (p, g._replace(opacity=g.opacity.double()), o, v),
    "non-contiguous param": lambda p, g, o, v: (p._replace(rotation=_noncontiguous(p.rotation)), g, o, v),
    "non-contiguous moment": lambda p, g, o, v: (p, g, o._replace(v=o.v._replace(xyz=_noncontiguous(o.v.xyz))), v),
    "gradient rows not contiguous": lambda p, g, o, v: (p, g._replace(sh_rest=g.sh_rest.transpose(1, 2)
                                                                     .contiguous().transpose(1, 2)), o, v),
    "gradient shaped unlike its param": lambda p, g, o, v: (p, g._replace(sh_rest=g.sh_rest.reshape(-1, 45)), o, v),
    "moment shaped unlike its param": lambda p, g, o, v: (p, g, o._replace(m=o.m._replace(scaling=o.m.scaling[:-1])),
                                                          v),
    "leaves of other row counts": lambda p, g, o, v: (p._replace(opacity=p.opacity[:-1]), g, o, v),
    "a float mask": lambda p, g, o, v: (p, g, o, v.float()),
    "int64 steps": lambda p, g, o, v: (p, g, o._replace(step=o.step.long()), v),
}


@pytest.mark.parametrize("bad", sorted(BAD))
@pytest.mark.parametrize("in_place", [False, True])
def test_update_raises_on_what_the_kernel_cannot_take(bad, in_place):
    """The checks run before the dispatch by device, so on the CPU too the
    wrapper raises where the kernel could not take its inputs (no path
    falls back)."""
    params, grads, opt, lr, visible = _problem()
    p, g, o, v = BAD[bad](params, grads, opt, visible)
    with pytest.raises(ValueError):
        adam.masked_adam_update(p, g, o, lr, v, in_place=in_place)


def test_the_launcher_refuses_cpu_tensors():
    params, grads, opt, lr, visible = _problem()
    _, c1, c2 = adam.bias_corrections(opt.step, visible, 0.9, 0.999)
    with pytest.raises(ValueError, match="CUDA"):
        adam.launch_masked_adam(params, grads, opt.m, opt.v, lr, visible, c1, c2, params, opt.m, opt.v, 0.9, 0.999,
                                1e-15)


def _walk(table):
    """The kernel's walk of `table` in numpy: for every chunk, its leaf and
    the (leaf, float, row) of each float it covers, rows counted as the
    kernel counts them (one division a chunk, then a carry)."""
    ends = np.array([end for _, _, end in table])
    out = []
    for c in range(int(ends[-1])):
        leaf = int(np.searchsorted(ends, c, side="right"))
        w, n, _ = table[leaf]
        e0 = adam.CHUNK * (c - (int(ends[leaf - 1]) if leaf else 0))
        r, j = divmod(e0, w)
        for e in range(e0, min(e0 + adam.CHUNK, n)):
            out.append((leaf, e, r))
            j += 1
            if j == w:
                j, r = 0, r + 1
    return out


@pytest.mark.parametrize("rows", [1, 7, 333, 1001])
@pytest.mark.parametrize("widths", [(3, 3, 45, 3, 4, 1), (1, 45, 4, 3), (45,), (1, 1, 1)])
def test_leaf_table_covers_every_float_once(rows, widths):
    """Every float of every leaf is covered by exactly one chunk of the
    table, and the row the kernel counts for it is its row."""
    table = adam.leaf_table(list(widths), rows)
    assert [(w, n) for w, n, _ in table] == [(w, rows * w) for w in widths]
    walked = _walk(table)
    assert len(walked) == sum(rows * w for w in widths)
    assert len({(leaf, e) for leaf, e, _ in walked}) == len(walked)
    assert all(r == e // widths[leaf] for leaf, e, r in walked)


def test_leaf_table_refuses_what_int32_cannot_index():
    with pytest.raises(ValueError, match="int32"):
        adam.leaf_table([45, 14], 1 << 26)

"""The UAV scene of the benchmark, generated from a seed on the device.

Frozen rewrites, in plain torch, of four generators of the program's data
layer at commit 63641d3, so that a later change to the program cannot
change the workload:

  * `make_uav_gaussians`: hidegs_tpu_torch/data/synthetic.py:104-166 (the
    served model: a ground sheet of thin disks and box structures of
    splats). Its draws come from a `torch.Generator` on the device in a few
    large calls, not from numpy's stream, and its SH bands above the DC
    term carry small seeded values, as a trained model's do;
  * `procedural_texture`: synthetic.py:414-444;
  * `terrain_height` and its value noise: synthetic.py:585-620;
  * `synthetic_monodepth`: synthetic.py:727-766, as a smooth relative
    error field and holes on the device (the PNG quantisation and the
    per-image affine, which the loader undoes, are left out).

Every seed gives the same sizes: only the values move.
"""
from __future__ import annotations

import math

import torch

SH_C0 = 0.28209479177387814
NUM_SH_COEFFS = 16


def generator(seed: int, device) -> torch.Generator:
    """A generator on `device` seeded from any whole number (the driver's
    seeds pass 32 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def _normal(g, shape, std, device):
    return std * torch.randn(shape, generator=g, device=device)


def make_uav_gaussians(seed: int, device, n_ground: int = 1_000_000, n_structs: int = 64,
                       per_struct: int = 160, extent_xy: float = 12.0, sh_rest_std: float = 0.03,
                       layout_seed: int = 0):
    """(means3d, scales, quats, opacities, shs): n_ground + per_struct ·
    n_structs gaussians, linear scales, wxyz quaternions, opacities in
    (0, 1), shs (N, 16, 3). make_uav_gaussians' shapes and ranges. The
    structures' places, sizes and colours come from `layout_seed`, the
    same scene for every run; the splats from `seed`."""
    dev = torch.device(device)
    g = generator(seed, dev)
    lg = generator(layout_seed, dev)
    E = extent_xy
    gx = _uniform(g, (n_ground,), -E, E, dev)
    gy = _uniform(g, (n_ground,), -E, E, dev)
    gz = _normal(g, (n_ground,), 0.02, dev)
    cell = 2 * E / math.sqrt(n_ground)
    g_scales = torch.stack([_uniform(g, (n_ground,), 0.8, 1.6, dev) * cell,
                            _uniform(g, (n_ground,), 0.8, 1.6, dev) * cell,
                            torch.full((n_ground,), 0.1 * cell, device=dev)], -1)
    checker = torch.remainder(torch.floor(gx / 1.5) + torch.floor(gy / 1.5), 2.0) * 0.25
    waves = 0.15 * torch.sin(3.1 * gx) * torch.cos(2.7 * gy) + 0.1 * torch.sin(11.0 * gy)
    base = torch.stack([0.35 + checker, 0.45 + waves, 0.3 + 0.2 * checker], -1)
    g_rgb = torch.clamp(base + _normal(g, (n_ground, 3), 0.08, dev), 0.02, 0.98)
    g_opac = _uniform(g, (n_ground,), 0.7, 0.98, dev)

    S, m = n_structs, per_struct
    centre = _uniform(lg, (S, 1, 2), -0.8 * E, 0.8 * E, dev)
    whd = _uniform(lg, (S, 1, 3), 0.6, 1.8, dev) * torch.tensor([1.0, 1.0, 1.6], device=dev)
    col = _uniform(lg, (S, 1, 3), 0.2, 0.9, dev)
    face = torch.randint(0, 5, (S, m), generator=g, device=dev)
    u = _uniform(g, (S, m), -1.0, 1.0, dev)
    v = _uniform(g, (S, m), -1.0, 1.0, dev)
    w, d, h = whd[..., 0], whd[..., 1], whd[..., 2]
    px = torch.where(face == 0, -w, torch.where(face == 1, w, u * w))
    py = torch.where(face == 2, -d, torch.where(face == 3, d, v * d))
    pz = torch.where(face < 4, _uniform(g, (S, m), 0.0, 1.0, dev) * h, h)
    s_means = torch.stack([centre[..., 0] + px, centre[..., 1] + py, pz], -1).reshape(-1, 3)
    s_scales = (0.12 * _uniform(g, (S, m, 1), 0.7, 1.5, dev)).expand(S, m, 3).reshape(-1, 3)
    s_rgb = torch.clamp(col + _normal(g, (S, m, 3), 0.06, dev), 0.05, 0.95).reshape(-1, 3)
    s_opac = _uniform(g, (S * m,), 0.75, 0.98, dev)

    means = torch.cat([torch.stack([gx, gy, gz], -1), s_means])
    scales = torch.cat([g_scales, s_scales])
    n = means.shape[0]
    quats = torch.zeros((n, 4), device=dev)
    quats[:, 0] = 1.0
    opac = torch.cat([g_opac, s_opac])
    shs = _normal(g, (n, NUM_SH_COEFFS, 3), sh_rest_std, dev)
    shs[:, 0] = (torch.cat([g_rgb, s_rgb]) - 0.5) / SH_C0
    return means.contiguous(), scales.contiguous(), quats, opac.contiguous(), shs.contiguous()


# -- the textured terrain of the training scene --------------------------------

def _hash01(ix, iy, seed: int):
    h = torch.remainder(ix.to(torch.int64) * 374761393 + iy.to(torch.int64) * 668265263 + seed * 97002337,
                        2147483647)
    h = torch.remainder(torch.bitwise_xor(h, h >> 13) * 1274126177, 2147483647)
    return torch.remainder(h, 65536).to(torch.float32) / 65536.0


def _value_noise(u, v, cell: float, seed: int, smooth: bool = True):
    gu, gv = u / cell, v / cell
    iu, iv = torch.floor(gu), torch.floor(gv)
    fu, fv = gu - iu, gv - iv
    if smooth:
        fu = fu * fu * (3 - 2 * fu)
        fv = fv * fv * (3 - 2 * fv)
    return (_hash01(iu, iv, seed) * (1 - fu) * (1 - fv) + _hash01(iu + 1, iv, seed) * fu * (1 - fv)
            + _hash01(iu, iv + 1, seed) * (1 - fu) * fv + _hash01(iu + 1, iv + 1, seed) * fu * fv)


def terrain_height(u, v, hmax: float, seed: int):
    """A smooth multi-octave height field h(u, v) >= 0 (+z up)."""
    h = (0.50 * _value_noise(u, v, 9.0, seed) + 0.30 * _value_noise(u, v, 3.7, seed + 1)
         + 0.14 * _value_noise(u, v, 1.6, seed + 2) + 0.06 * _value_noise(u, v, 0.7, seed + 3))
    h = h + 0.18 * (1 + torch.sin(0.21 * u + 0.8) * torch.cos(0.17 * v - 0.4)) / 2
    return hmax * h


def procedural_texture(u, v):
    """Checker, two sine octaves and value noise at ground coordinates:
    (..., 3) albedo in [0.02, 0.98]."""
    checker = torch.remainder(torch.floor(u / 0.9) + torch.floor(v / 0.9), 2.0) * 0.30
    fine = torch.remainder(torch.floor(u / 0.22) + torch.floor(v / 0.22), 2.0) * 0.12
    waves = 0.14 * torch.sin(5.3 * u) * torch.cos(4.1 * v) + 0.10 * torch.sin(17.0 * v + 2.0 * u)
    n = _value_noise(u, v, 0.35, 0, smooth=False)
    r = 0.38 + checker + 0.18 * (n - 0.5)
    gch = 0.45 + waves + fine
    b = 0.33 + 0.22 * checker - 0.10 * waves + 0.12 * (n - 0.5)
    return torch.clamp(torch.stack([r, gch, b], -1), 0.02, 0.98)


class Terrain:
    """The training scene's world: a height field over [-E, E]^2 with box
    structures standing on it, drawn from `layout_seed` (one scene for
    every run; the samples of it come from the run's seed)."""

    GRID = 2048  # the height field is tabulated on GRID x GRID points over [-E - MARGIN, E + MARGIN]^2
    MARGIN = 6.0

    def __init__(self, layout_seed: int, device, extent_xy: float = 12.0, hmax: float = 2.4, n_boxes: int = 64):
        dev = torch.device(device)
        g = generator(layout_seed ^ 0x5EED, dev)
        self.device, self.E, self.hmax = dev, extent_xy, hmax
        self.noise_seed = int(layout_seed) % 100_003
        self.L = extent_xy + self.MARGIN
        ax = torch.linspace(-self.L, self.L, self.GRID, device=dev)
        gu, gv = torch.meshgrid(ax, ax, indexing="ij")
        self.table = terrain_height(gu, gv, hmax, self.noise_seed).contiguous()
        c = _uniform(g, (n_boxes, 2), -0.8 * extent_xy, 0.8 * extent_xy, dev)
        half = _uniform(g, (n_boxes, 3), 0.3, 0.9, dev) * torch.tensor([1.0, 1.0, 1.6], device=dev)
        base = self.height(c[:, 0], c[:, 1]) - 0.2
        self.lo = torch.stack([c[:, 0] - half[:, 0], c[:, 1] - half[:, 1], base], -1)
        self.hi = torch.stack([c[:, 0] + half[:, 0], c[:, 1] + half[:, 1], base + 0.2 + 2 * half[:, 2]], -1)
        self.colour = _uniform(g, (n_boxes, 3), 0.2, 0.9, dev)
        self.sun = torch.tensor([0.45, 0.35, 0.80], device=dev)
        self.sun = self.sun / torch.linalg.vector_norm(self.sun)

    def height(self, u, v):
        """The height field, bilinear in its table (the analytic field at
        a 1.8 cm spacing); clamped at the table's border."""
        G = self.GRID
        fu = torch.clamp((u + self.L) * ((G - 1) / (2 * self.L)), 0.0, G - 1.0)
        fv = torch.clamp((v + self.L) * ((G - 1) / (2 * self.L)), 0.0, G - 1.0)
        iu = torch.clamp(torch.floor(fu), max=G - 2)
        iv = torch.clamp(torch.floor(fv), max=G - 2)
        au, av = fu - iu, fv - iv
        k = (iu * G + iv).to(torch.int64)
        t = self.table.view(-1)
        h0 = t[k] * (1 - av) + t[k + 1] * av
        h1 = t[k + G] * (1 - av) + t[k + G + 1] * av
        return h0 * (1 - au) + h1 * au

    def sample_points(self, g: torch.Generator, n_ground: int, per_box: int):
        """(points (n, 3), colours (n, 3)): ground samples coloured by the
        albedo, and box-face samples coloured by the box."""
        dev, E = self.device, self.E
        u = _uniform(g, (n_ground,), -E, E, dev)
        v = _uniform(g, (n_ground,), -E, E, dev)
        z = self.height(u, v) + _normal(g, (n_ground,), 0.01, dev)
        ground = torch.stack([u, v, z], -1)
        B = self.lo.shape[0]
        face = torch.randint(0, 5, (B, per_box), generator=g, device=dev)
        t = torch.rand((B, per_box, 3), generator=g, device=dev)
        p = self.lo[:, None] + t * (self.hi - self.lo)[:, None]
        lo, hi = self.lo[:, None].expand_as(p), self.hi[:, None].expand_as(p)
        p = torch.stack([torch.where(face == 0, lo[..., 0], torch.where(face == 1, hi[..., 0], p[..., 0])),
                         torch.where(face == 2, lo[..., 1], torch.where(face == 3, hi[..., 1], p[..., 1])),
                         torch.where(face == 4, hi[..., 2], p[..., 2])], -1)
        pts = torch.cat([ground, p.reshape(-1, 3)])
        cols = torch.cat([procedural_texture(u, v), self.colour[:, None].expand(B, per_box, 3).reshape(-1, 3)])
        return pts.contiguous(), cols.contiguous()

    def _boxes_hit(self, o, d):
        """Nearest box hit along rays o + t d: (t (R,), box index (R,),
        face normal (R, 3)); t = inf where no box is hit."""
        inv = 1.0 / torch.where(d.abs() < 1e-9, torch.full_like(d, 1e-9), d)
        t1 = (self.lo[None] - o[:, None]) * inv[:, None]  # (R, B, 3)
        t2 = (self.hi[None] - o[:, None]) * inv[:, None]
        tmin, tmax = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tn, axis = tmin.max(dim=-1)
        tf = tmax.min(dim=-1).values
        tn = torch.where((tn <= tf) & (tn > 1e-4), tn, torch.full_like(tn, math.inf))
        t, b = tn.min(dim=-1)
        ax = axis.gather(1, b[:, None])[:, 0]
        normal = torch.nn.functional.one_hot(ax, 3).to(d.dtype) * -torch.sign(d.gather(1, ax[:, None]))
        return t, b, normal

    def cast(self, o, d, n_steps: int = 48, n_bisect: int = 10, chunk: int = 1 << 18):
        """Rays o + t d (o (R, 3), d (R, 3) unit): (colour (R, 3), hit
        distance (R,), inf where the ray leaves the scene). The terrain by
        marching to the first crossing and bisecting it, the boxes by
        slabs; Lambert and a Blinn-Phong highlight, as render_terrain_scene
        shades (synthetic.py:630-724). Outside [-E, E]^2 the colour is 0."""
        dz = d[:, 2]
        desc = dz < -1e-4
        safe = torch.where(desc, dz, torch.full_like(dz, -1.0))
        t_lo = torch.clamp((o[:, 2] - self.hmax) / -safe, min=0.3)
        t_hi = o[:, 2] / -safe + 1.0
        found = torch.zeros_like(desc)
        a = torch.zeros_like(dz)
        b = torch.zeros_like(dz)
        prev_above = torch.ones_like(desc)
        prev_t = t_lo
        for s in range(n_steps):
            tt = t_lo + (t_hi - t_lo) * (s / (n_steps - 1))
            p = o + tt[:, None] * d
            above = p[:, 2] > self.height(p[:, 0], p[:, 1])
            crossed = prev_above & ~above & desc & ~found
            a = torch.where(crossed, prev_t, a)
            b = torch.where(crossed, tt, b)
            found |= crossed
            prev_above, prev_t = above, tt
        for _ in range(n_bisect):
            mid = 0.5 * (a + b)
            q = o + mid[:, None] * d
            mab = q[:, 2] > self.height(q[:, 0], q[:, 1])
            a, b = torch.where(mab, mid, a), torch.where(mab, b, mid)
        hit_t = torch.where(found, 0.5 * (a + b), torch.full_like(dz, math.inf))
        parts = [self._boxes_hit(o[k:k + chunk], d[k:k + chunk]) for k in range(0, d.shape[0], chunk)]
        tb, bidx, bnormal = (torch.cat(x) for x in zip(*parts))
        on_box = tb < hit_t
        t = torch.where(on_box, tb, hit_t)
        p = o + torch.where(torch.isfinite(t), t, torch.zeros_like(t))[:, None] * d
        inside = (p[:, 0].abs() <= self.E) & (p[:, 1].abs() <= self.E) & torch.isfinite(t)
        eps = 0.05
        hx = (self.height(p[:, 0] + eps, p[:, 1]) - self.height(p[:, 0] - eps, p[:, 1])) / (2 * eps)
        hy = (self.height(p[:, 0], p[:, 1] + eps) - self.height(p[:, 0], p[:, 1] - eps)) / (2 * eps)
        n_t = torch.stack([-hx, -hy, torch.ones_like(hx)], -1)
        n_t = n_t / torch.linalg.vector_norm(n_t, dim=-1, keepdim=True)
        albedo = procedural_texture(p[:, 0], p[:, 1])
        slope = torch.clamp(1.0 - n_t[:, 2], 0.0, 1.0)[:, None]
        albedo = albedo * (1.0 - 0.5 * slope) + 0.5 * slope * torch.tensor([0.45, 0.40, 0.36], device=d.device)
        n = torch.where(on_box[:, None], bnormal, n_t)
        albedo = torch.where(on_box[:, None], self.colour[bidx], albedo)
        lam = torch.clamp(n @ self.sun, 0.0, 1.0)
        half = -d + self.sun
        half = half / (torch.linalg.vector_norm(half, dim=-1, keepdim=True) + 1e-9)
        spec = (n @ self.sun > 0).to(d.dtype) * torch.clamp((n * half).sum(-1), 0.0, 1.0) ** 32
        colour = albedo * (0.30 + 0.70 * lam)[:, None] + 0.18 * spec[:, None]
        colour = torch.where(inside[:, None], torch.clamp(colour, 0.0, 1.0), torch.zeros_like(colour))
        return colour, torch.where(inside, t, torch.full_like(t, math.inf))


def view_rays(R, t, fx, fy, cx, cy, height: int, width: int, device):
    """Camera centre (3,), unit world rays (H*W, 3) through the pixel
    centres of a world-to-camera pose (R, t), and each ray's length per
    unit of camera depth (H*W,)."""
    dev = torch.device(device)
    R = torch.as_tensor(R, dtype=torch.float32, device=dev)
    t = torch.as_tensor(t, dtype=torch.float32, device=dev)
    xs = (torch.arange(width, device=dev, dtype=torch.float32) + 0.5 - cx) / fx
    ys = (torch.arange(height, device=dev, dtype=torch.float32) + 0.5 - cy) / fy
    dy, dx = torch.meshgrid(ys, xs, indexing="ij")
    d_cam = torch.stack([dx, dy, torch.ones_like(dx)], -1).reshape(-1, 3)
    d = d_cam @ R
    norm = torch.linalg.vector_norm(d_cam, dim=-1)
    return -R.T @ t, d / torch.linalg.vector_norm(d, dim=-1, keepdim=True), norm


def synthetic_inverse_depth(depth_z, g: torch.Generator, height: int, width: int, rel_err: float = 0.04,
                            hole_frac: float = 0.01):
    """Inverse depth as a monodepth net gives it after its scale is fitted:
    the true 1/z times (1 + a smooth error field within ±rel_err), 0 where
    there is no surface and in square holes covering ~hole_frac."""
    dev = depth_z.device
    inv = torch.where(torch.isfinite(depth_z), 1.0 / torch.clamp(depth_z, min=1e-6), torch.zeros_like(depth_z))
    inv = inv.reshape(height, width)
    yy, xx = torch.meshgrid(torch.arange(height, device=dev, dtype=torch.float32),
                            torch.arange(width, device=dev, dtype=torch.float32), indexing="ij")
    field_seed = int(torch.randint(0, 1 << 20, (1,), generator=g, device=dev).item())
    err = (2.0 * _value_noise(xx / width * 6.0, yy / height * 6.0, 1.0, field_seed) - 1.0) * rel_err
    out = inv * (1.0 + err)
    n_holes = max(int(hole_frac * height * width / 64), 1)
    cy = torch.randint(0, height, (n_holes,), generator=g, device=dev)
    cx = torch.randint(0, width, (n_holes,), generator=g, device=dev)
    r = torch.randint(3, 9, (n_holes,), generator=g, device=dev)
    # a hole blanks |y - cy| < r and |x - cx| < r; painted by rows of holes
    hole = torch.zeros((height, width), dtype=torch.bool, device=dev)
    for k in range(0, n_holes, 64):
        sl = slice(k, k + 64)
        in_y = (yy[None, :, :1] - cy[sl, None, None]).abs() < r[sl, None, None]  # (h, H, 1)
        in_x = (xx[None, :1, :] - cx[sl, None, None]).abs() < r[sl, None, None]  # (h, 1, W)
        hole |= (in_y & in_x).any(0)
    return torch.where(hole, torch.zeros_like(out), out)

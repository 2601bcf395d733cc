"""Camera paths of the benchmark's traffic: a UAV lawnmower flight, an
oblique viewer orbit and a fly-through. Plain numpy poses (world-to-camera
R, t; +z up in the scene, camera axes right, down, forward), so the same
path serves the program and the reference."""
from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np


class Pose(NamedTuple):
    R: np.ndarray  # (3, 3) world to camera
    t: np.ndarray  # (3,)
    fx: float
    fy: float
    cx: float
    cy: float
    height: int
    width: int

    @property
    def centre(self) -> np.ndarray:
        return -self.R.T @ self.t


def look(pos, fwd, width: int, height: int, focal: float) -> Pose:
    """A pose at `pos` looking along `fwd`, its image rows pointing down
    the world's -z as far as the view allows."""
    fwd = np.asarray(fwd, np.float64)
    fwd = fwd / np.linalg.norm(fwd)
    up_hint = np.array([0.0, 0.0, 1.0]) if abs(fwd[2]) < 0.99 else np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up_hint)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    R = np.stack([right, down, fwd])
    return Pose(R, -R @ np.asarray(pos, np.float64), focal, focal, width / 2.0, height / 2.0, height, width)


def pitched(yaw: float, pitch_below_horizon_deg: float) -> np.ndarray:
    p = math.radians(pitch_below_horizon_deg)
    return np.array([math.cos(yaw) * math.cos(p), math.sin(yaw) * math.cos(p), -math.sin(p)])


def lawnmower(cols: int, rows: int, extent_xy: float, margin: float, altitude: float, oblique_deg: float,
              width: int, height: int, focal: float) -> List[Pose]:
    """A lawnmower grid of cols x rows views, flown row by row with the
    direction reversed on every other row; nadir and oblique views in turn,
    the oblique tilted `oblique_deg` from nadir along the flight."""
    poses = []
    ys = np.linspace(-margin, margin, rows) * extent_xy
    xs = np.linspace(-margin, margin, cols) * extent_xy
    k = 0
    for j, y in enumerate(ys):
        heading = 1.0 if j % 2 == 0 else -1.0
        for x in (xs if heading > 0 else xs[::-1]):
            if k % 2 == 0:
                fwd = np.array([0.02 * heading, 0.01, -1.0])
            else:
                a = math.radians(oblique_deg)
                fwd = np.array([heading * math.sin(a), 0.0, -math.cos(a)])
            poses.append(look((x, y, altitude), fwd, width, height, focal))
            k += 1
    return poses


def orbit(n: int, radius: float, altitude: float, pitch_lo: float, pitch_hi: float, width: int, height: int,
          focal: float) -> List[Pose]:
    """n distinct poses on a circle around the scene's centre, each looking
    inward, pitched between pitch_lo and pitch_hi degrees below the horizon
    (one swing up and down per turn)."""
    poses = []
    for k in range(n):
        a = 2 * math.pi * k / n
        pitch = pitch_lo + (pitch_hi - pitch_lo) * 0.5 * (1 - math.cos(a))
        pos = (radius * math.cos(a), radius * math.sin(a), altitude)
        poses.append(look(pos, pitched(a + math.pi, pitch), width, height, focal))
    return poses


def fly_through(n: int, period: int, extent_xy: float, margin: float, altitude: float, pitch_lo: float,
                pitch_hi: float, width: int, height: int, focal: float) -> List[Pose]:
    """n poses of a flight that crosses the scene's diagonal once every
    `period` frames, back and forth, looking ahead and down, with a slow
    sideways sway of the heading."""
    poses = []
    a = margin * extent_xy
    for k in range(n):
        phase = (k % (2 * period)) / period  # 0..2
        s = phase if phase <= 1 else 2 - phase
        direction = 1.0 if phase <= 1 else -1.0
        pos = (-a + 2 * a * s, -a + 2 * a * s, altitude)
        yaw = math.atan2(direction, direction) + 0.3 * math.sin(2 * math.pi * k / 480)
        pitch = pitch_lo + (pitch_hi - pitch_lo) * 0.5 * (1 - math.cos(2 * math.pi * k / 720))
        poses.append(look(pos, pitched(yaw, pitch), width, height, focal))
    return poses

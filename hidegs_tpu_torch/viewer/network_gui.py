"""SIBR-compatible network GUI: JSON-over-TCP remote render protocol.

Port of hidegs_tpu/viewer/network_gui.py, wire-compatible with the
reference (gaussian_renderer/network_gui.py:26-85), so the SIBR remote
viewer works against the port:

  request:  [u32 len][json] with resolution_x/y, train, fov_x/y, z_near/far,
            shs_python, rot_scale_python, keep_alive, scaling_modifier,
            view_matrix (16 floats, col-flipped y/z), view_projection_matrix
  response: [raw RGB bytes (H*W*3, uint8)][u32 len]["verify" string]

The view matrix convention is the reference's MiniCam: the incoming 4x4 is
row-major torch layout with the y/z columns negated; it becomes a
CameraParams (R = world→cam rotation rows, t translation) on the GUI's
device.
"""
from __future__ import annotations

import json
import socket
import traceback
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from hidegs_tpu_torch.core.camera_math import CameraParams, fov_to_focal, make_camera
from hidegs_tpu_torch.device import DeviceLike, resolve_device


def image_bytes(img) -> np.ndarray:
    """A (3, H, W) float image in [0, 1] (tensor or array) → (H, W, 3)
    uint8: clipped, scaled by 255 and truncated, as the JAX viewers do."""
    if isinstance(img, torch.Tensor):
        img = img.detach().to("cpu", torch.float32).numpy()
    arr = (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)
    return np.ascontiguousarray(arr.transpose(1, 2, 0))


def camera_from_message(msg: dict, device: DeviceLike = "cuda") -> Optional[CameraParams]:
    """A request's pose and intrinsics as a camera on `device` (None for a
    zero resolution)."""
    width = msg["resolution_x"]
    height = msg["resolution_y"]
    if width == 0 or height == 0:
        return None
    view = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
    # undo the reference's column flips (network_gui.py:74-76): torch
    # row-major M with M[:,1]*=-1, M[:,2]*=-1; rows 0..2 of M.T are R
    view[:, 1] *= -1
    view[:, 2] *= -1
    Rt = view.T  # (4,4): world→cam in math convention
    fx = fov_to_focal(msg["fov_x"], width)
    fy = fov_to_focal(msg["fov_y"], height)
    return make_camera(Rt[:3, :3], Rt[:3, 3], fx=fx, fy=fy, height=height, width=width, device=device)


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009, device: DeviceLike = "cuda"):
        self.device = resolve_device(device)
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None

    def close(self):
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None
        self.listener.close()

    def try_connect(self):
        if self.conn is not None:
            return
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
        except (BlockingIOError, socket.timeout):
            pass

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("client closed")
            buf += chunk
        return buf

    def read_message(self) -> Optional[dict]:
        n = int.from_bytes(self._read_exact(4), "little")
        return json.loads(self._read_exact(n).decode("utf-8"))

    def send(self, image_bytes: Optional[bytes], verify: str = ""):
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def receive_camera(self) -> Tuple[Optional[CameraParams], dict]:
        """One protocol round: parse the request into a CameraParams."""
        msg = self.read_message()
        return camera_from_message(msg, self.device), msg

    def poll(self, render_fn: Callable[[CameraParams, dict], object], verify: str):
        """Non-blocking service round; call from the training loop.

        render_fn(cam, msg) → (3, H, W) float image in [0, 1]. Returns the
        parsed message (for the train/keep_alive flags) or None."""
        self.try_connect()
        if self.conn is None:
            return None
        try:
            cam, msg = self.receive_camera()
            img_bytes = None
            if cam is not None:
                img_bytes = image_bytes(render_fn(cam, msg)).tobytes()
            self.send(img_bytes, verify)
            return msg
        except (ConnectionError, OSError):
            traceback.print_exc()
            try:
                self.conn.close()
            finally:
                self.conn = None
            return None

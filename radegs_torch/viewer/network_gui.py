"""SIBR remote-viewer bridge speaking the reference's network_gui protocol
(gaussian_renderer/network_gui.py:26-85; port of
``radegs_tpu/viewer/network_gui.py``), so SIBR's ``remoteGaussianUI`` app
works unmodified against the port's renderer.

Wire format: the client sends <u32 LE length><json>; the JSON carries the
resolution, fovs, near/far, train / keep-alive flags, the scaling modifier
and the (transposed, y/z-flipped) view and view-projection matrices. The
server replies with raw H*W*3 uint8 RGB followed by <u32 LE length><verify
string>.
"""

from __future__ import annotations

import json
import socket
import traceback

import numpy as np
import torch

from radegs_torch.core.camera import Camera
from radegs_torch.utils.device import resolve_device


class NetworkGUI:
    """A non-blocking listener on ``host:port`` (port 0: any free port) and
    at most one viewer connection. Cameras it receives are built on
    ``device`` (default ``cuda``; raises without a card unless ``"cpu"``)."""

    def __init__(self, host="127.0.0.1", port=6009, device=None):
        self.device = resolve_device(device)
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn = None

    def try_connect(self):
        if self.conn is not None:
            return
        try:
            self.conn, addr = self.listener.accept()
            print(f"\nViewer connected by {addr}")
            self.conn.settimeout(None)
        except (BlockingIOError, socket.timeout):
            pass

    def _recv_exact(self, n):
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def _read_json(self):
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def receive(self):
        """-> (Camera | None, do_training, keep_alive, scaling_modifier).

        A None camera is the empty-resolution handshake
        (network_gui.py:84-85)."""
        msg = self._read_json()
        width, height = msg["resolution_x"], msg["resolution_y"]
        if width == 0 or height == 0:
            return None, None, None, None
        wv = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
        wv[:, 1] *= -1
        wv[:, 2] *= -1
        w2c = wv.T  # the incoming matrix is the column-major world_view
        cam = Camera.create(w2c[:3, :3].T, w2c[:3, 3], msg["fov_x"], msg["fov_y"], width,
                            height, znear=msg["z_near"], zfar=msg["z_far"], device=self.device)
        return cam, bool(msg["train"]), bool(msg["keep_alive"]), msg["scaling_modifier"]

    def send_image(self, image_chw, verify: str):
        """image: (3, H, W) values in [0, 1] (a tensor or an array) or None;
        verify: the source-path string. Quantised on the host as
        ``(clip(x, 0, 1) * 255).astype(uint8)``, the reference's cast."""
        if image_chw is not None:
            arr = image_chw.detach().cpu().numpy() if torch.is_tensor(image_chw) else \
                np.asarray(image_chw)
            arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
            self.conn.sendall(memoryview(np.ascontiguousarray(arr)).cast("B"))
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def drop(self):
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass
            self.conn = None

    def close(self):
        """Drop the viewer and stop listening."""
        self.drop()
        self.listener.close()

    def poll(self, render_fn, source_path: str, training_done: bool):
        """One training-loop poll (train.py:92-105): serve frames while a
        viewer is connected. ``render_fn(camera, scaling_modifier)`` gives
        the (3, H, W) frame. As the reference does, a poll during training
        serves one frame and returns; after the last iteration it serves
        until the viewer sends ``keep_alive`` false; while the viewer has
        training paused (``train`` false) it keeps serving. Returns
        do_training. A failure drops the viewer (and is printed); training
        goes on."""
        self.try_connect()
        do_training = True
        while self.conn is not None:
            try:
                cam, train_flag, keep_alive, scale_mod = self.receive()
                img = render_fn(cam, scale_mod) if cam is not None else None
                self.send_image(img, source_path)
                if train_flag is not None:
                    do_training = train_flag
                if do_training and (not training_done or not keep_alive):
                    break
            except ConnectionError:  # the viewer closed its end
                self.drop()
            except Exception:  # the viewer is optional: report and train on
                traceback.print_exc()
                self.drop()
        return do_training

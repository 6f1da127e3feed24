"""Camera paths and flythrough rendering.

Counterpart of ``correrender_tpu/app/camera_path.py``: orbit and
keyframed (Catmull-Rom) camera paths, rendered through a Scene to
numbered PNGs, optionally stepping the time per frame (BASELINE config
4's time-lag animation), and an MJPEG AVI writer.

``render_flythrough`` keeps at most ``MAX_IN_FLIGHT`` frames dispatched
and not yet fetched: before dispatching past that bound it fetches and
encodes the oldest, so the card renders frame n + 1 while the host
encodes frame n, and device memory stays bounded however long the path
is. PNGs are written by a stdlib encoder (``zlib`` and ``struct``).
"""

from __future__ import annotations

import collections
import math
import os
import struct
import zlib

import numpy as np

from correrender_tpu_torch.render.camera import Camera, orbit_camera

#: Frames dispatched and not yet fetched that ``render_flythrough`` keeps:
#: two let the card render one frame while the host encodes the other.
MAX_IN_FLIGHT = 2


def orbit_path(num_frames: int, radius: float = 0.85, phi: float = 0.3,
               center=(0.0, 0.0, 0.0)):
    """A full-circle orbit."""
    return [orbit_camera(2.0 * math.pi * i / num_frames, phi, radius, center)
            for i in range(num_frames)]


def keyframe_path(keyframes, num_frames: int):
    """Catmull-Rom interpolation through keyframe cameras' positions and
    look-at points."""
    positions = np.asarray([k.position for k in keyframes], np.float64)
    looks = np.asarray([k.look_at_point for k in keyframes], np.float64)

    def catmull_rom(pts, t_global):
        n = len(pts)
        if n == 1:
            return pts[0]
        seg = min(int(t_global * (n - 1)), n - 2)
        t = t_global * (n - 1) - seg
        p0 = pts[max(seg - 1, 0)]
        p1 = pts[seg]
        p2 = pts[seg + 1]
        p3 = pts[min(seg + 2, n - 1)]
        return 0.5 * (
            2 * p1
            + (-p0 + p2) * t
            + (2 * p0 - 5 * p1 + 4 * p2 - p3) * t * t
            + (-p0 + 3 * p1 - 3 * p2 + p3) * t**3
        )

    cams = []
    for i in range(num_frames):
        t = i / max(num_frames - 1, 1)
        cams.append(Camera(position=tuple(catmull_rom(positions, t)),
                           look_at_point=tuple(catmull_rom(looks, t)),
                           fovy=keyframes[0].fovy))
    return cams


def frame_to_uint8(img) -> np.ndarray:
    """An ``(H, W, C)`` float frame in [0, 1] (tensor or array) as uint8
    pixels, clipped, scaled by 255 and truncated (as PIL is given them)."""
    if hasattr(img, "detach"):
        img = img.detach().cpu().numpy()
    return (np.clip(np.asarray(img), 0, 1) * 255).astype(np.uint8)


def encode_png(pixels: np.ndarray, level: int = 1) -> bytes:
    """An 8-bit PNG of ``(H, W, 3)`` or ``(H, W, 4)`` uint8 pixels (RGB or
    RGBA): one IDAT of unfiltered rows."""
    pixels = np.ascontiguousarray(pixels, np.uint8)
    h, w, c = pixels.shape
    color_type = {3: 2, 4: 6}[c]
    rows = np.zeros((h, 1 + w * c), np.uint8)  # filter byte 0 a row
    rows[:, 1:] = pixels.reshape(h, w * c)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + chunk(b"IEND", b""))


def write_png(path: str, img) -> None:
    """Write a float frame as a PNG (level-1 deflate: full-colour
    renders barely shrink at higher levels, which cost the host more)."""
    with open(path, "wb") as f:
        f.write(encode_png(frame_to_uint8(img)))


def render_flythrough(scene, cameras, output_dir: str, image_size=(800, 600),
                      time_indices=None, view: int = 0,
                      prefix: str = "frame", video_path: str | None = None,
                      fps: int = 30):
    """Render a camera path through ``scene`` to numbered PNGs (stepping
    ``scene.current_time`` through ``time_indices`` when given) and
    return the file list; with ``video_path`` also an MJPEG AVI
    (:func:`write_mjpeg_avi`).

    At most :data:`MAX_IN_FLIGHT` rendered frames wait to be fetched: the
    oldest is fetched and encoded before the next is dispatched past the
    bound.
    """
    os.makedirs(output_dir, exist_ok=True)
    pending = collections.deque()
    files = []

    def finish_oldest():
        i, img = pending.popleft()
        path = os.path.join(output_dir, f"{prefix}_{i:04d}.png")
        write_png(path, img)
        files.append(path)

    for i, cam in enumerate(cameras):
        if len(pending) == MAX_IN_FLIGHT:
            finish_oldest()
        scene.views[view] = cam
        if time_indices is not None:
            scene.current_time = int(time_indices[i % len(time_indices)])
        pending.append((i, scene.render_view(view, image_size=image_size)))
    while pending:
        finish_oldest()
    if video_path:
        write_mjpeg_avi(files, video_path, fps=fps)
    return files


def write_mjpeg_avi(frames, path: str, fps: int = 30,
                    quality: int = 90) -> str:
    """Encode frames into an MJPEG AVI (flythrough video export): the
    RIFF/AVI container written directly around PIL-encoded JPEG frames.

    Args:
      frames: (H, W, 3/4) float [0, 1] or uint8 arrays, or image paths.
      fps: playback rate.
      quality: JPEG quality (1-100).

    Returns:
      ``path``. PIL is imported here, at first use.
    """
    import io as _io

    from PIL import Image

    encoded = []
    size = None
    for fr in frames:
        if isinstance(fr, (str, bytes)):
            img = Image.open(fr).convert("RGB")
        else:
            arr = np.asarray(fr)
            if arr.dtype != np.uint8:
                arr = frame_to_uint8(arr)
            img = Image.fromarray(arr[..., :3])
        if size is None:
            size = img.size
        elif img.size != size:
            img = img.resize(size)
        buf = _io.BytesIO()
        img.save(buf, "JPEG", quality=quality)
        data = buf.getvalue()
        if len(data) % 2:
            data += b"\0"
        encoded.append(data)
    if not encoded:
        raise ValueError("no frames to encode")
    w, h = size
    n = len(encoded)
    max_size = max(len(d) for d in encoded)

    def chunk(fourcc, payload):
        out = fourcc + struct.pack("<I", len(payload)) + payload
        return out + (b"\0" if len(payload) % 2 else b"")

    def lst(fourcc, payload):
        return chunk(b"LIST", fourcc + payload)

    avih = struct.pack("<IIIIIIIIIIIIII", 1_000_000 // fps, max_size * fps,
                       0, 0x10, n, 0, 1, max_size, w, h, 0, 0, 0, 0)
    strh = (b"vids" + b"MJPG"
            + struct.pack("<IHHIIIIIIII", 0, 0, 0, 0, 1, fps, 0, n,
                          max_size, 0, 0)
            + struct.pack("<hhhh", 0, 0, w, h))
    strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3,
                       0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih) + lst(
        b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))
    movi = lst(b"movi", b"".join(chunk(b"00dc", d) for d in encoded))
    idx = b""
    off = 4
    for d in encoded:
        idx += b"00dc" + struct.pack("<III", 0x10, off, len(d))
        off += 8 + len(d) + (len(d) % 2)
    riff_payload = b"AVI " + hdrl + movi + chunk(b"idx1", idx)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload)
    return path

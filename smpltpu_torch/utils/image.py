"""Image read/write with graceful degradation: cv2 -> PIL -> pure-Python
PNG (zlib). A copy of ``smpltpu/utils/image.py`` (pinned against it and
against cv2 by ``tests/test_torch_cli.py``), with the decoder's Sub filter
vectorized: a machine without cv2 and PIL reads every frame through this
codec, and the per-byte loop took ~0.4 s for a 480x270 frame. The reference hard-depends on OpenCV (cv::imread/imwrite,
src/main_single_frame.cpp:168,195,277); this framework degrades to a
dependency-free PNG codec so the pipeline runs in minimal environments.

Convention: images are (H, W, 3) uint8 in BGR channel order (OpenCV's),
matching the reference's cv::Mat handling so overlay colors are
byte-identical where cv2 is present.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

try:
    import cv2  # type: ignore
except ImportError:  # pragma: no cover
    cv2 = None

try:
    from PIL import Image  # type: ignore
except ImportError:  # pragma: no cover
    Image = None


def _png_write(path: str, rgb: np.ndarray) -> None:
    """Minimal RGB8 PNG encoder (filter 0, one zlib stream)."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", header))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def _png_read(path: str) -> np.ndarray:
    """Minimal PNG decoder for 8-bit RGB/RGBA/gray, filters 0-4."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    idat = b""
    w = h = bit_depth = color_type = None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if tag == b"IHDR":
            w, h, bit_depth, color_type = struct.unpack(">IIBB", body[:10])
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + length
    assert bit_depth == 8, f"unsupported bit depth {bit_depth}"
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * channels
    img = np.zeros((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    pos = 0
    for y in range(h):
        ftype = raw[pos]
        line = np.frombuffer(raw[pos + 1:pos + 1 + stride], dtype=np.uint8).copy()
        pos += 1 + stride
        if ftype == 1:      # Sub: a running sum per channel, modulo 256
            line = (np.cumsum(line.reshape(-1, channels), axis=0,
                              dtype=np.uint64) & 0xFF).astype(
                                  np.uint8).reshape(-1)
        elif ftype == 2:    # Up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif ftype == 3:    # Average
            for i in range(stride):
                left = line[i - channels] if i >= channels else 0
                line[i] = (line[i] + ((int(left) + int(prev[i])) >> 1)) & 0xFF
        elif ftype == 4:    # Paeth
            for i in range(stride):
                a = int(line[i - channels]) if i >= channels else 0
                b = int(prev[i])
                c = int(prev[i - channels]) if i >= channels else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
                line[i] = (line[i] + pred) & 0xFF
        img[y] = line
        prev = line
    img = img.reshape(h, w, channels)
    if channels == 1:
        img = np.repeat(img, 3, axis=-1)
    elif channels == 2:
        img = np.repeat(img[..., :1], 3, axis=-1)
    elif channels == 4:
        img = img[..., :3]
    return img


def imread(path: str) -> np.ndarray:
    """Read an image as (H, W, 3) uint8 BGR. Returns None on failure
    (cv::imread parity: empty Mat on failure)."""
    if cv2 is not None:
        img = cv2.imread(path)
        return img
    try:
        if Image is not None:
            rgb = np.asarray(Image.open(path).convert("RGB"))
        else:
            rgb = _png_read(path)
        return rgb[..., ::-1].copy()  # RGB -> BGR
    except Exception:
        return None


def imwrite(path: str, img_bgr: np.ndarray) -> bool:
    if cv2 is not None:
        return bool(cv2.imwrite(path, img_bgr))
    rgb = np.ascontiguousarray(img_bgr[..., ::-1])
    if Image is not None:
        Image.fromarray(rgb).save(path)
        return True
    if not path.lower().endswith(".png"):
        path = path + ".png"
    _png_write(path, rgb)
    return True

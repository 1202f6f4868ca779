"""Image files without PIL: an 8-bit PNG codec (stdlib ``zlib`` + numpy)
and a Lanczos-3 resize that reproduces PIL's ``Image.resize(...,
Image.LANCZOS)`` on uint8 images.

The card's machine has no PIL, and the JAX package reads and resizes every
dataset image with it (``radegs_tpu/data/readers.py:42-56``). PNG always
goes through this codec, on the CPU and on the card alike; other formats
(JPEG) are read with PIL where it imports, else ``read_image`` raises an
error naming the file and its format.

PNG decoding: the Sub, Average and Paeth filters depend on the
reconstructed left neighbour and Up, Average and Paeth on the row above, so
a filtered image is reconstructed along anti-diagonals (every row advances
one pixel per step: W + H - 1 numpy steps over (H, channels) arrays instead
of W x H Python steps); an image with filter 0 on every row is its bytes.
"""

from __future__ import annotations

import math
import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (8-bit, non-interlaced): L, RGB, LA, RGBA
PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
CHANNELS_TO_TYPE = {1: 0, 3: 2, 2: 4, 4: 6}


class ImageFormatError(ValueError):
    """An image file this module cannot decode (names the file and format)."""


# ------------------------------------------------------------------ PNG ----


def _chunks(data: bytes, path):
    if data[:8] != PNG_SIGNATURE:
        raise ImageFormatError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def _unfilter_wavefront(ftype, f):
    """Reconstruct scanlines with any of the five filters along
    anti-diagonals: step d computes pixel x = d - y of every row y, whose
    left, up and upper-left neighbours lie on diagonals d - 1 and d - 2.
    ``f``: (H, W, C) filtered bytes as int16."""
    H, W, C = f.shape
    D = W + H - 1
    ys = np.arange(H)
    xs = np.arange(D)[:, None] - ys[None, :]  # (D, H) pixel column per step
    valid = (xs >= 0) & (xs < W)
    fs = np.where(valid[..., None], f[ys[None, :], np.clip(xs, 0, W - 1)], 0).astype(np.int16)
    # q[d + 2, y + 1] = reconstructed (y, d - y); zero rows for d < 0, y < 0
    q = np.zeros((D + 2, H + 1, C), np.int16)
    kind = [(ftype == k)[:, None] for k in range(5)]
    vmask = valid[..., None]
    for d in range(D):
        a = q[d + 1, 1:]  # left: (y, x - 1)
        b = q[d + 1, :-1]  # up: (y - 1, x)
        c = q[d, :-1]  # upper left: (y - 1, x - 1)
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(kind[1], a, np.where(kind[2], b, np.where(
            kind[3], (a + b) >> 1, np.where(kind[4], paeth, 0))))
        q[d + 2, 1:] = np.where(vmask[d], (fs[d] + pred) & 255, 0)
    yy, xx = np.meshgrid(ys, np.arange(W), indexing="ij")
    return q[xx + yy + 2, yy + 1].astype(np.uint8)


def read_png(path) -> np.ndarray:
    """An 8-bit, non-interlaced grey (L), grey + alpha (LA), RGB or RGBA PNG
    as uint8 (H, W) or (H, W, C), all five scanline filters. Raises
    ``ImageFormatError`` (naming the file) for any other PNG."""
    with open(path, "rb") as fh:
        data = fh.read()
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ImageFormatError(f"{path}: PNG without IHDR")
    W, H, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in PNG_CHANNELS or interlace != 0:
        raise ImageFormatError(
            f"{path}: PNG with bit depth {depth}, colour type {ctype}, interlace "
            f"{interlace} is not supported (8-bit L / LA / RGB / RGBA, non-interlaced)")
    C = PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != H * (1 + W * C):
        raise ImageFormatError(f"{path}: truncated PNG data")
    raw = raw.reshape(H, 1 + W * C)
    ftype = raw[:, 0]
    if ftype.max(initial=0) > 4:
        raise ImageFormatError(f"{path}: PNG scanline filter {int(ftype.max())}")
    f = raw[:, 1:].reshape(H, W, C)
    # filter 0 throughout (as write_png writes): the bytes are the pixels
    out = f.copy() if (ftype == 0).all() else _unfilter_wavefront(ftype, f.astype(np.int16))
    return out[..., 0] if C == 1 else out


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path, img):
    """Write uint8 (H, W) or (H, W, C) with C in {1, 2, 3, 4} as an 8-bit
    PNG, filter 0 on every scanline."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    if C not in CHANNELS_TO_TYPE:
        raise ValueError(f"write_png takes 1-4 channels, got {C}")
    raw = np.zeros((H, 1 + W * C), np.uint8)
    raw[:, 1:] = np.ascontiguousarray(img).reshape(H, W * C)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, CHANNELS_TO_TYPE[C], 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                 + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                 + _chunk(b"IEND", b""))


def _pil(path, magic):
    """PIL's Image module for a non-PNG file, or the error naming the file."""
    try:
        from PIL import Image
    except ImportError:
        ext = os.path.splitext(str(path))[1].lstrip(".").upper() or "unknown"
        kind = "JPEG" if magic[:3] == b"\xff\xd8\xff" else ext
        raise ImageFormatError(
            f"{path}: cannot decode {kind} images without PIL; only PNG has a built-in "
            "decoder (convert the dataset's images to PNG)") from None
    return Image


def image_size(path):
    """(width, height) of an image file: read from a PNG's header, else
    through PIL as ``read_image`` would."""
    with open(path, "rb") as fh:
        head = fh.read(24)
    if head[:8] == PNG_SIGNATURE and head[12:16] == b"IHDR":
        return struct.unpack(">II", head[16:24])
    with _pil(path, head[:8]).open(path) as im:
        return im.size


def read_image(path) -> np.ndarray:
    """uint8 (H, W) or (H, W, C): PNG through ``read_png``; any other format
    through PIL where it imports (converted to L, RGB or RGBA), else an
    ``ImageFormatError`` naming the file and its format."""
    with open(path, "rb") as fh:
        magic = fh.read(8)
    if magic == PNG_SIGNATURE:
        return read_png(path)
    with _pil(path, magic).open(path) as im:
        if im.mode not in ("L", "RGB", "RGBA"):
            im = im.convert("RGBA" if "A" in im.mode else "RGB")
        return np.asarray(im).copy()


# -------------------------------------------------------------- resize ----

PRECISION_BITS = 32 - 8 - 2  # PIL's fixed-point coefficients (Resample.c)


def _sinc(x):
    if x == 0.0:
        return 1.0
    x *= math.pi
    return math.sin(x) / x


def _lanczos(x):
    return _sinc(x) * _sinc(x / 3.0) if -3.0 <= x < 3.0 else 0.0


def _coefficients(in_size: int, out_size: int):
    """PIL's precompute_coeffs + normalize_coeffs_8bpc for LANCZOS (support 3)
    over the whole input: per output sample, the first input index and the
    integer weights (out_size, ksize)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 3.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for w in k:
            ww += w
        for x, w in enumerate(k):
            w = w / ww if ww != 0.0 else w
            weights[xx, x] = int(-0.5 + w * (1 << PRECISION_BITS)) if w < 0 else \
                int(0.5 + w * (1 << PRECISION_BITS))
        first[xx] = xmin
    return first, weights


def _resample_axis(img, out_size: int, axis: int):
    """One pass of PIL's 8-bit resampling along ``axis`` (0 rows, 1 columns)
    of a (H, W, C) uint8 image: fixed-point sums rounded and clipped to uint8."""
    in_size = img.shape[axis]
    first, weights = _coefficients(in_size, out_size)
    acc = np.full((img.shape[0], out_size, img.shape[2]) if axis == 1 else
                  (out_size, img.shape[1], img.shape[2]), 1 << (PRECISION_BITS - 1), np.int32)
    weights = weights.astype(np.int32)  # PIL sums in 32-bit ints too
    for j in range(weights.shape[1]):
        idx = np.minimum(first + j, in_size - 1)  # weight 0 past the window
        w = weights[:, j]
        if axis == 1:
            acc += img[:, idx, :] * w[None, :, None]
        else:
            acc += img[idx, :, :] * w[:, None, None]
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def _muldiv255(a, b):
    t = a.astype(np.int64) * b + 128
    return ((t >> 8) + t) >> 8


def resize_lanczos(img, size) -> np.ndarray:
    """PIL's ``Image.resize(size, Image.LANCZOS)`` on a uint8 (H, W) or
    (H, W, C) image; ``size`` = (width, height). The same size returns the
    image unchanged; otherwise a horizontal pass, then a vertical one, each
    rounded to uint8. With alpha (LA, RGBA) the colour is premultiplied
    before and divided back after, as PIL's RGBa / La round trip does."""
    img = np.asarray(img, np.uint8)
    W, H = int(size[0]), int(size[1])
    if img.shape[1] == W and img.shape[0] == H:
        return img.copy()
    x = img[..., None] if img.ndim == 2 else img
    alpha = x.shape[2] in (2, 4)
    if alpha:  # RGBA -> RGBa (Convert.c rgbA2rgba)
        a = x[..., -1:].astype(np.int64)
        x = np.concatenate([_muldiv255(x[..., :-1], a), a], axis=-1).astype(np.uint8)
    if x.shape[1] != W:
        x = _resample_axis(x, W, 1)
    if x.shape[0] != H:
        x = _resample_axis(x, H, 0)
    if alpha:  # RGBa -> RGBA (Convert.c rgba2rgbA)
        a = x[..., -1:].astype(np.int64)
        col = x[..., :-1].astype(np.int64)
        div = np.clip(255 * col // np.maximum(a, 1), 0, 255)
        x = np.concatenate([np.where((a == 0) | (a == 255), col, div), a],
                           axis=-1).astype(np.uint8)
    return x[..., 0] if img.ndim == 2 else x

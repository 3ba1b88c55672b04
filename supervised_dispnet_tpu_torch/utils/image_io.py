"""A PNG codec in ``zlib`` and numpy: the port reads KITTI's frames and
writes its depth images without ``imageio``, ``cv2`` or PIL, none of which
it depends on.

``read_png`` decodes 8-bit grey, grey+alpha, RGB and RGBA images, not
interlaced, with any of the five row filters; anything else (palette,
1/2/4/16-bit samples, Adam7 interlacing) raises ``ValueError`` naming the
file. ``write_png`` writes 8-bit images of 1 to 4 channels with one filter
type on every row.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for 8-bit samples
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunks(data: bytes, path):
    """(type, payload) of each chunk, CRC checked."""
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        if pos + 12 + length > len(data):
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + payload) != crc:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG ends without an IEND chunk")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor of left (a), upper (b) and upper-left (c) bytes."""
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(filtered: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of (H, W, bpp) bytes, one filter type a row.

    Each byte depends on its left (a), upper (b) and upper-left (c)
    neighbours' reconstructed values, so pixel (r, x) can be reconstructed
    once its anti-diagonal r + x is reached. The rows are skewed (row r
    shifted right by r) so that each anti-diagonal is one column, and the
    wavefront takes H + W - 1 vector steps over columns of every row at
    once, whatever filter each row uses: a and b lie in the previous column,
    c two columns back."""
    H, W, _ = filtered.shape
    rows = np.arange(H)[:, None]
    # skewed column r + x, plus one column of zero padding on the left;
    # cells left of a row's first pixel stay zero (x = -1 reads zeros).
    # Column-major, so that each step's slices are contiguous.
    cols = rows + np.arange(W)[None, :] + 1
    f = np.zeros((H + W, H, bpp), np.int32)
    f[cols, rows] = filtered
    # one row of zero padding on top: the row above the first is zeros
    d = np.zeros((H + W, H + 1, bpp), np.int32)
    ft = filters[:, None].astype(np.int32)
    for t in range(1, H + W):
        n = min(t, H)  # rows r < t hold x = t - 1 - r >= 0
        a = d[t - 1, 1:n + 1]
        b = d[t - 1, :n]
        c = d[t - 2, :n]
        k = ft[:n]
        pred = np.where(k == 1, a, np.where(k == 2, b, np.where(
            k == 3, (a + b) >> 1, np.where(k == 4, _paeth(a, b, c), 0))))
        d[t, 1:n + 1] = (f[t, :n] + pred) & 0xFF
    return d[cols, rows + 1].astype(np.uint8)


def read_png(path: str | Path) -> np.ndarray:
    """Decode an 8-bit PNG file: (H, W) for grey, (H, W, C) for grey+alpha
    (C=2), RGB (3) and RGBA (4), uint8."""
    return decode_png(Path(path).read_bytes(), path)


def is_png(data: bytes) -> bool:
    """Whether ``data`` starts with the PNG signature."""
    return data.startswith(_SIGNATURE)


def decode_png(data: bytes, path: str | Path = "<bytes>") -> np.ndarray:
    """``read_png`` of the bytes of a PNG file; ``path`` names it in errors."""
    if not is_png(data):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, payload in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    W, H, depth, color, compression, filter_method, interlace = header
    if color == 3:
        raise ValueError(f"{path}: palette PNGs are not supported")
    if depth != 8:
        raise ValueError(f"{path}: {depth}-bit PNGs are not supported (8-bit only)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if color not in _CHANNELS or compression or filter_method:
        raise ValueError(f"{path}: unsupported PNG header {header}")
    C = _CHANNELS[color]
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG data ({e})") from None
    if raw.size != H * (W * C + 1):
        raise ValueError(f"{path}: PNG data holds {raw.size} bytes, "
                         f"expected {H * (W * C + 1)}")
    raw = raw.reshape(H, W * C + 1)
    filters = raw[:, 0]
    if (filters > 4).any():
        raise ValueError(f"{path}: unknown PNG row filter {int(filters.max())}")
    img = raw[:, 1:].reshape(H, W, C)
    if filters.any():
        img = _unfilter(img, filters, C)
    return img[:, :, 0] if C == 1 else img


def _filter(img: np.ndarray, kind: int) -> np.ndarray:
    """The bytes of filter ``kind`` for every row of (H, W, C) uint8."""
    x = img.astype(np.int32)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, 1:] = x[:-1, :-1]
    if kind == 0:
        pred = 0
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = b
    elif kind == 3:
        pred = (a + b) >> 1
    else:
        pred = _paeth(a, b, c)
    return ((x - pred) & 0xFF).astype(np.uint8)


def write_png(path: str | Path, img: np.ndarray, filter_type: int = 0) -> None:
    """Encode (H, W) or (H, W, C) uint8, C = 1 (grey), 2 (grey+alpha), 3 (RGB)
    or 4 (RGBA), with PNG row filter ``filter_type`` (0-4) on every row."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"write_png takes (H, W) or (H, W, 1-4), got {img.shape}")
    if filter_type not in range(5):
        raise ValueError(f"PNG filter type must be 0-4, got {filter_type}")
    H, W, C = img.shape
    rows = _filter(img, filter_type).reshape(H, W * C)
    raw = np.concatenate([np.full((H, 1), filter_type, np.uint8), rows], axis=1)

    def chunk(kind: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ihdr = struct.pack(">IIBBBBB", W, H, 8, _COLOR_TYPE[C], 0, 0, 0)
    Path(path).write_bytes(_SIGNATURE + chunk(b"IHDR", ihdr)
                           + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                           + chunk(b"IEND", b""))


def as_rgb(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) RGB of a decoded image, as ``cv2.imread``'s colour mode
    gives it: grey replicated, alpha dropped."""
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] in (1, 2):  # grey, grey + alpha
        img = np.repeat(img[:, :, :1], 3, axis=2)
    return img[:, :, :3]

"""The port's image codec: PNG in ``zlib`` with the row unfilter in native
code, and baseline JPEG in native code (``csrc/host/image_codec.cpp``, built
with ``g++`` at first use by ``utils/native.py``). The port reads KITTI's
frames and the training dump trees' JPEGs, and writes its depth images and
dump frames, without ``imageio``, ``cv2`` or PIL, none of which it depends on.

``read_image`` / ``decode_image`` pick PNG or JPEG by the file's signature
and return (H, W, 3) uint8 RGB, as ``cv2.imread(path, IMREAD_COLOR)[..., ::-1]``
gives it: the JPEG decoder follows libjpeg-turbo's arithmetic (its islow
IDCT, fancy upsampling and colour tables), so its pixels equal cv2's.
``read_png`` decodes 8-bit grey, grey+alpha, RGB and RGBA images, not
interlaced, with any of the five row filters; anything else (palette,
1/2/4/16-bit samples, Adam7 interlacing) raises ``ValueError`` naming the
file, as do JPEGs the decoder does not take (progressive, arithmetic,
lossless, 12-bit, CMYK, truncated or corrupt). ``write_png`` writes 8-bit
images of 1 to 4 channels with one filter type on every row; ``write_jpeg``
writes a baseline 4:2:0 JPEG as ``cv2.imwrite`` does with its defaults.
BMP and other formats are not read.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_JPEG_SIGNATURE = b"\xff\xd8\xff"
_ERR_LEN = 256
# colour type -> channels, for 8-bit samples
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _codec() -> ctypes.CDLL:
    """The native codec, built at first use."""
    from supervised_dispnet_tpu_torch.utils.native import load_library

    u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int)
    c_long, c_int, c_char_p = ctypes.c_long, ctypes.c_int, ctypes.c_char_p
    return load_library("image_codec", {
        "jpeg_header": ([c_char_p, c_long, i32p, i32p, i32p, c_char_p, c_int], c_int),
        "jpeg_decode": ([c_char_p, c_long, u8p, c_int, c_int, c_char_p, c_int], c_int),
        "jpeg_encode": ([u8p, c_int, c_int, c_int, u8p, c_long, c_char_p, c_int], c_long),
        "png_unfilter": ([u8p, c_int, c_long, c_int, u8p], c_int),
    })


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


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
    """Undo the PNG row filters of (H, W, bpp) bytes, one filter type a row:
    the plain numpy version of the native ``png_unfilter``, kept for tests.

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
    if filters.any():
        img = np.empty((H, W, C), np.uint8)
        _codec().png_unfilter(_ptr(raw), H, W * C, C, _ptr(img))
    else:
        img = raw[:, 1:].reshape(H, W, C)
    return img[:, :, 0] if C == 1 else img


def is_jpeg(data: bytes) -> bool:
    """Whether ``data`` starts with a JPEG's SOI marker and another marker."""
    return data.startswith(_JPEG_SIGNATURE)


def decode_jpeg(data: bytes, path: str | Path = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of a baseline JPEG's bytes (grey replicated), as
    libjpeg-turbo decodes it; ``path`` names the file in errors."""
    lib = _codec()
    err = ctypes.create_string_buffer(_ERR_LEN)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_header(data, len(data), ctypes.byref(h), ctypes.byref(w), ctypes.byref(c),
                       err, _ERR_LEN):
        raise ValueError(f"{path}: {err.value.decode()}")
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.jpeg_decode(data, len(data), _ptr(out), h.value, w.value, err, _ERR_LEN):
        raise ValueError(f"{path}: {err.value.decode()}")
    return out


def decode_image(data: bytes, path: str | Path = "<bytes>") -> np.ndarray:
    """(H, W, 3) uint8 RGB of a PNG's or a JPEG's bytes, chosen by signature,
    as ``cv2.imread``'s colour mode gives it."""
    if is_png(data):
        return as_rgb(decode_png(data, path))
    if is_jpeg(data):
        return decode_jpeg(data, path)
    raise ValueError(f"{path}: not a PNG or JPEG file")


def read_image(path: str | Path) -> np.ndarray:
    """``decode_image`` of a file: (H, W, 3) uint8 RGB."""
    return decode_image(Path(path).read_bytes(), path)


def encode_jpeg(rgb: np.ndarray, quality: int = 95) -> bytes:
    """A baseline 4:2:0 JPEG of (H, W, 3) uint8 RGB at ``quality`` (1-100),
    as libjpeg-turbo writes it with its defaults (cv2.imwrite's)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8, got {rgb.dtype} {rgb.shape}")
    if not 1 <= quality <= 100:
        raise ValueError(f"JPEG quality must be 1-100, got {quality}")
    rgb = np.ascontiguousarray(rgb)
    H, W = rgb.shape[:2]
    lib = _codec()
    err = ctypes.create_string_buffer(_ERR_LEN)
    cap = H * W * 3 + 4096
    while True:
        out = np.empty(cap, np.uint8)
        n = lib.jpeg_encode(_ptr(rgb), H, W, quality, _ptr(out), cap, err, _ERR_LEN)
        if n == 0:
            raise ValueError(f"JPEG encode failed: {err.value.decode()}")
        if n > 0:
            return out[:n].tobytes()
        cap = -n  # the exact size the file needs


def write_jpeg(path: str | Path, rgb: np.ndarray, quality: int = 95) -> None:
    """Write ``encode_jpeg(rgb, quality)`` to ``path``."""
    Path(path).write_bytes(encode_jpeg(rgb, quality))


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

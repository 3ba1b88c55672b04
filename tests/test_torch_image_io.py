"""The port's host image helpers against the libraries the JAX package reads
and resizes with: the PNG codec (``utils/image_io.py``) bit-equal to
``imageio`` and ``cv2`` on the files each writes, and the eval pipeline's
resizes (``data/image_resize.py``) against ``cv2.resize`` to atol 1e-5 on
float32 images in [0, 1] (a few float32 roundings of sums of weights that
add to 1; OpenCV's float weights are reproduced, not approximated)."""

import struct
import zlib

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest

from supervised_dispnet_tpu_torch.data.image_resize import (resize_area, resize_area_uint8,
                                                            resize_linear)
from supervised_dispnet_tpu_torch.utils.image_io import read_png, write_png


def _image(rng, shape):
    """A smooth ramp plus noise, so that encoders pick varied row filters."""
    H, W = shape[:2]
    yy, xx = np.mgrid[:H, :W]
    base = (xx * 3 + yy * 2)[..., None] + np.arange(shape[2] if len(shape) > 2 else 1) * 40
    img = np.clip(base % 256 + rng.normal(0, 8, base.shape), 0, 255).astype(np.uint8)
    return img if len(shape) > 2 else img[..., 0]


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
def test_png_written_with_each_filter_reads_back_as_imageio_reads_it(tmp_path, channels,
                                                                     filter_type):
    rng = np.random.default_rng(channels * 10 + filter_type)
    img = _image(rng, (37, 53) if channels == 1 else (37, 53, channels))
    path = tmp_path / "x.png"
    write_png(path, img, filter_type=filter_type)
    data = path.read_bytes()
    (n,) = struct.unpack(">I", data[33:37])  # the IDAT chunk after the IHDR
    rows = np.frombuffer(zlib.decompress(data[41:41 + n]), np.uint8).reshape(37, -1)
    assert (rows[:, 0] == filter_type).all()
    np.testing.assert_array_equal(read_png(path), img)
    np.testing.assert_array_equal(imageio.imread(path), img)


@pytest.mark.parametrize("shape", [(375, 1242, 3), (64, 96), (48, 80, 4), (9, 7, 2)])
def test_png_written_by_imageio_and_cv2_decodes_bit_equal(tmp_path, shape):
    img = _image(np.random.default_rng(len(shape)), shape)
    imageio.imwrite(tmp_path / "imageio.png", img)
    np.testing.assert_array_equal(read_png(tmp_path / "imageio.png"), img)
    if len(shape) == 2 or shape[2] in (3, 4):  # cv2 writes grey, BGR and BGRA
        bgr = img if img.ndim == 2 else img[..., [2, 1, 0, 3][:shape[2]]]
        cv2.imwrite(str(tmp_path / "cv2.png"), bgr)
        np.testing.assert_array_equal(read_png(tmp_path / "cv2.png"), img)


def _png(path, width, height, depth, color, interlace=0, data=b"\0" * 8):
    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ihdr = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, interlace)
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                     + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind,match", [
    ("palette", "palette"), ("16-bit", "16-bit"), ("interlaced", "interlaced"),
    ("not png", "not a PNG"), ("corrupt", "corrupt"), ("truncated", "truncated"),
])
def test_png_reader_refuses_what_it_does_not_decode(tmp_path, kind, match):
    path = tmp_path / f"{kind}.png"
    if kind == "palette":
        _png(path, 4, 4, 8, 3)
    elif kind == "16-bit":
        cv2.imwrite(str(path), np.full((4, 4), 1000, np.uint16))
    elif kind == "interlaced":
        _png(path, 4, 4, 8, 0, interlace=1)
    elif kind == "not png":
        path.write_bytes(b"GIF89a" + b"\0" * 40)
    else:
        write_png(path, np.zeros((4, 4), np.uint8))
        data = bytearray(path.read_bytes())
        if kind == "corrupt":
            data[43] ^= 0xFF  # a byte of the IDAT payload
        else:
            del data[45:]  # inside the IDAT chunk
        path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=match) as err:
        read_png(path)
    assert str(path) in str(err.value)


@pytest.mark.parametrize("src,dst", [
    ((375, 1242), (128, 416)),  # KITTI's frames to the network input: 2.93 x 2.99
    ((75, 250), (32, 104)),
    ((370, 1224), (128, 416)),
    ((64, 208), (32, 104)),  # an integer ratio (OpenCV's fast path)
])
def test_resize_area_matches_cv2_inter_area(src, dst):
    rng = np.random.default_rng(sum(src))
    img = rng.uniform(size=src + (3,)).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    np.testing.assert_allclose(resize_area(img, *dst), want, rtol=0, atol=1e-5)
    # a batch, and a single channel as (H, W)
    np.testing.assert_allclose(resize_area(np.stack([img, img[::-1]]), *dst)[1],
                               cv2.resize(img[::-1], dst[::-1], interpolation=cv2.INTER_AREA),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(resize_area(img[..., 0], *dst), want[..., 0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("src,dst", [
    ((128, 416), (375, 1242)),  # a prediction to KITTI's GT size
    ((32, 104), (75, 250)),
    ((375, 1242), (128, 416)),  # downscaling
    ((7, 3), (5, 11)),
])
def test_resize_linear_matches_cv2_inter_linear(src, dst):
    rng = np.random.default_rng(sum(dst))
    img = rng.uniform(size=src).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(resize_linear(img, *dst), want, rtol=0, atol=1e-5)
    rgb = rng.uniform(size=src + (3,)).astype(np.float32)
    np.testing.assert_allclose(resize_linear(rgb, *dst),
                               cv2.resize(rgb, dst[::-1], interpolation=cv2.INTER_LINEAR),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("src,dst", [
    ((32, 104), (64, 104)),  # one axis grows
    ((32, 104), (16, 208)),  # one grows, one shrinks: both take the two-tap table
    ((100, 300), (128, 416)),  # a frame smaller than the network input
    ((7, 3), (13, 11)),
    ((5, 5), (128, 416)),
])
def test_area_upscale_matches_cv2_inter_area(src, dst):
    """An ``INTER_AREA`` upscale follows OpenCV's two-tap table: float32 to
    atol 1e-5 (the matrix products' float32 roundings), uint8 bit for bit
    (OpenCV's 11-bit fixed point), RGB and grey."""
    rng = np.random.default_rng(sum(src) + sum(dst))
    img = rng.uniform(size=src + (3,)).astype(np.float32)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
    np.testing.assert_allclose(resize_area(img, *dst), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(resize_area(img[..., 0], *dst), want[..., 0], rtol=0, atol=1e-5)
    u8 = rng.integers(0, 256, src + (3,), dtype=np.uint8)
    np.testing.assert_array_equal(resize_area_uint8(u8, *dst),
                                  cv2.resize(u8, dst[::-1], interpolation=cv2.INTER_AREA))
    np.testing.assert_array_equal(resize_area_uint8(u8[..., 1], *dst),
                                  cv2.resize(u8[..., 1], dst[::-1], interpolation=cv2.INTER_AREA))

"""The port's native image codec (``csrc/host/image_codec.cpp`` through
``utils/image_io.py``) against the libraries the JAX package reads and
writes frames with.

- Decoding: every baseline JPEG here decodes to what the JAX package's
  ``data/sequence_folders.py::load_as_uint8`` (``cv2.imread``) gives, max
  abs diff 0: qualities 50/75/95/100, 4:4:4, 4:2:2, 4:2:0, 4:4:0 and grey,
  at 375x1242, 128x416, 17x23 and 1x1, with restart intervals, and as
  imageio / PIL write them. libjpeg-turbo's integer IDCT, fancy upsampling
  and colour tables are deterministic, so nothing but 0 is expected.
- Progressive, truncated and corrupt files raise ``ValueError`` naming the
  file.
- Encoding: ``write_jpeg``'s file, decoded by cv2, equals cv2's own
  quality-95 file decoded, max abs diff <= 1 with >= 99.9% of pixels
  identical; the files are byte-identical here (asserted separately, so a
  libjpeg-turbo that changed its bytes would show which of the two held).
- The native PNG unfilter equals the numpy ``_unfilter`` and cv2 for each of
  the five row filters.
- Without ``g++`` the build raises; nothing falls back.
"""

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

from supervised_dispnet_tpu.data.sequence_folders import load_as_uint8
from supervised_dispnet_tpu_torch.utils import image_io, native
from supervised_dispnet_tpu_torch.utils.image_io import (
    _unfilter, decode_image, encode_jpeg, read_image, read_png, write_jpeg, write_png)
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

SHAPES = [(375, 1242), (128, 416), (17, 23), (1, 1)]
# cv2's IMWRITE_JPEG_SAMPLING_FACTOR values; None: a grey (1-component) file
SAMPLINGS = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "440": 0x121111,
             "grey": None}


def _frame(rng, shape, grey=False):
    """A road-like gradient with noise, so every coefficient band is used."""
    H, W = shape
    yy, xx = np.mgrid[:H, :W]
    base = np.stack([(xx * 3 + yy * 2) % 256, (xx * 5) % 256, (yy * 7 + 40) % 256], -1)
    img = np.clip(base + rng.normal(0, 20, base.shape), 0, 255).astype(np.uint8)
    return img[..., 0] if grey else img


def _cv2_jpeg(path, img, quality, sampling=None, restart=0):
    """``img`` RGB (or grey) written by cv2 as the JAX ETL writes frames."""
    params = [cv2.IMWRITE_JPEG_QUALITY, quality]
    if sampling is not None:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, sampling]
    if restart:
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    assert cv2.imwrite(str(path), img if img.ndim == 2 else img[..., ::-1], params)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_decoder_equals_cv2_bit_for_bit(tmp_path, shape, sampling):
    rng = np.random.default_rng(shape[0] + len(sampling))
    for quality in (50, 75, 95, 100):
        img = _frame(rng, shape, grey=sampling == "grey")
        path = tmp_path / f"q{quality}.jpg"
        _cv2_jpeg(path, img, quality, SAMPLINGS[sampling])
        got = read_image(path)
        assert got.shape == shape + (3,) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, load_as_uint8(path), err_msg=f"q{quality}")


@pytest.mark.parametrize("sampling", ["444", "420", "grey"])
@pytest.mark.parametrize("restart", [1, 3])
def test_restart_intervals_decode_bit_for_bit(tmp_path, sampling, restart):
    """cv2's ``IMWRITE_JPEG_RST_INTERVAL`` (MCUs between RST markers)."""
    img = _frame(np.random.default_rng(restart), (53, 77), grey=sampling == "grey")
    path = tmp_path / "rst.jpg"
    _cv2_jpeg(path, img, 90, SAMPLINGS[sampling], restart=restart)
    assert b"\xff\xdd" in path.read_bytes()  # a DRI segment
    np.testing.assert_array_equal(read_image(path), load_as_uint8(path))


@pytest.mark.parametrize("writer", ["imageio", "pil_444", "pil_422", "pil_420"])
@pytest.mark.parametrize("shape", [(32, 64), (375, 1242), (9, 5)])
def test_imageio_and_pil_files_decode_bit_for_bit(tmp_path, writer, shape):
    """imageio writes as ``tests/test_packed.py`` does (PIL, quality 75,
    4:2:0); PIL directly with each subsampling."""
    img = np.random.default_rng(sum(shape)).uniform(0, 255, shape + (3,)).astype(np.uint8)
    path = tmp_path / "f.jpg"
    if writer == "imageio":
        imageio.imwrite(path, img)
    else:
        sub = {"pil_444": 0, "pil_422": 1, "pil_420": 2}[writer]
        Image.fromarray(img).save(path, format="JPEG", quality=85, subsampling=sub)
    np.testing.assert_array_equal(read_image(path), load_as_uint8(path))


def _progressive(path):
    img = _frame(np.random.default_rng(0), (40, 60))
    Image.fromarray(img).save(path, format="JPEG", progressive=True)


def _truncated(path):
    _cv2_jpeg(path, _frame(np.random.default_rng(1), (40, 60)), 95)
    data = path.read_bytes()
    path.write_bytes(data[:len(data) // 2])


def _corrupt(path):
    """A marker (a reserved frame marker) in the middle of the scan data."""
    _cv2_jpeg(path, _frame(np.random.default_rng(2), (40, 60)), 95)
    data = bytearray(path.read_bytes())
    sos = data.index(b"\xff\xda")
    mid = (sos + len(data)) // 2
    data[mid:mid + 2] = b"\xff\xc8"
    path.write_bytes(bytes(data))


def _arithmetic(path):
    """A SOF9 (arithmetic-coded) header in place of the SOF0."""
    _cv2_jpeg(path, _frame(np.random.default_rng(3), (16, 16)), 95)
    data = bytearray(path.read_bytes())
    data[data.index(b"\xff\xc0") + 1] = 0xC9
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("make,match", [
    (_progressive, "progressive"), (_truncated, "truncated"),
    (_corrupt, "corrupt JPEG data"), (_arithmetic, "arithmetic"),
], ids=["progressive", "truncated", "corrupt", "arithmetic"])
def test_unsupported_and_damaged_jpegs_raise_naming_the_file(tmp_path, make, match):
    path = tmp_path / "bad.jpg"
    make(path)
    with pytest.raises(ValueError, match=match) as err:
        read_image(path)
    assert str(path) in str(err.value)


def test_a_file_neither_png_nor_jpeg_raises_naming_it(tmp_path):
    path = tmp_path / "x.bmp"
    path.write_bytes(b"BM" + b"\0" * 60)
    with pytest.raises(ValueError, match="not a PNG or JPEG") as err:
        read_image(path)
    assert str(path) in str(err.value)


@pytest.mark.parametrize("shape", [(375, 1242), (128, 416), (17, 23), (1, 1), (33, 65)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_write_jpeg_is_what_cv2_writes(tmp_path, shape):
    """Quality 95, 4:2:0 (cv2.imwrite's defaults): decoded by cv2, within one
    level of cv2's own file on >= 99.9% identical pixels, and here the very
    same bytes."""
    img = _frame(np.random.default_rng(shape[1]), shape)
    write_jpeg(tmp_path / "port.jpg", img)
    _cv2_jpeg(tmp_path / "cv2.jpg", img, 95)
    a, b = load_as_uint8(tmp_path / "port.jpg"), load_as_uint8(tmp_path / "cv2.jpg")
    assert np.abs(a.astype(int) - b).max() <= 1
    assert (a == b).all(axis=-1).mean() >= 0.999
    assert (tmp_path / "port.jpg").read_bytes() == (tmp_path / "cv2.jpg").read_bytes()


@pytest.mark.parametrize("quality", [1, 50, 75, 100])
def test_encoder_qualities_match_cv2(quality):
    img = _frame(np.random.default_rng(quality), (64, 96))
    ok, want = cv2.imencode(".jpg", img[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok and encode_jpeg(img, quality) == want.tobytes()
    np.testing.assert_array_equal(decode_image(encode_jpeg(img, quality)),
                                  cv2.imdecode(want, cv2.IMREAD_COLOR)[..., ::-1])


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_native_png_unfilter_equals_numpy_and_cv2(tmp_path, filter_type, channels):
    rng = np.random.default_rng(filter_type * 7 + channels)
    img = rng.integers(0, 256, (41, 67, channels), dtype=np.uint8)
    path = tmp_path / "f.png"
    write_png(path, img[..., 0] if channels == 1 else img, filter_type=filter_type)
    got = read_png(path)
    got = got[..., None] if channels == 1 else got
    np.testing.assert_array_equal(got, img)
    raw = image_io._filter(img, filter_type)
    np.testing.assert_array_equal(
        _unfilter(raw, np.full(41, filter_type, np.uint8), channels), img)
    flags = cv2.IMREAD_UNCHANGED
    want = cv2.imread(str(path), flags)
    want = want[..., None] if channels == 1 else want[..., [2, 1, 0, 3][:channels]]
    np.testing.assert_array_equal(got, want)


def test_a_mixed_filter_png_equals_the_numpy_unfilter():
    """Rows of all five filter types in one image, through the native path
    and the numpy wavefront."""
    rng = np.random.default_rng(9)
    img = rng.integers(0, 256, (25, 31, 3), dtype=np.uint8)
    filters = np.arange(25, dtype=np.uint8) % 5
    raw = np.stack([image_io._filter(img, int(f))[r] for r, f in enumerate(filters)])
    rows = np.concatenate([filters[:, None], raw.reshape(25, -1)], axis=1)
    out = np.empty_like(img)
    assert image_io._codec().png_unfilter(image_io._ptr(np.ascontiguousarray(rows)), 25,
                                          31 * 3, 3, image_io._ptr(out)) == 0
    np.testing.assert_array_equal(out, img)
    np.testing.assert_array_equal(_unfilter(raw, filters, 3), img)


def test_without_gxx_the_build_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.load_library("image_codec", {})
    assert not (tmp_path / "build").exists()


def test_the_build_is_named_by_source_and_flags(tmp_path, monkeypatch):
    """One library a (source, flags) pair; a second load reuses it."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_libs", {})
    path = native.library_path("image_codec")
    assert path.parent == tmp_path / "build" and path.name.startswith("libimage_codec-")
    native.load_library("image_codec", {})
    assert path.is_file() and sorted(p.name for p in path.parent.iterdir()) == [path.name]
    monkeypatch.setattr(native, "GXX_FLAGS", native.GXX_FLAGS + ("-DX",))
    assert native.library_path("image_codec") != path


def test_decoding_from_threads_gives_the_same_frames(tmp_path):
    """The codec is reentrant: frames decoded on 4 threads at once equal
    their serial decodes."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(4)
    datas = [encode_jpeg(_frame(rng, (64, 96))) for _ in range(12)]
    serial = [decode_image(d) for d in datas]
    with ThreadPoolExecutor(4) as pool:
        threaded = list(pool.map(decode_image, datas * 3))
    for i, img in enumerate(threaded):
        np.testing.assert_array_equal(img, serial[i % 12])


def test_encode_jpeg_refuses_what_it_does_not_write():
    with pytest.raises(ValueError, match="uint8"):
        encode_jpeg(np.zeros((4, 4, 3), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        encode_jpeg(np.zeros((4, 4), np.uint8))
    with pytest.raises(ValueError, match="quality"):
        encode_jpeg(np.zeros((4, 4, 3), np.uint8), quality=0)

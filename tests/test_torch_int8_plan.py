"""The int8 convolution's plan (``ops/cuda/int8_conv.py::plan``) and the
plain version of the way the kernel computes: the lhs-dilated convs split
by output parity into phases over the undilated input, the input's channels
padded with zeros to a multiple of 16, the weight packed per phase.

- The phase split's int32 accumulators equal the zero-stuffed reference
  (``conv_acc_plain``) and ``lax.conv_general_dilated(int8 -> int32)``
  exactly, for FCRN's unpool conv (5x5, padding (2, 3)) and the fused decoder
  stage's 6x6 (padding 1), at odd and even H, W, ragged channel counts.
- The channel-padded input gives the unpadded one's sums and outputs, bit
  for bit, for C in {3, 17, 65, 129} (the stems, DispNetS's concat inputs).
- The plan's invariants over the model's conv shapes: the K slices cover
  [0, K) exactly; the split where the tiles fill at most half a wave; 4
  phases for lhs dilation 2, else 1, partitioning the outputs; C padded to a
  multiple of 16; the packed weight's blocks where the plan says.
- The op refuses a weight packed in an earlier layout (an old export's).
- ``quantized_apply`` on DispNetS and FCRN runs through the padding and the
  phases (both are seen in its calls, with the plan's variants each network
  takes) and gives, bit for bit, what the zero-stuffed reference conv on the
  unpadded input gives. The same forward on the same input against JAX's
  ``quantized_apply`` is ``test_quantized_apply_matches_jax`` in
  ``tests/test_torch_quant.py`` and ``tests/test_torch_quant_fcrn.py``;
  here the nets are the port's seeded ones, calibrated by the port, so the
  test runs no JAX (JAX's op-by-op forward took 55 of its 72 s, at any
  input size: 48 s at (1, 32, 64)).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from supervised_dispnet_tpu_torch.ops import quant as pq
from supervised_dispnet_tpu_torch.ops.cuda import int8_conv as ic
from supervised_dispnet_tpu_torch.models import get_disp_net
from tests.torch_quant_ref import X, listed
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

# name: (Cin, kernel, stride, padding, lhs dilation), as tests/test_torch_int8_conv.py
PHASED = {
    "unpool-5x5": (8, 5, (1, 1), ((2, 3), (2, 3)), (2, 2)),
    "fused-6x6": (16, 6, (1, 1), ((1, 1), (1, 1)), (2, 2)),
    "unpool-5x5-cin17": (17, 5, (1, 1), ((2, 3), (2, 3)), (2, 2)),
    "fused-6x6-cin3": (3, 6, (1, 1), ((1, 1), (1, 1)), (2, 2)),
}


def _lax_acc(x, w_hwio, stride, pad, lhs, rhs=(1, 1)):
    dn = lax.conv_dimension_numbers(x.shape, w_hwio.shape, ("NHWC", "HWIO", "NHWC"))
    return np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w_hwio), stride, pad, lhs_dilation=lhs, rhs_dilation=rhs,
        dimension_numbers=dn, preferred_element_type=jnp.int32))


def _random(rng, shape):
    return rng.integers(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("hw", [(9, 11), (8, 10), (5, 7)])
@pytest.mark.parametrize("gid", list(PHASED))
def test_phase_split_equals_reference_and_lax(gid, hw):
    cin, k, stride, pad, lhs = PHASED[gid]
    rng = np.random.default_rng([list(PHASED).index(gid), *hw])
    x = _random(rng, (2, *hw, cin))
    w = _random(rng, (k, k, cin, 24))
    geom = ic.Geometry(k, k, stride, (*pad[0], *pad[1]), lhs)
    packed = ic.pack_weight(torch.from_numpy(w).permute(3, 0, 1, 2).contiguous(), geom)
    pl = ic.plan(x.shape, geom, 24)
    assert len(pl.phases) == 4 and packed.shape == (24, pl.width)
    want = _lax_acc(x, w, stride, pad, lhs)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(ic.conv_acc_plain(xt, packed, geom).numpy(), want)
    np.testing.assert_array_equal(ic.conv_acc_phases_plain(xt, packed, geom).numpy(), want)
    got = ic.int8_conv(xt, packed, geom, torch.ones(24), torch.zeros(24), out="s32")
    np.testing.assert_array_equal(got.numpy(), want)


def test_phases_hold_only_the_taps_on_input_pixels():
    """FCRN's 5x5 unpool conv splits into 3x3 / 3x2 / 2x3 / 2x2 taps, the
    fused stage's 6x6 into four 3x3: a quarter of the dilated conv's MACs."""
    taps = {name: [(p.nty, p.ntx) for p in ic.plan((1, 9, 11, 16), geom, 16).phases]
            for name, geom in (("unpool", pq.UNPOOL_GEOMETRY), ("fused", pq.FUSED_GEOMETRY))}
    assert taps["unpool"] == [(3, 3), (3, 2), (2, 3), (2, 2)]
    assert taps["fused"] == [(3, 3)] * 4


@pytest.mark.parametrize("cin", [3, 17, 65, 129])
def test_channel_pad_equals_unpadded(cin):
    rng = np.random.default_rng(cin)
    geom = ic.Geometry.square(7, 2, 3) if cin == 3 else ic.Geometry.square(3, 1, 1)
    x = _random(rng, (2, 13, 15, cin))
    w = _random(rng, (geom.kh, geom.kw, cin, 20))
    packed = ic.pack_weight(torch.from_numpy(w).permute(3, 0, 1, 2).contiguous(), geom)
    xt = torch.from_numpy(x)
    padded = ic.pad_channels(xt)
    assert padded.shape[3] == ic.padded_channels(cin) and padded.shape[3] % 16 == 0
    assert not padded[..., cin:].any() and torch.equal(padded[..., :cin], xt)
    want = _lax_acc(x, w, geom.stride, (geom.padding[:2], geom.padding[2:]), (1, 1))
    mult = torch.from_numpy(rng.uniform(1e-5, 2e-5, 20).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.3, 20).astype(np.float32))
    for inp in (xt, padded):
        np.testing.assert_array_equal(
            ic.int8_conv(inp, packed, geom, mult, bias, out="s32").numpy(), want)
        np.testing.assert_array_equal(ic.conv_acc_phases_plain(inp, packed, geom).numpy(), want)
    kw = {"act": "relu", "out": "s8", "out_scale": 0.05}
    assert torch.equal(ic.int8_conv(xt, packed, geom, mult, bias, **kw),
                       ic.int8_conv(padded, packed, geom, mult, bias, **kw))


# (x shape, Cout, geometry): convs of the int8 twins at (8, 3, 128, 416) and
# of the tests' sizes, and a few made-up ones
PLAN_CASES = [
    ((8, 128, 416, 3), 64, ic.Geometry.square(7, 2, 3)),
    ((8, 32, 104, 64), 256, ic.Geometry.square(1)),
    ((8, 8, 26, 256), 256, ic.Geometry.square(3, 1, 1)),
    ((8, 8, 26, 1024), 2048, ic.Geometry.square(1, 2, 0)),
    ((8, 4, 13, 2048), 256, ic.Geometry.square(3, 1, 1)),
    ((8, 4, 13, 512), 512, ic.Geometry.square(3, 1, 1)),
    ((8, 6, 15, 256), 256, pq.FUSED_GEOMETRY),
    ((8, 66, 210, 16), 16, pq.FUSED_GEOMETRY),
    ((8, 4, 13, 1024), 512, pq.UNPOOL_GEOMETRY),
    ((8, 32, 104, 128), 64, pq.UNPOOL_GEOMETRY),
    ((8, 128, 416, 17), 16, ic.Geometry.square(3, 1, 1)),
    ((8, 64, 208, 65), 32, ic.Geometry.square(3, 1, 1)),
    ((8, 32, 104, 129), 64, ic.Geometry.square(3, 1, 1)),
    ((2, 9, 11, 5), 24, ic.Geometry(3, 3, (1, 1), (2, 1, 0, 2), (1, 1), (2, 2))),
    ((1, 3, 5, 40), 21, ic.Geometry(1, 1, (1, 1), (0, 1, 0, 1), (2, 2))),
    ((2, 7, 9, 48), 300, ic.Geometry(4, 2, (1, 1), (3, 0, 1, 2), (2, 2))),
]


@pytest.mark.parametrize("x_shape,cout,geom", PLAN_CASES)
def test_plan_invariants(x_shape, cout, geom):
    B, H, W, C = x_shape
    pl = ic.plan(x_shape, geom, cout)
    ho, wo = geom.out_hw(H, W)
    assert pl.cp % ic.CHANNEL_STEP == 0 and C <= pl.cp < C + ic.CHANNEL_STEP
    lhs = geom.lhs_dilation != (1, 1)
    assert len(pl.phases) == (4 if lhs else 1)
    # the phases partition the outputs, each at its stride
    seen = np.zeros((ho, wo), int)
    for ph in pl.phases:
        seen[ph.py::pl.osy, ph.px::pl.osx] += 1
        assert (ph.ho, ph.wo) == seen[ph.py::pl.osy, ph.px::pl.osx].shape
    assert (seen == 1).all()
    # the tile and the tiles
    assert pl.bn in ic.N_TILES and pl.bn >= min(cout, ic.N_TILES[-1])
    assert pl.bm == 64 * pl.wg
    if pl.wg == 2 and pl.bn == 128:  # a deep K, split
        assert pl.splits > 1 and all(ph.kp // ic.K_TILE >= ic.DEEP_K_TILES
                                     for ph in pl.phases if ph.kp)
        rows = [B * ph.ho * ph.wo for ph in pl.phases]
        pad64 = sum(-(-m // 64) * 64 - m for m in rows)
        pad128 = sum(-(-m // 128) * 128 - m for m in rows)
        assert pad128 <= pad64 or 2 * -(-cout // 128) * sum(-(-m // 64) for m in rows) > ic.WAVE
    ntn = -(-cout // pl.bn)
    for ph in pl.phases:
        assert ph.mtiles == -(-B * ph.ho * ph.wo // pl.bm)
    assert pl.tiles == sum(ph.mtiles for ph in pl.phases) * ntn
    # K: each phase's taps, padded to whole K tiles, at its column
    offsets = np.cumsum([0] + [ph.kp for ph in pl.phases])
    for ph, off in zip(pl.phases, offsets):
        assert ph.k == ph.nty * ph.ntx * pl.cp and ph.kp % ic.K_TILE == 0
        assert ph.k <= ph.kp < ph.k + ic.K_TILE and ph.w_off == off
    assert pl.width == offsets[-1] == ic.packed_width(C, geom)
    taps = sum(ph.nty * ph.ntx for ph in pl.phases)
    assert taps == geom.kh * geom.kw  # each tap in exactly one phase
    # the K slices cover [0, nk) in order, one a split
    for ph in pl.phases:
        nk = ph.kp // ic.K_TILE
        assert len(ph.slices) == pl.splits and ph.slices[0][0] == 0 and ph.slices[-1][1] == nk
        assert all(a[1] == b[0] for a, b in zip(ph.slices, ph.slices[1:]))
        assert all(hi >= lo for lo, hi in ph.slices)
    # split where the tiles fill at most half a wave and K is deep enough
    shallowest = min((ph.kp // ic.K_TILE for ph in pl.phases if ph.kp), default=0)
    deep = shallowest >= 2 * ic.MIN_SPLIT_TILES
    assert (pl.splits > 1) == (2 * pl.tiles <= ic.WAVE and deep)
    if pl.splits > 1:
        assert pl.splits * pl.tiles <= ic.WAVE and pl.splits <= ic.MAX_SPLITS
        assert all(hi - lo >= ic.MIN_SPLIT_TILES for ph in pl.phases if ph.kp
                   for lo, hi in ph.slices)
    # an override keeps the rest, and a single slice is the whole K
    one = ic.plan(x_shape, geom, cout, 1)
    assert one.splits == 1 and all(ph.slices == ((0, ph.kp // ic.K_TILE),) for ph in one.phases)
    assert (one.tiles, one.width, one.bn, one.wg) == (pl.tiles, pl.width, pl.bn, pl.wg)
    # the packed weight: the plan's width, and unpacked back to the taps
    wq = torch.from_numpy(_random(np.random.default_rng(1), (cout, geom.kh, geom.kw, C)))
    packed = ic.pack_weight(wq, geom)
    assert packed.shape == (cout, pl.width)
    assert torch.equal(ic.unpack_weight(packed, geom, pl.cp)[..., :C], wq)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 13, 15, 16, 144, 416, 1664, 6656, 53248, 2**20 + 1,
                               2**31 - 1])
def test_fast_divisor_divides_exactly(d):
    """The kernel's multiply-shift division (``FastDiv``) by the divisors it
    is given (ho * wo, wo, taps a row, C): n // d for every n in [0, 2^31)
    tried, the ends and each side of the multiples of d among them."""
    mul, shift = ic.fast_divisor(d)
    assert 0 <= mul < 2**32 and shift >= 0
    rng = np.random.default_rng(d)
    multiples = rng.integers(1, 2**31 // d + 1, 2000) * d
    n = np.concatenate([rng.integers(0, 2**31, 20000), [0, 1, 2**31 - 1, 2**31 - 2],
                        multiples - 1, multiples, multiples + 1]).astype(np.uint64)
    n = n[n < 2**31]
    got = n if mul == 0 else ((n * np.uint64(mul)) >> np.uint64(32)) >> np.uint64(shift)
    np.testing.assert_array_equal(got, n // np.uint64(d))


def test_plan_refuses_what_the_kernel_does_not_run():
    with pytest.raises(ValueError, match="stride 1"):
        ic.plan((1, 8, 8, 16), ic.Geometry(3, 3, (2, 2), (1, 1, 1, 1), (2, 2)), 16)
    with pytest.raises(ValueError, match="phases"):
        ic.plan((1, 8, 8, 16), ic.Geometry(3, 3, (1, 1), (1, 1, 1, 1), (3, 3)), 16)


@pytest.mark.parametrize("geom", [ic.Geometry.square(3, pad=1), pq.FUSED_GEOMETRY],
                         ids=["3x3", "fused-6x6"])
def test_op_refuses_a_weight_of_another_packed_width(geom):
    """The op, as an exported program calls it, raises on a weight packed
    with K padded to 32 bytes and no phases (an earlier layout) instead of
    reading its rows at the plan's width."""
    x = torch.zeros(1, 5, 6, 16, dtype=torch.int8)
    w = torch.zeros(8, -(-geom.kh * geom.kw * 16 // 32) * 32, dtype=torch.int8)
    assert w.shape[1] != ic.packed_width(16, geom)
    with pytest.raises(ValueError, match="exported again"):
        torch.ops.sdtpu.int8_conv(x, w, torch.ones(8), torch.zeros(8), None, geom.as_list(),
                                  0, 0, 0, 0.0, 1.0)


def _reference_conv(cins):
    """``int8_conv`` as the zero-stuffed reference computes it on the
    unpadded input (``conv_acc_plain`` + ``epilogue_plain``)."""

    def conv(xq, w, geom, mult, bias, residual=None, act="none", out="f32", out_scale=1.0,
             res_scale=0.0, res_before_bias=False):
        acc = ic.conv_acc_plain(xq[..., :cins[w.data_ptr()]].contiguous(), w, geom)
        return ic.epilogue_plain(acc, mult, bias, residual, ic.ACTS[act], ic.OUTS[out],
                                 ic._res_mode(residual, res_before_bias), res_scale, out_scale)

    return conv


# the plan's variants (padded, bn, wg, splits, phases) each network's int8
# forward takes at X (2, 64, 96): split-K, both tile widths and, for FCRN,
# the 4 phases
VARIANTS = {
    "dispnet": {(False, 32, 1, 2, 1), (False, 64, 1, 1, 1), (False, 64, 1, 3, 1),
                (False, 128, 1, 1, 1), (False, 128, 1, 2, 1), (False, 128, 1, 4, 1),
                (False, 128, 1, 9, 1), (False, 128, 1, 16, 1), (True, 16, 1, 1, 1),
                (True, 32, 1, 1, 1), (True, 64, 1, 2, 1)},
    "fcrn": {(False, 64, 1, 1, 1), (False, 64, 1, 1, 4), (False, 128, 1, 1, 1),
             (False, 128, 1, 2, 1), (False, 128, 1, 2, 4), (False, 128, 1, 4, 1),
             (False, 128, 1, 4, 4), (False, 128, 1, 8, 4), (False, 128, 1, 9, 1),
             (True, 64, 1, 1, 1)},
}


@pytest.mark.parametrize("cid", ["dispnet", "fcrn"])
def test_quantized_apply_through_padding_and_phases(cid, monkeypatch):
    x = torch.from_numpy(X)
    pm = get_disp_net(cid, seed=0, device="cpu")
    twin = pq.QuantizedModel(pm, pq.calibrate_conv_ranges(pm, [x]))
    cins = {m.w.data_ptr(): m.cin for m in twin.modules() if isinstance(m, pq._QWeights)}
    seen, real = [], pq.int8_conv

    def record(xq, w, geom, *args, **kw):
        pl = ic.plan(tuple(xq.shape), geom, w.shape[0])
        seen.append((pl.cp, cins[w.data_ptr()], pl.bn, pl.wg, pl.splits, len(pl.phases)))
        return real(xq, w, geom, *args, **kw)

    monkeypatch.setattr(pq, "int8_conv", record)
    with torch.no_grad():
        got = listed(twin(x))
    assert any(c != cin for c, cin, *_ in seen)  # padded channels: DispNetS's 3 / 17 / 65 / 129
    assert all(c % 16 == 0 for c, *_ in seen)
    assert any(n == 4 for *_, n in seen) == (cid == "fcrn")  # FCRN's unpool convs
    assert {(c != cin, *rest) for c, cin, *rest in seen} == VARIANTS[cid]
    monkeypatch.setattr(pq, "int8_conv", _reference_conv(cins))
    with torch.no_grad():
        ref = listed(twin(x))
    assert len(got) == len(ref) and all(np.isfinite(g).all() for g in got)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)

"""The port's online serving (``serving.py::DepthService``) and its HTTP
server (``cli/serve.py``), on the CPU.

``predict`` against the JAX package's ``DepthService.predict`` on the same
DispNetS weights (``dispnet_from_jax``), buckets (2, 4): rtol 1e-3 / atol
2e-4, the disparity nets' limit of ``tests/test_checkpoint_convert.py``.
The rest mirrors ``tests/test_serving.py`` against the port's own offline
forward (1 / max(disp, 1e-6)), which padding, chunking and micro-batching
must not change: rtol 1e-6 / atol 1e-6 (the same float32 convolutions of a
batch whose other rows differ). And the two defects of the JAX service that
the port does not copy: a cancelled request leaves the dispatcher alive,
and a ``submit`` that races ``stop`` is answered or refused, never left
pending. Every ``result()`` and ``join`` has a timeout."""

import io
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_dispnet_tpu.models import DispNetS as JaxDispNetS
from supervised_dispnet_tpu.serving import DepthService as JaxDepthService
from supervised_dispnet_tpu.serving import ServingConfig as JaxServingConfig
from supervised_dispnet_tpu_torch.cli import serve
from supervised_dispnet_tpu_torch.data.augment import HALF_MEAN, HALF_STD, normalize_images
from supervised_dispnet_tpu_torch.models import DispNetS, get_disp_net
from supervised_dispnet_tpu_torch.serving import DepthService, ServingConfig, pick_bucket
from supervised_dispnet_tpu_torch.utils.convert import dispnet_from_jax
from supervised_dispnet_tpu_torch.utils.image_io import write_png
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

H, W = 32, 64
TIMEOUT = 60.0


@pytest.fixture(scope="module")
def model():
    return get_disp_net("dispnet", seed=3, device="cpu").eval()


def _service(model, buckets=(2, 4), **kw):
    return DepthService(model, ServingConfig(img_height=H, img_width=W, buckets=buckets, **kw),
                        device="cpu")


def _expected(model, images):
    """The offline forward of float images in [0, 1]: (N, H, W) depth."""
    x = torch.from_numpy(np.asarray(images, np.float32))
    with torch.no_grad():
        disp = model(normalize_images(x, HALF_MEAN, HALF_STD))[0][..., 0]
    return (1.0 / disp.clamp(min=1e-6)).numpy()


def _images(seed, n):
    return np.random.default_rng(seed).random((n, H, W, 3), np.float32)


def test_predict_matches_jax_depth_service():
    jmodel = JaxDispNetS()
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(  # flax inits biases at 0: make them count
        lambda x: x + 0.05 * rng.standard_normal(x.shape).astype(np.float32),
        jax.device_get(variables["params"]))
    cfg = dict(img_height=H, img_width=W, buckets=(2, 4))
    jsvc = JaxDepthService(jmodel, {"params": params}, JaxServingConfig(**cfg))
    port = DispNetS()
    port.load_state_dict(dispnet_from_jax(params), strict=True)
    svc = DepthService(port, ServingConfig(**cfg), device="cpu")
    for imgs in (_images(1, 3), np.random.default_rng(2).integers(0, 256, (5, H, W, 3),
                                                                   dtype=np.uint8)):
        np.testing.assert_allclose(svc.predict(imgs), jsvc.predict(imgs), rtol=1e-3, atol=2e-4)


def test_pick_bucket_and_bucket_order():
    assert pick_bucket(1, (1, 8, 64)) == 1
    assert pick_bucket(2, (1, 8, 64)) == 8
    assert pick_bucket(8, (1, 8, 64)) == 8
    assert pick_bucket(65, (1, 8, 64)) == 64  # the caller chunks
    with pytest.raises(ValueError, match="sorted"):
        DepthService(DispNetS(), ServingConfig(buckets=(8, 1)), device="cpu")


def test_predict_pads_chunks_and_takes_uint8(model):
    """N=3 pads to bucket 4; N=5 with buckets (2,) runs 2 + 2 + 1 (padded);
    uint8 images equal their float32 / 255."""
    imgs = _images(3, 5)
    got = _service(model).predict(imgs[:3])
    assert got.shape == (3, H, W)
    np.testing.assert_allclose(got, _expected(model, imgs[:3]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_service(model, buckets=(2,)).predict(imgs),
                               _expected(model, imgs), rtol=1e-6, atol=1e-6)
    u8 = np.random.default_rng(4).integers(0, 256, (1, H, W, 3), dtype=np.uint8)
    np.testing.assert_allclose(_service(model).predict(u8[0]),
                               _expected(model, u8.astype(np.float32) / 255.0),
                               rtol=1e-6, atol=1e-6)


def test_submit_micro_batches_from_many_threads(model):
    """8 threads submit 2 images each, floats and uint8 mixed; each answer is
    its image's offline forward."""
    svc = _service(model)
    svc.warmup()
    rng = np.random.default_rng(5)
    imgs = [rng.random((H, W, 3), np.float32) if i % 2 else
            rng.integers(0, 256, (H, W, 3), dtype=np.uint8) for i in range(16)]
    results = {}

    def worker(k):
        futs = [(i, svc.submit(imgs[i])) for i in (2 * k, 2 * k + 1)]
        results.update({i: f.result(timeout=TIMEOUT) for i, f in futs})

    with svc:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
        assert not any(t.is_alive() for t in threads)
    assert sorted(results) == list(range(16))
    for i, im in enumerate(imgs):
        f = im.astype(np.float32) / 255.0 if im.dtype == np.uint8 else im
        np.testing.assert_allclose(results[i], _expected(model, f[None])[0], rtol=1e-6,
                                   atol=1e-6)


def test_submit_refuses_bad_shapes_and_a_stopped_service(model):
    svc = _service(model)
    with pytest.raises(RuntimeError, match="not started"):
        svc.submit(np.zeros((H, W, 3), np.float32))
    with svc:
        with pytest.raises(ValueError, match="expected"):
            svc.submit(np.zeros((H + 1, W, 3), np.float32))
    with pytest.raises(ValueError, match="expected"):
        svc.predict(np.zeros((2, H, W, 4), np.float32))


def test_stop_answers_the_queue_and_restarts(model):
    svc = _service(model)
    with svc:
        futs = [svc.submit(im) for im in _images(6, 5)]
    assert all(f.done() for f in futs)  # stop() answered every accepted request
    assert [f.result(timeout=TIMEOUT).shape for f in futs] == [(H, W)] * 5
    svc.stop()  # idempotent
    with svc:
        assert svc.submit(_images(7, 1)[0]).result(timeout=TIMEOUT).shape == (H, W)


class _Gate(torch.nn.Module):
    """The model behind a gate: a forward waits until the gate opens, so
    that a test can fill the queue behind a running batch."""

    def __init__(self, inner):
        super().__init__()
        self.inner = inner
        self.entered, self.open = threading.Event(), threading.Event()

    def forward(self, x):
        self.entered.set()
        assert self.open.wait(TIMEOUT)
        return self.inner(x)


def test_backpressure_sheds_load_when_the_queue_is_full(model):
    gate = _Gate(model)
    svc = _service(gate, buckets=(1,), max_queue=2)
    img = np.zeros((H, W, 3), np.float32)
    with svc:
        first = svc.submit(img)
        assert gate.entered.wait(TIMEOUT)  # the dispatcher holds the first
        queued = [svc.submit(img), svc.submit(img)]
        with pytest.raises(RuntimeError, match="queue full"):
            svc.submit(img)
        gate.open.set()
        assert all(f.result(timeout=TIMEOUT).shape == (H, W) for f in [first, *queued])


def test_a_cancelled_request_leaves_the_dispatcher_alive(model):
    """A future cancelled while queued is skipped (the JAX dispatcher dies
    on it, ``ROADMAP.md`` C5); the requests beside it and after it are
    answered."""
    gate = _Gate(model)
    svc = _service(gate, buckets=(1, 2))
    imgs = _images(8, 4)
    with svc:
        first = svc.submit(imgs[0])
        assert gate.entered.wait(TIMEOUT)
        cancelled, kept = svc.submit(imgs[1]), svc.submit(imgs[2])
        assert cancelled.cancel()
        gate.open.set()
        assert first.result(timeout=TIMEOUT).shape == (H, W)
        np.testing.assert_allclose(kept.result(timeout=TIMEOUT),
                                   _expected(model, imgs[2:3])[0], rtol=1e-6, atol=1e-6)
        late = svc.submit(imgs[3])
        np.testing.assert_allclose(late.result(timeout=TIMEOUT),
                                   _expected(model, imgs[3:4])[0], rtol=1e-6, atol=1e-6)
        assert cancelled.cancelled()


def test_submit_racing_stop_is_answered_or_refused(model):
    """Threads submit while another stops the service (the JAX service can
    lose such a request, ``ROADMAP.md`` C5): after ``stop`` returns every
    accepted future is done, and every submit either got a future or
    ``RuntimeError``. Switching threads every 10 µs makes the race likely."""
    svc = _service(model, buckets=(1, 2), max_wait_ms=0.5)
    img = _images(9, 1)[0]
    accepted, refused = [], []
    lock = threading.Lock()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        svc.start()

        def worker():
            for _ in range(20):
                try:
                    f = svc.submit(img)
                except RuntimeError:
                    with lock:
                        refused.append(1)
                else:
                    with lock:
                        accepted.append(f)

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        svc.stop()
        for t in threads:
            t.join(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(accepted) + len(refused) == 160
    assert all(f.done() for f in accepted)
    assert all(f.result(timeout=TIMEOUT).shape == (H, W) for f in accepted)


def test_from_checkpoint_serves_fcrn_depth_as_it_is(tmp_path):
    """``from_checkpoint('fcrn')`` turns on ``direct_depth``: the answer is
    the network's map, not its inverse; ``fused_upsample`` (the default)
    does not apply to it."""
    net = get_disp_net("fcrn", seed=1, device="cpu").eval()
    torch.save({"state_dict": net.state_dict()}, tmp_path / "fcrn.pth.tar")
    svc = DepthService.from_checkpoint(tmp_path / "fcrn.pth.tar", "fcrn",
                                       ServingConfig(img_height=H, img_width=W, buckets=(1,)),
                                       device="cpu")
    assert svc.config.direct_depth
    (tmp_path / "fcrn.pth.tar").unlink()
    img = _images(10, 1)
    with torch.no_grad():
        want = net(normalize_images(torch.from_numpy(img), HALF_MEAN, HALF_STD))[..., 0]
    np.testing.assert_allclose(svc.predict(img), want.numpy(), rtol=1e-6, atol=1e-6)


@pytest.fixture
def server(model, tmp_path):
    """``cli/serve.py`` on a free localhost port, serving the module's
    DispNetS; shut down after the test."""
    torch.save({"state_dict": model.state_dict()}, tmp_path / "d.pth.tar")
    httpd, svc = serve.make_server([
        "--pretrained", str(tmp_path / "d.pth.tar"), "--network", "dispnet",
        "--img-height", str(H), "--img-width", str(W), "--buckets", "1,2", "--port", "0",
        "--device", "cpu"])
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    svc.stop()
    thread.join(timeout=TIMEOUT)


def _post(url, body):
    req = urllib.request.Request(f"{url}/depth", data=body, method="POST")
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return r.status, r.read()


def test_http_server_answers_png_and_refuses_other_bodies(server, model, tmp_path):
    with urllib.request.urlopen(f"{server}/healthz", timeout=TIMEOUT) as r:
        assert (r.status, r.read()) == (200, b"ok")
    frame = np.random.default_rng(11).integers(0, 256, (75, 150, 3), dtype=np.uint8)
    write_png(tmp_path / "f.png", frame, filter_type=4)
    status, body = _post(server, (tmp_path / "f.png").read_bytes())
    depth = np.load(io.BytesIO(body))
    from supervised_dispnet_tpu_torch.data.image_resize import resize_area_uint8

    want = _expected(model, resize_area_uint8(frame, H, W)[None].astype(np.float32) / 255.0)
    assert status == 200 and depth.dtype == np.float32
    np.testing.assert_allclose(depth, want[0], rtol=1e-6, atol=1e-6)
    small = tmp_path / "small.png"
    write_png(small, frame[:16, :32])
    for bad, why in ((b"\xff\xd8\xff\xe0 a JPEG", "only PNG"),
                     (small.read_bytes(), "smaller than the network input")):
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(server, bad)
        assert err.value.code == 400 and why in err.value.reason
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve.make_server(["--pretrained", "x.pth.tar", "--int8", "--device", "cpu"])

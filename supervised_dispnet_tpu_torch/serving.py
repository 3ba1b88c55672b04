"""Online serving: dynamic micro-batching over fixed batch buckets. The port
of ``supervised_dispnet_tpu/serving.py``.

- **Buckets.** A batch is padded to the smallest configured bucket
  (default ``(1, 8, 64)``) and chunked past the largest, so the card sees a
  fixed set of shapes and ``warmup()`` can run each of them (cuDNN picks
  its algorithms, the caching allocator grows) before traffic arrives.
- **Dynamic micro-batching.** A dispatcher thread drains the request
  queue, waiting at most ``max_wait_ms`` for co-arriving requests.
- **One forward per micro-batch**, normalisation on the card, in full fp32
  under ``torch.inference_mode()``; the host stacks, pads and reads back.

Every accepted request is answered: a cancelled future is skipped without
stopping the dispatcher, and ``submit`` either enqueues a request ahead of
``stop``'s end marker or raises ``RuntimeError``, so none is left pending.

Usage::

    service = DepthService.from_checkpoint("ckpt.pth.tar", "disp_res_50")
    service.warmup()
    with service:
        depth = service.submit(image_hwc_uint8).result(timeout=5.0)

Runs on the card unless ``device='cpu'`` is given.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections.abc import Sequence
from concurrent.futures import Future
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from supervised_dispnet_tpu_torch.data.augment import (
    HALF_MEAN, HALF_STD, IMAGENET_MEAN, IMAGENET_STD, normalize_images)
from supervised_dispnet_tpu_torch.utils.device import resolve_device, set_fp32_math

INT8_WHERE = "ROADMAP.md Queue A5 (int8 serving)"


@dataclass(frozen=True)
class ServingConfig:
    img_height: int = 128
    img_width: int = 416
    buckets: tuple[int, ...] = (1, 8, 64)
    max_wait_ms: float = 2.0
    max_queue: int = 1024  # backpressure: submit() raises when exceeded
    int8: bool = False
    percentile: float | None = 99.9
    imagenet_normalization: bool = False
    fused_upsample: bool = True
    direct_depth: bool = False  # FCRN emits metric depth, not disparity


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (the largest if n exceeds them all: the caller
    chunks)."""
    for b in buckets:
        if b >= n:
            return b
    return max(buckets)


@dataclass
class _Request:
    image: np.ndarray
    future: Future = field(default_factory=Future)


def _stack(images: Sequence[np.ndarray]) -> np.ndarray:
    """One batch of images: uint8 if all are, else float32 with the uint8
    ones scaled to [0, 1]."""
    if all(im.dtype == np.uint8 for im in images):
        return np.stack(images)
    return np.stack([im.astype(np.float32) / 255.0 if im.dtype == np.uint8
                     else im.astype(np.float32) for im in images])


class DepthService:
    """Depth inference service with dynamic micro-batching over ``model``, a
    registry network with its weights loaded (see ``from_checkpoint``), on
    ``device``."""

    def __init__(self, model: torch.nn.Module, config: ServingConfig = ServingConfig(),
                 device: str | torch.device = "cuda"):
        if not config.buckets or list(config.buckets) != sorted(set(config.buckets)):
            raise ValueError(f"buckets must be sorted unique: {config.buckets}")
        if config.int8:
            raise NotImplementedError(f"int8 serving is not ported yet; see {INT8_WHERE}")
        self.config = config
        self.device = resolve_device(device)
        set_fp32_math()
        self.model = model.to(self.device).eval()
        mean, std = ((IMAGENET_MEAN, IMAGENET_STD) if config.imagenet_normalization
                     else (HALF_MEAN, HALF_STD))
        self._mean = torch.tensor(mean, device=self.device)
        self._std = torch.tensor(std, device=self.device)
        self._queue: queue.Queue[_Request | None] = queue.Queue(maxsize=config.max_queue)
        self._thread: threading.Thread | None = None
        # held while submit() enqueues and while stop() closes the door, so
        # every accepted request is ahead of stop()'s end marker
        self._lock = threading.Lock()
        self._accepting = False

    @classmethod
    def from_checkpoint(cls, path: str | Path, network: str = "disp_res_50",
                        config: ServingConfig = ServingConfig(),
                        device: str | torch.device = "cuda") -> DepthService:
        """Build from a ``.pth.tar`` (the eval CLI's loader). ``fcrn`` turns
        on ``direct_depth``; ``fused_upsample`` applies to disp_res* and
        disp_vgg_bn."""
        from supervised_dispnet_tpu_torch.cli.test_disp import load_model

        device = resolve_device(device)
        fused = config.fused_upsample and network.startswith(("disp_res", "disp_vgg"))
        model = load_model(path, network, fused_upsample=fused, device=device)
        if network == "fcrn" and not config.direct_depth:
            config = dataclasses.replace(config, direct_depth=True)
        return cls(model, config, device=device)

    # -- host-side preprocessing --------------------------------------------

    def _prep(self, images: np.ndarray) -> np.ndarray:
        """HWC or NHWC, uint8 (sent as it is, a quarter of the bytes) or float
        in [0, 1] (sent as float32) -> NHWC of the configured size."""
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[None]
        H, W = self.config.img_height, self.config.img_width
        if images.ndim != 4 or images.shape[1:] != (H, W, 3):
            raise ValueError(
                f"expected ({H}, {W}, 3) images, got {images.shape}; resize on "
                "the client or change ServingConfig")
        if images.dtype != np.uint8:
            images = images.astype(np.float32, copy=False)
        return np.ascontiguousarray(images)

    def _forward(self, x: np.ndarray) -> np.ndarray:
        """One padded batch through the model: (b, H, W) depth on the host."""
        t = torch.from_numpy(x)
        if self.device.type == "cuda":
            t = t.pin_memory()
        with torch.inference_mode():
            t = t.to(self.device, non_blocking=True).to(torch.float32)
            if x.dtype == np.uint8:
                t = t / 255.0
            out = self.model(normalize_images(t, self._mean, self._std))
            out = (out[0] if isinstance(out, list) else out)[..., 0]
            if not self.config.direct_depth:
                out = 1.0 / out.clamp(min=1e-6)
            return out.cpu().numpy()

    # -- synchronous batch API ----------------------------------------------

    def predict(self, images: np.ndarray) -> np.ndarray:
        """Synchronous: (N, H, W, 3) or (H, W, 3) -> (N, H, W) depth. Pads to
        the smallest bucket; chunks batches beyond the largest."""
        x = self._prep(images)
        outs = []
        top = max(self.config.buckets)
        for c0 in range(0, x.shape[0], top):
            chunk = x[c0:c0 + top]
            b = pick_bucket(chunk.shape[0], self.config.buckets)
            if chunk.shape[0] < b:
                padded = np.zeros((b, *chunk.shape[1:]), chunk.dtype)
                padded[:chunk.shape[0]] = chunk
                chunk = padded
            outs.append(self._forward(chunk)[:min(top, x.shape[0] - c0)])
        return np.concatenate(outs)

    def warmup(self) -> None:
        """Run every bucket, readback included, before traffic arrives."""
        H, W = self.config.img_height, self.config.img_width
        for b in self.config.buckets:
            self._forward(np.zeros((b, H, W, 3), np.uint8))

    # -- async micro-batching API -------------------------------------------

    def submit(self, image: np.ndarray) -> Future:
        """Enqueue one (H, W, 3) image; the future resolves to (H, W) depth.
        Raises ``RuntimeError`` when the service is not running or its queue
        is full (shed load), ``ValueError`` for a wrong shape."""
        image = np.asarray(image)
        H, W = self.config.img_height, self.config.img_width
        if image.shape != (H, W, 3):
            # refused here, so a malformed request cannot poison its batch
            raise ValueError(f"expected ({H}, {W}, 3) image, got {image.shape}")
        req = _Request(self._prep(image)[0])
        with self._lock:
            if not self._accepting:
                raise RuntimeError("service not started (use `with service:` or "
                                   "service.start())")
            try:
                self._queue.put_nowait(req)
            except queue.Full:
                raise RuntimeError(
                    f"serving queue full ({self.config.max_queue} pending); shed load "
                    "or raise ServingConfig.max_queue") from None
        return req.future

    def start(self) -> DepthService:
        with self._lock:
            if self._thread is None:
                self._thread = threading.Thread(target=self._dispatch_loop, daemon=True)
                self._thread.start()
                self._accepting = True
        return self

    def stop(self) -> None:
        """Answer every accepted request, then end the dispatcher. Requests
        submitted after this call began are refused with ``RuntimeError``."""
        with self._lock:
            thread, self._thread = self._thread, None
            self._accepting = False
        if thread is None:
            return
        while True:  # behind every accepted request
            try:
                self._queue.put(None, timeout=1.0)
                break
            except queue.Full:  # the dispatcher is draining
                if not thread.is_alive():
                    break
        thread.join()
        # a dispatcher that died leaves requests behind: refuse them
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            if req is not None and req.future.set_running_or_notify_cancel():
                req.future.set_exception(RuntimeError("service stopped"))

    __enter__ = start

    def __exit__(self, *exc) -> None:
        self.stop()

    def _dispatch_loop(self) -> None:
        top = max(self.config.buckets)
        wait_s = self.config.max_wait_ms / 1e3
        while True:
            req = self._queue.get()
            if req is None:
                return
            batch = [req]
            # drain co-arriving requests up to the largest bucket, waiting at
            # most max_wait_ms past the first arrival
            deadline = time.monotonic() + wait_s
            while len(batch) < top:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is None:
                    self._finish(batch)
                    return
                batch.append(nxt)
            self._finish(batch)

    def _finish(self, batch: list[_Request]) -> None:
        # a future cancelled while queued is skipped: set_result on it would
        # raise and end the dispatcher
        live = [r for r in batch if r.future.set_running_or_notify_cancel()]
        if not live:
            return
        try:
            depths = self.predict(_stack([r.image for r in live]))
        except Exception as e:  # answered to the callers, the loop goes on
            for r in live:
                r.future.set_exception(e)
            return
        for r, d in zip(live, depths):
            r.future.set_result(d)

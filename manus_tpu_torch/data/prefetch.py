"""A background thread that keeps a few batches ready ahead of the step,
and the host-side batch assembly of the BRICS dynamic loader.

The batches are sampled by the trainer (device gathers from its image
cache, or the dataset's get_batch when there is none), so the thread
first makes the trainer's device current. CUDA work from the thread goes
to that device's current stream, which the training loop uses as well,
so a gathered batch is ready, in stream order, before any step that
reads it.

assemble_batch_native pastes a frame's RGBA bbox crops into full frames,
composites them over the background and box-downscales them in the C++
library of csrc/image_ops.cpp (built with the host compiler at first
use); a failed build or a non-zero return raises. assemble_batch_numpy is
the same arithmetic in numpy, for the tests.
"""
from __future__ import annotations

import ctypes
import queue
import threading
from typing import Callable, Optional

import numpy as np
import torch

from manus_tpu_torch.utils import cuda_build, trace

ASSEMBLE_THREADS = 4
_SIGNATURES = {"assemble_batch": ([
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int], ctypes.c_int)}


def _checked(crops, bboxes, height: int, width: int, downscale: int):
    """The crops as contiguous uint8 [h, w, 4] arrays matching their
    bboxes ([V, 4] int32 xmin, ymin, xmax, ymax), or ValueError."""
    bboxes = np.ascontiguousarray(bboxes, np.int32).reshape(-1, 4)
    if len(crops) != len(bboxes):
        raise ValueError(f"{len(crops)} crops for {len(bboxes)} bboxes")
    if downscale < 1 or height % downscale or width % downscale:
        raise ValueError(f"downscale {downscale} does not divide "
                         f"{width}x{height}")
    out = []
    for crop, (x0, y0, x1, y1) in zip(crops, bboxes):
        crop = np.ascontiguousarray(crop)
        want = (max(int(y1 - y0), 0), max(int(x1 - x0), 0), 4)
        if crop.dtype != np.uint8 or crop.shape != want:
            raise ValueError(f"crop {crop.shape} {crop.dtype} for bbox "
                             f"[{x0},{y0},{x1},{y1}]: want {want} uint8")
        out.append(crop)
    return out, bboxes


def assemble_batch_native(crops, bboxes, height: int, width: int, bg,
                          downscale: int = 1,
                          n_threads: int = ASSEMBLE_THREADS):
    """Paste V RGBA uint8 crops at their bboxes (clipped to the frame)
    into height x width frames over `bg` ([3]), composite by alpha, and
    box-downscale by the integer `downscale`, in csrc/image_ops.cpp.
    Returns (rgb [V, H/k, W/k, 3], mask [V, H/k, W/k, 1]) float32."""
    crops, bboxes = _checked(crops, bboxes, height, width, downscale)
    lib = cuda_build.load("image_ops", _SIGNATURES)
    v = len(crops)
    flat = np.concatenate([c.reshape(-1) for c in crops]) if v else \
        np.zeros(0, np.uint8)
    offsets = np.zeros(v, np.int64)
    if v:
        offsets[1:] = np.cumsum([c.size for c in crops])[:-1]
    h2, w2 = height // downscale, width // downscale
    rgb = np.empty((v, h2, w2, 3), np.float32)
    mask = np.empty((v, h2, w2, 1), np.float32)
    bg = np.ascontiguousarray(bg, np.float32).reshape(3)
    ret = lib.assemble_batch(
        flat.ctypes.data, offsets.ctypes.data, bboxes.ctypes.data, v,
        height, width, downscale, bg.ctypes.data, rgb.ctypes.data,
        mask.ctypes.data, n_threads)
    if ret != 0:
        raise RuntimeError(f"assemble_batch returned {ret}")
    assemble_batch_native.calls += 1
    return rgb, mask


assemble_batch_native.calls = 0


def assemble_batch_numpy(crops, bboxes, height: int, width: int, bg,
                         downscale: int = 1):
    """assemble_batch_native's arithmetic in numpy (float32, a crop
    clipped to the frame as the C++ clips it)."""
    crops, bboxes = _checked(crops, bboxes, height, width, downscale)
    v = len(crops)
    bg = np.asarray(bg, np.float32).reshape(3)
    rgb = np.empty((v, height, width, 3), np.float32)
    rgb[:] = bg
    mask = np.zeros((v, height, width, 1), np.float32)
    inv255 = np.float32(1.0 / 255.0)
    for i, (crop, (x0, y0, x1, y1)) in enumerate(zip(crops, bboxes)):
        cx0, cy0 = max(int(x0), 0), max(int(y0), 0)
        cx1, cy1 = min(int(x1), width), min(int(y1), height)
        if cx1 <= cx0 or cy1 <= cy0:
            continue
        c = crop[cy0 - y0:cy1 - y0, cx0 - x0:cx1 - x0].astype(np.float32)
        a = c[..., 3:] * inv255
        rgb[i, cy0:cy1, cx0:cx1] = c[..., :3] * inv255 * a + bg * (1 - a)
        mask[i, cy0:cy1, cx0:cx1] = a
    if downscale > 1:
        k, h2, w2 = downscale, height // downscale, width // downscale
        rgb = rgb.reshape(v, h2, k, w2, k, 3).sum((2, 4)) * np.float32(
            1.0 / (k * k))
        mask = mask.reshape(v, h2, k, w2, k, 1).sum((2, 4)) * np.float32(
            1.0 / (k * k))
    return rgb.astype(np.float32), mask.astype(np.float32)


class PrefetchLoader:
    """Runs `sample_fn` in a background thread, keeping up to `depth`
    batches ready. An exception in the thread is raised again by the next
    `__next__`; `close` stops and joins the thread. `n_put` counts the
    batches the thread has put and `n_got` those `__next__` has returned:
    with one producer and a FIFO queue, the n-th batch put (a
    `prefetch.sample` span with seq n, utils/trace.py) is the n-th
    received."""

    def __init__(self, sample_fn: Callable[[], object], depth: int = 2,
                 device=None):
        self._sample = sample_fn
        self._device = None if device is None else torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self.n_put = self.n_got = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            if self._device is not None and self._device.type == "cuda":
                torch.cuda.set_device(self._device)
            while not self._stop.is_set():
                with trace.span("prefetch.sample", seq=self.n_put):
                    batch = self._sample()
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
                        self.n_put += 1
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # raised again by __next__
            self._exc = e

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                batch = self._q.get(timeout=0.1)
            except queue.Empty:
                if self._exc is not None:
                    raise self._exc
                if not self._thread.is_alive():
                    raise StopIteration
            else:
                self.n_got += 1
                return batch

    def close(self):
        self._stop.set()
        self._thread.join()

"""A background thread that keeps a few batches ready ahead of the step.

The batches are sampled by the trainer (device gathers from its image
cache), so the thread first makes the trainer's device current. CUDA
work from the thread goes to that device's current stream, which the
training loop uses as well, so a gathered batch is ready, in stream
order, before any step that reads it.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Optional

import torch


class PrefetchLoader:
    """Runs `sample_fn` in a background thread, keeping up to `depth`
    batches ready. An exception in the thread is raised again by the next
    `__next__`; `close` stops and joins the thread."""

    def __init__(self, sample_fn: Callable[[], object], depth: int = 2,
                 device=None):
        self._sample = sample_fn
        self._device = None if device is None else torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._exc: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        try:
            if self._device is not None and self._device.type == "cuda":
                torch.cuda.set_device(self._device)
            while not self._stop.is_set():
                batch = self._sample()
                while not self._stop.is_set():
                    try:
                        self._q.put(batch, timeout=0.1)
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
                return self._q.get(timeout=0.1)
            except queue.Empty:
                if self._exc is not None:
                    raise self._exc
                if not self._thread.is_alive():
                    raise StopIteration

    def close(self):
        self._stop.set()
        self._thread.join()

"""Micro-batching prediction server (counterpart of `coastline/infer/server.py`,
same behaviour).

  * requests enqueue (H, W, 3) uint8 images and get a Future back;
  * a collector thread drains the queue up to `batch_size`, waiting at most
    `max_delay_ms` once it holds at least one request, then pads the partial
    batch to the fixed batch shape, so the model always sees one shape;
  * the padded batch runs the extractor's normalize + forward + argmax and
    the masks are scattered back to the futures.

An idle server adds at most `max_delay_ms` before it flushes a partial
batch; a saturated one runs back-to-back full batches.
"""

import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional, Sequence

import numpy as np


class BatchedPredictor:
    """Wrap a `predict_masks_batch(np.uint8[N,H,W,3]) -> np.uint8[N,H,W]`
    callable (e.g. `CoastlineExtractor.predict_masks_batch`) behind a
    micro-batching queue. Thread-safe; one batch in flight."""

    def __init__(self, predict_batch, batch_size: int = 8,
                 image_size: int = 512, max_delay_ms: float = 5.0):
        self._predict = predict_batch
        self.batch_size = int(batch_size)
        self.image_size = int(image_size)
        self.max_delay = max_delay_ms / 1e3
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._submit_lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # ----------------------------------------------------------- client API
    def submit(self, image_u8: np.ndarray) -> Future:
        """Enqueue one (H, W, 3) uint8 image; resolves to a (H, W) mask."""
        s = self.image_size
        if image_u8.shape != (s, s, 3) or image_u8.dtype != np.uint8:
            raise ValueError(
                f"expected uint8 ({s}, {s}, 3), got {image_u8.dtype} "
                f"{image_u8.shape}"
            )
        fut: Future = Future()
        # lock vs close(): never enqueue after the worker's final drain
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("BatchedPredictor is closed")
            self._queue.put((image_u8, fut))
        return fut

    def predict_many(self, images: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Blocking convenience: submit all, wait for all."""
        futs = [self.submit(im) for im in images]
        return [f.result() for f in futs]

    def close(self, timeout: Optional[float] = 10.0):
        with self._submit_lock:
            self._stop.set()
            self._queue.put(None)  # wake the collector
        self._worker.join(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------ collector
    def _collect(self):
        """Block for one request, then drain up to batch_size with a
        bounded extra wait so a lone request is not stuck behind the
        batch."""
        first = self._queue.get()
        if first is None:
            return []
        items = [first]
        deadline = time.monotonic() + self.max_delay  # absolute: the first
        # caller waits at most max_delay total, however requests trickle in
        while len(items) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            items.append(nxt)
        return items

    def _run(self):
        s = self.image_size
        while not self._stop.is_set() or not self._queue.empty():
            items = self._collect()
            if not items:
                continue
            batch = np.zeros((self.batch_size, s, s, 3), np.uint8)
            for i, (im, _) in enumerate(items):
                batch[i] = im
            try:
                masks = self._predict(batch)
                for i, (_, fut) in enumerate(items):
                    _resolve(fut, result=np.asarray(masks[i]))
            except Exception as e:  # propagate to every waiter in the batch
                for _, fut in items:
                    _resolve(fut, exception=e)
        # drain anything submitted during shutdown
        while not self._queue.empty():
            item = self._queue.get_nowait()
            if item is not None:
                _resolve(item[1], exception=RuntimeError("BatchedPredictor closed"))


def _resolve(fut: Future, result=None, exception=None):
    """Resolve a Future, tolerating client-side cancel()/double-resolve —
    one misbehaving waiter must never poison its batch or the worker."""
    try:
        if exception is not None:
            if not fut.done():
                fut.set_exception(exception)
        elif not fut.done():
            fut.set_result(result)
    except Exception:
        pass

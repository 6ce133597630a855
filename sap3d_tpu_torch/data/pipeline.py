"""Frame decode, preprocessing and the threaded clip loader.

Copied from ``sap3d_tpu/data/pipeline.py`` (``imread_checked``,
``preprocess_frame``, ``preprocess_density``, ``FrameCache``,
``decode_clip``, ``ClipLoader``, with its per-process partition of the
clips for data parallel).  ``cv2`` is imported inside the
functions that use it: the GPU host need not have OpenCV to run the model.

Preprocessing order matters for parity: frames are read BGR, flipped to
RGB, promoted to float, resized to 112, mean-subtracted with the RGB mean
[90, 102, 98] and divided by 255.  Density maps are read grayscale, resized
as uint8 and divided by 255.  The test-mode variant resizes densities to
(960, 1080) and keeps fixations at native resolution.

``ClipLoader`` decodes clips on a thread pool in submission order (so batch
composition is deterministic), shuffles the clip list per epoch with a
seed, drops each epoch's remainder, and keeps a bounded window of decoded
batches ahead of the consumer.
"""

from __future__ import annotations

import os
import queue
import random
import threading
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Sequence

import numpy as np

from sap3d_tpu_torch.data.indexer import ClipPaths

# RGB-order mean (the reference's BGR [98, 102, 90] reversed).
_RGB_MEAN = np.array([90.0, 102.0, 98.0], dtype=np.float32)


def imread_checked(path: str, flags: int) -> np.ndarray:
    """cv2.imread that raises, naming the file, instead of returning None."""
    import cv2

    img = cv2.imread(path, flags)
    if img is None:
        if os.path.exists(path):
            raise ValueError(
                f"cv2 could not decode {path!r} (file exists but is "
                "corrupt or not a supported image format)"
            )
        raise FileNotFoundError(f"cv2 could not decode {path!r}: no such file")
    return img


def preprocess_frame(bgr: np.ndarray, size: int = 112) -> np.ndarray:
    """BGR uint8 frame -> float32 [size, size, 3]: RGB flip, float promote,
    bilinear resize, mean-subtract, /255.  Resizing before the
    mean-subtract equals the reference order up to float rounding, since
    bilinear interpolation is linear."""
    import cv2

    rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    fl = cv2.multiply(rgb, (1.0, 1.0, 1.0, 1.0), dtype=cv2.CV_32F)
    small = cv2.resize(fl, (size, size), interpolation=cv2.INTER_LINEAR)
    return (small - _RGB_MEAN) * np.float32(1.0 / 255.0)


def preprocess_density(gray: np.ndarray, size: int | tuple[int, int] = 112) -> np.ndarray:
    """Grayscale density map -> float32, resized (as uint8, with its
    rounding), /255."""
    import cv2

    if isinstance(size, int):
        size = (size, size)
    im = cv2.resize(gray, size, interpolation=cv2.INTER_LINEAR)
    return im.astype(np.float32) * np.float32(1.0 / 255.0)


class FrameCache:
    """Thread-safe LRU cache of decoded and preprocessed frames: with
    overlap 15, consecutive clips share 15 of their 16 frames."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self._data: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get_or_decode(self, key: tuple, decode) -> np.ndarray:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.hits += 1
                return self._data[key]
        value = decode()  # outside the lock (cv2 releases the GIL)
        value.flags.writeable = False
        with self._lock:
            self.misses += 1
            self._data[key] = value
            self._data.move_to_end(key)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
        return value


def decode_clip(clip: ClipPaths, size: int = 112, test_mode: bool = False,
                cache: FrameCache | None = None) -> tuple[np.ndarray, ...]:
    """One clip: frames [T, H, W, 3], densities [T, h, w] (and fixations in
    test mode, with densities at (960, 1080))."""
    import cv2

    def frame(p):
        dec = lambda: preprocess_frame(imread_checked(p, cv2.IMREAD_COLOR), size)  # noqa: E731
        return cache.get_or_decode(("f", p, size), dec) if cache else dec()

    dsize = (960, 1080) if test_mode else size

    def density(p):
        dec = lambda: preprocess_density(  # noqa: E731
            imread_checked(p, cv2.IMREAD_GRAYSCALE), dsize)
        return cache.get_or_decode(("d", p, dsize), dec) if cache else dec()

    frames = np.stack([frame(p) for p in clip.frames])
    densities = np.stack([density(p) for p in clip.densities])
    if not test_mode:
        return frames, densities
    fixations = np.stack(
        [imread_checked(p, cv2.IMREAD_GRAYSCALE).astype(np.float32) / 255.0
         for p in clip.fixations])
    return frames, densities, fixations


_EPOCH_END = object()  # per-epoch remainder drop boundary
_DONE = object()       # clean end of stream
_STOPPED = object()    # shutdown requested


class _Error:
    """A worker exception, re-raised on the consumer thread."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class _LoaderIter:
    """One live iteration of a ClipLoader: feeder, decode pool, producer.

    The window of in-flight decodes is bounded, so a stalled consumer stops
    the feeder before it submits more work; ``close()`` sets a stop event
    that every blocking queue operation re-checks every 0.1 s."""

    def __init__(self, loader: "ClipLoader"):
        self.loader = loader
        self._stop = threading.Event()
        self._buf: queue.Queue = queue.Queue(maxsize=loader.prefetch * loader.batch_size)
        self._window: queue.Queue = queue.Queue(
            maxsize=loader.num_threads + loader.prefetch * loader.batch_size)
        self._producer = threading.Thread(target=self._produce,
                                          name="clip-loader-producer", daemon=True)
        self._producer.start()

    def _qput(self, q: queue.Queue, item) -> bool:
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _qget(self, q: queue.Queue):
        while not self._stop.is_set():
            try:
                return q.get(timeout=0.1)
            except queue.Empty:
                pass
        return _STOPPED

    def _produce(self):
        loader = self.loader
        try:
            with ThreadPoolExecutor(loader.num_threads) as pool:

                def feed():
                    # submit in order, consume in order
                    for item in loader._clip_stream():
                        if self._stop.is_set():
                            return
                        if item is not _EPOCH_END:
                            item = pool.submit(loader.decode_fn, item)
                        if not self._qput(self._window, item):
                            return
                    self._qput(self._window, _DONE)

                feeder = threading.Thread(target=feed, name="clip-loader-feeder",
                                          daemon=True)
                feeder.start()
                try:
                    while True:
                        fut = self._qget(self._window)
                        if fut is _STOPPED or fut is _DONE:
                            break
                        item = fut if fut is _EPOCH_END else fut.result()
                        if not self._qput(self._buf, item):
                            break
                finally:
                    feeder.join(timeout=5.0)
        except Exception as e:  # a decode error goes to the consumer
            self._qput(self._buf, _Error(e))
            return
        self._qput(self._buf, _DONE)

    def get(self):
        """The next decoded clip or a control token; returns _DONE when the
        loader was closed or the producer died."""
        while True:
            try:
                return self._buf.get(timeout=0.1)
            except queue.Empty:
                if self._stop.is_set() or not self._producer.is_alive():
                    return _DONE

    def close(self):
        """Stop the pipeline threads; safe to call more than once."""
        self._stop.set()
        while self._producer.is_alive():
            try:
                self._buf.get_nowait()
            except queue.Empty:
                self._producer.join(timeout=0.05)


class ClipLoader:
    """Threaded, shuffling, batching clip loader with bounded prefetch.

    Yields tuples of stacked numpy arrays (frames [B, T, H, W, 3], densities
    [B, T, H, W], and fixations in test mode).  Use as a context manager, or
    call ``close()``, to stop the threads of an abandoned iteration.

    Data parallel: each of ``process_count`` ranks builds a loader with its
    ``process_index`` and the per-rank batch.  Every rank shuffles the same
    clip order with the same seed, truncates it to a multiple of the count
    and takes the strided slice ``order[process_index::process_count]``:
    the partitions are disjoint, every rank yields the same number of
    batches per epoch, and with a per-rank batch of B / N the union of the
    ranks' k-th batches is the one-process loader's k-th batch of B (rank r
    takes ``order[k B + r + N j]``).

    Over several processes the index is the global rank and the count the
    whole mesh's W.  The JAX loader partitions by process instead
    (``order[p::P]`` with a host batch of L b for L devices a host, split
    into contiguous rows per device); both give step s the clips
    ``order[W s b : W (s + 1) b]``, as a set, and the same number of steps
    per epoch.  The loss is a global sum and BN takes global-batch
    statistics, so the set, not the order of the rows, fixes the step."""

    def __init__(self, clips: Sequence[ClipPaths], batch_size: int, size: int = 112,
                 num_threads: int = 16, prefetch: int = 4, shuffle: bool = True,
                 epochs: int = 1, seed: int = 0, test_mode: bool = False,
                 decode_fn: Callable | None = None, cache_frames: int = 0,
                 process_index: int = 0, process_count: int = 1):
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} is not in "
                             f"[0, process_count {process_count})")
        self.clips = list(clips)
        self.batch_size = batch_size
        self.process_index = process_index
        self.process_count = process_count
        self.size = size
        self.num_threads = num_threads
        self.prefetch = max(1, prefetch)
        self.shuffle = shuffle
        self.epochs = epochs
        self.seed = seed
        self.test_mode = test_mode
        self.cache = FrameCache(cache_frames) if cache_frames > 0 else None
        self.decode_fn = decode_fn or (
            lambda c: decode_clip(c, self.size, self.test_mode, self.cache))
        self._iters: list[_LoaderIter] = []

    def _per_process_count(self) -> int:
        """Clips this rank sees per epoch (equal on every rank)."""
        return len(self.clips) // self.process_count

    def __len__(self) -> int:
        return (self._per_process_count() // self.batch_size) * self.epochs

    def _clip_stream(self) -> Iterator:
        rng = random.Random(self.seed)
        for _ in range(self.epochs):
            order = list(self.clips)
            if self.shuffle:
                rng.shuffle(order)
            if self.process_count > 1:
                usable = self._per_process_count() * self.process_count
                order = order[:usable][self.process_index::self.process_count]
            yield from order
            yield _EPOCH_END

    def __iter__(self) -> Iterator[tuple[np.ndarray, ...]]:
        it = _LoaderIter(self)
        self._iters.append(it)
        batch: list[tuple[np.ndarray, ...]] = []
        try:
            while True:
                item = it.get()
                if item is _DONE:
                    break
                if item is _EPOCH_END:
                    batch = []  # drop the epoch's remainder
                    continue
                if isinstance(item, _Error):
                    raise item.exc
                batch.append(item)
                if len(batch) == self.batch_size:
                    yield tuple(np.stack([b[i] for b in batch]) for i in range(len(batch[0])))
                    batch = []
        finally:
            it.close()
            if it in self._iters:
                self._iters.remove(it)

    def close(self):
        """Stop the worker threads of any live iteration (idempotent)."""
        for it in list(self._iters):
            it.close()
        self._iters.clear()

    def __enter__(self) -> "ClipLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

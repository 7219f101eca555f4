"""Host-to-device streaming for the out-of-core learners.

``DeviceFeed`` walks a sequence of keys (OVB or SGD chunks, windows of the
windowed batch VB) and yields each one's device form, in order:

* ``load(key)`` makes the host form (a chunk read from disk): in
  ``workers`` reader threads, up to ``depth`` keys ahead, or inline where
  the host form is already there;
* ``upload(host, put)`` makes the device form on a side CUDA stream, each
  ``put(a)`` giving the device tensor of one host array.  A feed built
  ``staged`` packs a key's numpy arrays into one of ``depth`` page-locked
  staging buffers that it reuses (no page-locked allocation a key) and
  copies them in one ``non_blocking`` copy, each ``put`` a view of the one
  device buffer; otherwise ``put`` copies a page-locked host tensor (the
  windowed learner pins its windows once) with ``non_blocking=True``.  An
  event recorded on the side stream after the copies is waited on by the
  compute stream before the consumer's kernels, so a copy overlaps the
  kernels of the keys before it;
* every uploaded tensor is handed to the compute stream with
  ``record_stream``, so the caching allocator reuses its memory only after
  the kernels that read it have run; and before a new key is uploaded, the
  host waits for the kernels of the key ``depth`` back, so at most
  ``depth`` keys' device forms are live at once, across the feed's calls
  too (a windowed sweep's passes follow one another).  A staging buffer
  is refilled only after its copy has run.

A reader thread's exception propagates to the consumer at its key, and the
pool is shut down in a ``finally``.  On the CPU nothing is copied: ``put``
gives the host array as a tensor.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

_ALIGN = 256  # bytes: every array of a staged key starts at a multiple
_RESERVE = 1 << 16  # bytes a staged key keeps for tensors made in upload


def pinned(a) -> torch.Tensor:
    """A host tensor of numpy array ``a`` in page-locked memory where a GPU
    is present (a non-blocking copy needs it), else a plain one."""
    t = torch.from_numpy(a)
    return t.pin_memory() if torch.cuda.is_available() else t


def _arrays(obj):
    if isinstance(obj, np.ndarray):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for o in obj:
            yield from _arrays(o)


def _aligned(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def _as_tensor(a) -> torch.Tensor:
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


class DeviceFeed:
    """Streams keys' host forms to ``device``; see the module docstring."""

    def __init__(self, device, depth: int, workers: int = 0,
                 staged: bool = False):
        self.device = torch.device(device)
        self.depth = max(1, int(depth))
        self.workers = int(workers)
        self.staged = staged
        self._side = None
        self._live = deque()  # compute-stream events of the keys yielded
        self._ring = deque()  # (staging buffer, its copy's event)

    def _staging(self, nbytes: int) -> torch.Tensor:
        """A page-locked buffer of at least ``nbytes`` whose last copy has
        run: a new one until the ring holds ``depth``, then its oldest."""
        buf = None
        if len(self._ring) >= self.depth:
            buf, copied = self._ring.popleft()
            copied.synchronize()
        if buf is None or buf.numel() < nbytes:
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return buf

    def _staged_upload(self, host, upload, made):
        need = sum(_aligned(a.nbytes) for a in _arrays(host)) + _RESERVE
        stage = self._staging(need)
        stage_np = stage.numpy()
        dev = torch.empty(need, dtype=torch.uint8, device=self.device)
        made.append(dev)
        off = 0

        def put(a):
            nonlocal off
            a = np.ascontiguousarray(
                a.numpy() if isinstance(a, torch.Tensor) else a)
            n = a.nbytes
            if off + n > need:
                raise RuntimeError("DeviceFeed: a key's arrays outgrew its "
                                   "staging buffer")
            stage_np[off:off + n] = a.reshape(-1).view(np.uint8)
            t = dev[off:off + n].view(_as_tensor(a[:0].reshape(-1)).dtype)
            off += _aligned(n)
            return t.view(a.shape)

        obj = upload(host, put)
        dev[:off].copy_(stage[:off], non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(self._side)
        self._ring.append((stage, copied))
        return obj

    def __call__(self, keys: Iterable, load: Callable,
                 upload: Callable) -> Iterator:
        keys = list(keys)
        pool = (ThreadPoolExecutor(self.workers) if self.workers and keys
                else None)
        try:
            pending = deque()
            nxt = 0

            def top_up():
                nonlocal nxt
                while pool is not None and nxt < len(keys) \
                        and len(pending) < self.depth:
                    pending.append(pool.submit(load, keys[nxt]))
                    nxt += 1

            if self.device.type != "cuda":
                for k in keys:
                    top_up()
                    host = pending.popleft().result() if pool else load(k)
                    yield upload(host, _as_tensor)
                return
            if self._side is None:
                self._side = torch.cuda.Stream(self.device)
            compute = torch.cuda.current_stream(self.device)
            live = self._live
            for k in keys:
                top_up()
                host = pending.popleft().result() if pool else load(k)
                while len(live) >= self.depth:
                    live.popleft().synchronize()
                made = []

                def put(t):
                    d = t.to(self.device, non_blocking=True)
                    made.append(d)
                    return d

                with torch.cuda.stream(self._side):
                    obj = (self._staged_upload(host, upload, made)
                           if self.staged else upload(host, put))
                    ready = torch.cuda.Event()
                    ready.record(self._side)
                compute.wait_event(ready)
                for d in made:
                    d.record_stream(compute)
                del host, made
                yield obj
                del obj
                done = torch.cuda.Event()
                done.record(compute)
                live.append(done)
        finally:
            if pool is not None:
                pool.shutdown(wait=True, cancel_futures=True)

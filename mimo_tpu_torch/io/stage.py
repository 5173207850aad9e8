"""Staging of host rows onto the card for the out-of-core engines.

The JAX package hands a host block to a jitted call and XLA copies it.
Here the copy is explicit, so it can overlap the kernels:

  * the reader thread (io.stream.Prefetcher) fills one of two pinned host
    buffers (`Stager.fill`), casting to the wire dtype on the way
    (float32, or the stream engines' `transfer_dtype`); it touches the
    card only to wait for the last copy out of the buffer it reuses;
  * the main thread (`Stager.put`) issues, on one copy stream, the
    host-to-device copy into one of two device landing buffers and then,
    still on the copy stream, the transpose into one of two float32
    (rows, capacity) buffers in the kernels' layout
    (ops.cuda_estep.kernel_xts), or the cast to the engine's dtype for
    minibatches; the current stream waits on the copy's event before
    anything reads the buffer;
  * a device buffer is written again only after the event recorded
    behind the last work that read it (`Stager.release`), and written
    first only after the work the current stream had queued when the
    buffer was allocated (the caching allocator may hand out memory that
    queued work still uses).

So block i + 1's copy runs under block i's kernel, and no buffer is
overwritten while a copy or a kernel still reads it. Buffers are sized
at first use and grow (after a synchronize) only when a larger block
comes. Pinned memory and streams exist only on CUDA: the engines stage
nothing for CPU tensors.
"""

import queue
import threading

import numpy as np
import torch

SLOTS = 2


def host_arrays(item):
    """A reader's block or batch (an array or a tuple of arrays, numpy or
    CPU tensors) as a tuple of 2-D numpy arrays."""
    item = item if isinstance(item, tuple) else (item,)
    out = []
    for a in item:
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        out.append(a.reshape(a.shape[0], -1))
    return tuple(out)


class Stager:
    """Two pinned host buffers, two device landing buffers, two device
    output buffers and one copy stream on `device`.

    `transpose=True`: rows land as the float32 (sum d_i, capacity) buffer
    of the kernels, and `put` returns its per-input (d_i, capacity) row
    views; kernel B1 reads the first nb columns through the row stride,
    so a short block needs no padding and no other shape.
    `transpose=False`: rows land as (nb, sum d_i) in `dtype`, and `put`
    returns the per-input (nb, d_i) column views."""

    def __init__(self, device, wire=torch.float32, transpose=True,
                 dtype=torch.float32):
        self.device = torch.device(device)
        self.wire, self.transpose = wire, transpose
        self.dtype = torch.float32 if transpose else dtype
        self.stream = torch.cuda.Stream(self.device)
        self._host = [None] * SLOTS
        self._copied = [None] * SLOTS
        self._free = queue.Queue()
        for s in range(SLOTS):
            self._free.put(s)
        self._closed = threading.Event()
        self._land = [None] * SLOTS
        self._out = [None] * SLOTS
        self._read = [None] * SLOTS
        self._next = 0
        self.h2d_bytes = 0

    # -- reader thread --------------------------------------------------------

    def _acquire(self):
        """A free host slot, once the last copy out of it has finished."""
        while True:
            if self._closed.is_set():
                raise RuntimeError('staging closed')
            try:
                s = self._free.get(timeout=0.1)
                break
            except queue.Empty:
                continue
        if self._copied[s] is not None:
            self._copied[s].synchronize()
        return s

    def fill(self, chunks):
        """Copy row chunks into a pinned slot: `chunks` is a list of
        tuples of 2-D host arrays (one tuple a block or a minibatch, one
        array an input), stacked by rows in order, inputs side by side.
        Returns the item (slot, rows, input widths) for `put`."""
        widths = tuple(a.shape[1] for a in chunks[0])
        nb = sum(c[0].shape[0] for c in chunks)
        s = self._acquire()
        buf = self._host[s]
        if buf is None or buf.shape[0] < nb or buf.shape[1] != sum(widths):
            buf = self._host[s] = torch.empty((nb, sum(widths)),
                                              dtype=self.wire,
                                              pin_memory=True)
        r = 0
        for chunk in chunks:
            col, rows = 0, chunk[0].shape[0]
            for a in chunk:
                buf[r:r + rows, col:col + a.shape[1]].copy_(
                    torch.from_numpy(np.ascontiguousarray(a)))
                col += a.shape[1]
            r += rows
        return s, nb, widths

    # -- main thread ----------------------------------------------------------

    def _reserve(self, d, nb, rows):
        land = self._land[d]
        if land is not None and land.shape[0] >= nb and land.shape[1] == rows:
            return
        if land is not None:              # grow: nothing may still read it
            torch.cuda.synchronize(self.device)
        self._land[d] = torch.empty((nb, rows), dtype=self.wire,
                                    device=self.device)
        self._out[d] = torch.empty((rows, nb) if self.transpose
                                   else (nb, rows), dtype=self.dtype,
                                   device=self.device)
        # the allocator hands the current stream memory that work still
        # queued on it may read or write (tensors freed on the host ahead
        # of the card); the copy stream writes the new buffers only after
        # that work
        self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def put(self, item):
        """Copy a filled slot to the next device slot on the copy stream
        and make the current stream wait for it. Returns (device slot,
        per-input views, rows); call `release(slot)` once the work that
        reads the views has been issued."""
        s, nb, widths = item
        d = self._next
        self._next = (d + 1) % SLOTS
        self._reserve(d, nb, sum(widths))
        cs = self.stream
        with torch.cuda.stream(cs):
            if self._read[d] is not None:
                cs.wait_event(self._read[d])
            land, out = self._land[d][:nb], self._out[d]
            land.copy_(self._host[s][:nb], non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(cs)
            self._copied[s] = copied
            self._free.put(s)
            if self.transpose:
                out[:, :nb].copy_(land.T)
            else:
                out[:nb].copy_(land)
            ready = torch.cuda.Event()
            ready.record(cs)
        torch.cuda.current_stream(self.device).wait_event(ready)
        self.h2d_bytes += land.numel() * land.element_size()
        if self.transpose:
            return d, tuple(torch.split(out, widths)), nb
        return d, tuple(torch.split(out[:nb], widths, 1)), nb

    def release(self, d):
        """Record, on the current stream, that the work reading device
        slot d has been issued: the next copy into the slot waits for it."""
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        self._read[d] = ev

    def close(self):
        """Unblock a reader waiting for a slot (the stream is abandoned)."""
        self._closed.set()

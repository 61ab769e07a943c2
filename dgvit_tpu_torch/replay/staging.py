"""Host -> device staging: overlap replay sampling and the copy to the card
with the train step.

Counterpart of `dgvit_tpu/replay/staging.py`. The reference's learn()
blocks on sampling and host-to-device copies every step (DRL.py:375-386).
Here a background thread keeps `depth` batches in flight: while the card
runs step N, the host samples step N+1 into pinned memory and copies it to
the card on a side stream (the analogue of `jax.device_put` ahead of the
step). The consumer's stream waits on the copy's event, never the host.
With device 'cpu' the thread just hands the sampled arrays over as
tensors.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from dgvit_tpu_torch.core.device import resolve_device


class HostStager:
    """Copies dicts of numpy arrays (fixed shapes) to a device through
    pinned host buffers that are reused, `slots` sets in turn, each guarded
    by the event of its last copy. `put` returns the device tensors and
    that event (None on the CPU, where the arrays are handed over as
    tensors); copies go to `stream`, or to the current stream."""

    def __init__(self, device: Optional[Union[str, torch.device]] = None,
                 slots: int = 2, stream=None):
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._slots = [None] * slots
        self._next = 0
        self._stream = stream

    def put(self, batch: Dict[str, np.ndarray]):
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if not self._cuda:
            return host, None
        slot, self._next = self._next, (self._next + 1) % len(self._slots)
        if self._slots[slot] is None:
            self._slots[slot] = (
                {k: torch.empty_like(t).pin_memory() for k, t in host.items()},
                torch.cuda.Event())
        pinned, event = self._slots[slot]
        event.synchronize()            # the slot's previous copy has landed
        for k, t in host.items():
            pinned[k].copy_(t)
        stream = self._stream or torch.cuda.current_stream(self.device)
        with torch.cuda.stream(stream):
            out = {k: t.to(self.device, non_blocking=True)
                   for k, t in pinned.items()}
            event.record(stream)
        return out, event


class BatchPrefetcher:
    """Iterator over device-resident batches produced by `sample_fn` (a
    callable returning a dict of numpy arrays of fixed shapes)."""

    def __init__(self, sample_fn: Callable[[], Dict[str, np.ndarray]],
                 depth: int = 2,
                 device: Optional[Union[str, torch.device]] = None):
        self._sample_fn = sample_fn
        self._device = resolve_device(device)
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        # one pinned staging set per batch that can be alive at once: the
        # queued ones, the one the worker holds and the one being consumed
        side = (torch.cuda.Stream(self._device)
                if self._device.type == "cuda" else None)
        self._stager = HostStager(self._device, slots=depth + 2, stream=side)
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="BatchPrefetcher")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        while not self._stop.is_set():
            try:
                item = self._stager.put(self._sample_fn())
            except Exception as e:
                # surface the failure to the consumer instead of ending
                # the iteration with no diagnostic
                self._error = e
                self._put(None)
                return
            if not self._put(item):
                return

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._stop.is_set():
                raise StopIteration
            try:
                item = self._q.get(timeout=0.1)
                break
            except queue.Empty:
                if not self._thread.is_alive():
                    raise StopIteration from None
        if item is None:
            if self._error is not None:
                raise RuntimeError(
                    "BatchPrefetcher sample_fn failed") from self._error
            raise StopIteration
        batch, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(event)
            for t in batch.values():
                t.record_stream(stream)
        return batch

    def close(self, timeout: float = 5.0):
        """Stop the worker and wait for it (at most `timeout` seconds)."""
        self._stop.set()
        self._thread.join(timeout)

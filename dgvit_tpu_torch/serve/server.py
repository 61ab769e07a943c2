"""Micro-batching inference server for the actor's action map.

Many clients (robots, sim lanes, eval workers) submit single observations
or small batches; a single worker thread coalesces everything queued within
`max_wait_ms` into one device dispatch, pads the coalesced batch up to a
fixed bucket size (a small fixed set of batch shapes, never one per
request count), runs the action fn, and scatters the results back through
per-request futures.

The device sees few, large, fixed shapes instead of many tiny ones, and the
batching amortizes the per-dispatch cost that dominates single-frame
latency. Framework-free: a copy of the JAX package's server, fronting the
port's `serve/export.py::make_action_fn`.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import Future
from typing import Callable, Optional, Sequence

import numpy as np


class BatchingActorServer:
    """Thread-safe micro-batching wrapper around act(obs[b,...], goal[b,2]).

    act_fn is any numpy-in/numpy-out callable, such as the act of
    `serve/export.py::make_action_fn`. Buckets must be ascending; requests
    larger than the biggest bucket are split across dispatches.
    """

    def __init__(self, act_fn: Callable, max_wait_ms: float = 2.0,
                 buckets: Sequence[int] = (1, 2, 4, 8, 16, 32, 64)):
        assert list(buckets) == sorted(set(buckets)) and buckets[0] >= 1
        self._act = act_fn
        self._buckets = tuple(int(b) for b in buckets)
        self._wait_s = max_wait_ms / 1e3
        self._q: "queue.Queue" = queue.Queue()
        self._stats = {"requests": 0, "rows": 0, "dispatches": 0,
                       "padded_rows": 0}
        self._closed = threading.Event()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client API ---------------------------------------------------------
    def submit(self, obs: np.ndarray, goal: np.ndarray) -> Future:
        """Non-blocking. obs (…) or (n, …); goal matching. Resolves to the
        action array with the same leading shape as obs."""
        if self._closed.is_set():
            raise RuntimeError("server closed")
        obs = np.asarray(obs, np.float32)
        goal = np.asarray(goal, np.float32)
        single = goal.ndim == 1
        if single:
            obs, goal = obs[None], goal[None]
        assert obs.shape[0] == goal.shape[0]
        fut: Future = Future()
        self._q.put((obs, goal, single, fut))
        return fut

    def act(self, obs: np.ndarray, goal: np.ndarray,
            timeout: Optional[float] = None) -> np.ndarray:
        """Blocking convenience wrapper around submit()."""
        return self.submit(obs, goal).result(timeout)

    def stats(self) -> dict:
        s = dict(self._stats)
        s["mean_batch"] = s["rows"] / max(s["dispatches"], 1)
        return s

    def close(self, timeout: float = 10.0):
        self._closed.set()
        self._q.put(None)  # wake the worker
        self._worker.join(timeout)
        # submit() may have raced close(): a request enqueued after the
        # sentinel is never seen by the worker — fail it rather than let
        # the caller block forever on its future
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item[3].done():
                item[3].set_exception(RuntimeError("server closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker -------------------------------------------------------------
    def _collect(self):
        """Block for one request, then drain whatever arrives within the
        batching window (or until the biggest bucket is full)."""
        import time

        first = self._q.get()
        if first is None:
            return None
        batch = [first]
        rows = first[0].shape[0]
        cap = self._buckets[-1]
        deadline = time.monotonic() + self._wait_s
        while rows < cap:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                nxt = self._q.get(timeout=left)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)  # re-post the sentinel for shutdown
                break
            batch.append(nxt)
            rows += nxt[0].shape[0]
        return batch

    def _dispatch(self, obs: np.ndarray, goal: np.ndarray) -> np.ndarray:
        """Pad to the bucket grid and run; oversize batches run in
        biggest-bucket chunks."""
        n = obs.shape[0]
        cap = self._buckets[-1]
        outs = []
        for i in range(0, n, cap):
            o, g = obs[i:i + cap], goal[i:i + cap]
            m = o.shape[0]
            b = next(x for x in self._buckets if x >= m)
            if b != m:
                pad = b - m
                o = np.concatenate([o, np.zeros((pad, *o.shape[1:]), o.dtype)])
                g = np.concatenate([g, np.zeros((pad, *g.shape[1:]), g.dtype)])
                self._stats["padded_rows"] += pad
            a = np.asarray(self._act(o, g))
            outs.append(a[:m])
            self._stats["dispatches"] += 1
            self._stats["rows"] += m
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    def _run(self):
        while True:
            batch = self._collect()
            if batch is None:
                return
            obs = np.concatenate([b[0] for b in batch])
            goal = np.concatenate([b[1] for b in batch])
            try:
                actions = self._dispatch(obs, goal)
            except Exception as e:  # surface the failure to every caller
                for _, _, _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            off = 0
            for o, _, single, fut in batch:
                n = o.shape[0]
                out = actions[off:off + n]
                # a client may have cancelled its pending future (e.g. its
                # own result() timeout fired) — set_result on a cancelled/
                # done future raises InvalidStateError and would kill this
                # worker thread, orphaning every other request
                if not fut.done():
                    fut.set_result(out[0] if single else out)
                off += n
                self._stats["requests"] += 1

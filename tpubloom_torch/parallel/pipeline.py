"""Streaming insert pipeline — BASELINE config 3 (1B-key streams), the port
of ``tpubloom/parallel/pipeline.py``.

Mechanics:

* the host packs fixed-size key batches (``uint8[batch_size, key_len]``
  plus ``int32`` lengths; a short last batch is padded with ``lengths =
  -1`` rows, which set no bits and do not count) while the card inserts
  the previous ones: PyTorch's asynchronous launches are the double
  buffer, and a bounded window of completion events is the backpressure —
  after each launch the pipeline waits for the oldest of the last
  ``max_in_flight`` batches' events (``filter._completion()``), never for
  the whole device, so host-side buffers cannot pile up;
* every ``checkpoint_every`` keys the
  :class:`~tpubloom_torch.checkpoint.AsyncCheckpointer` snapshots the state
  (a copy on the card in stream order, the payload's bytes and CRC32C made
  there, one copy to a page-locked host buffer, the write on a worker
  thread) without stalling inserts, and records the stream offset in the
  checkpoint header;
* with ``prefetch > 0`` a worker thread packs the next batches into a ring
  of ``prefetch + 1`` page-locked host buffers and starts their copies to
  the card on a copy stream (an event a slot), so packing and H2D overlap
  the inserts; with ``prefetch = 0`` each batch goes through the filter's
  own ``_stage_batch``, as every other call of the port does;
* **crash recovery contract**: on restart, :func:`resume_offset` says where
  the newest checkpoint cut the stream. Replaying the source from any point
  <= that offset is safe — the insert is an idempotent OR, so at-least-once
  delivery converges to the same bits — and everything before the offset
  is guaranteed present. Tail loss is bounded by ``checkpoint_every`` plus
  one in-flight window.

The packing runs under the ``host_prep`` phase span, staging under
``h2d`` and the insert launches and fences under ``kernel``
(:mod:`tpubloom_torch.obs.context`), so a caller inside a request context
sees where a stream's time goes.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from tpubloom_torch.checkpoint import AsyncCheckpointer
from tpubloom_torch.obs import context as obs
from tpubloom_torch.utils.packing import pack_keys


class StreamInserter:
    """Feed an unbounded key stream into a filter at full device rate.

    ``prefetch > 0`` overlaps host packing and H2D staging with the
    inserts: a background thread packs the next ``prefetch`` batches and
    starts their transfers while the card inserts the current one."""

    def __init__(
        self,
        filter_obj,
        *,
        batch_size: int = 1 << 16,
        sink=None,
        checkpoint_every: int = 0,
        max_in_flight: int = 8,
        start_offset: int = 0,
        prefetch: int = 0,
    ):
        self.filter = filter_obj
        self.batch_size = batch_size
        self.max_in_flight = max_in_flight
        self.prefetch = prefetch
        self.consumed = start_offset  # keys consumed from the stream origin
        self._in_flight: collections.deque = collections.deque()
        self.checkpointer: Optional[AsyncCheckpointer] = None
        if sink is not None and checkpoint_every:
            # meta_fn samples the offset at trigger time, under the same
            # control flow as the inserts (run() is single-threaded), so the
            # recorded offset is consistent with the snapshotted bits.
            self.checkpointer = AsyncCheckpointer(
                filter_obj,
                sink,
                every_n_inserts=checkpoint_every,
                meta_fn=lambda: {"stream_offset": self._synced_offset()},
            )

    def _synced_offset(self) -> int:
        """Offset fully materialized on the device at snapshot time.

        Everything launched is captured by the snapshot: its copy in
        ``trigger()`` is queued AFTER every launched insert on the same
        stream, so ``consumed`` (all keys handed to the device) is the safe
        offset.
        """
        return self.consumed

    def _packed_batches(self, it: Iterator[bytes], limit: Optional[int]):
        """Yield ``(keys_u8, lengths, n_valid)`` fixed-shape numpy batches."""
        produced = 0
        cfg = self.filter.config
        while True:
            budget = self.batch_size
            if limit is not None:
                budget = min(budget, limit - produced)
                if budget <= 0:
                    return
            batch = []
            for key in it:
                batch.append(key)
                if len(batch) >= budget:
                    break
            if not batch:
                return
            with obs.phase("host_prep"):
                keys_u8, lengths = pack_keys(batch, cfg.key_len, key_policy=cfg.key_policy)
                if len(batch) < self.batch_size:  # static-shape padding
                    pad = self.batch_size - len(batch)
                    keys_u8 = np.pad(keys_u8, ((0, pad), (0, 0)))
                    lengths = np.pad(lengths, (0, pad), constant_values=-1)
            produced += len(batch)
            yield keys_u8, lengths, len(batch)

    def _staged(self, batches):
        """Each batch through the filter's own staging (``h2d`` span)."""
        for keys_u8, lengths, n in batches:
            d_keys, d_lengths = self.filter._stage_batch(keys_u8, lengths)
            yield d_keys, d_lengths, n

    def _prefetched(self, batches):
        """Pack on a background thread into a ring of ``prefetch + 1``
        slots, each a page-locked host buffer and a device buffer; the
        worker starts each slot's H2D copy on a copy stream and records its
        event. The consumer makes the compute stream wait that event before
        the insert that reads the slot, and hands the slot back once that
        insert is launched: the worker reuses a host buffer only after its
        copy completed, and queues a device buffer's next copy only after
        the insert that read it (a stream wait). Exceptions re-raise in the
        consumer. On the CPU the copies are plain synchronous copies and
        there are no streams or events."""
        dev = self.filter.device
        cuda = dev.type == "cuda"
        n_slots = self.prefetch + 1
        shape = (self.batch_size, self.filter.config.key_len)
        host = [(torch.empty(shape, dtype=torch.uint8, pin_memory=cuda),
                 torch.empty(self.batch_size, dtype=torch.int32, pin_memory=cuda))
                for _ in range(n_slots)]
        devb = [(torch.empty(shape, dtype=torch.uint8, device=dev),
                 torch.empty(self.batch_size, dtype=torch.int32, device=dev))
                for _ in range(n_slots)]
        copy_stream = torch.cuda.Stream(dev) if cuda else None
        copied = [None] * n_slots  # each slot's H2D event
        used = [None] * n_slots  # each slot's last insert, on the compute stream
        if cuda:
            for k, n in devb:  # written on the copy stream as well
                k.record_stream(copy_stream)
                n.record_stream(copy_stream)
        free: queue.Queue = queue.Queue()
        for s in range(n_slots):
            free.put(s)
        ready: queue.Queue = queue.Queue(maxsize=self.prefetch)
        cancel = threading.Event()
        _END, _ERR = object(), object()

        def wait_get(q):
            # a get that gives up when the consumer is gone
            while not cancel.is_set():
                try:
                    return q.get(timeout=0.1)
                except queue.Empty:
                    continue
            return None

        def put(item) -> bool:
            while not cancel.is_set():
                try:
                    ready.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def fill(s, keys_u8, lengths):
            hk, hn = host[s]
            dk, dn = devb[s]
            if not cuda:
                hk.numpy()[:] = keys_u8
                hn.numpy()[:] = lengths
                dk.copy_(hk)
                dn.copy_(hn)
                return
            if copied[s] is not None:
                copied[s].synchronize()  # the host buffer's last copy is done
            hk.numpy()[:] = keys_u8
            hn.numpy()[:] = lengths
            with torch.cuda.device(dev), torch.cuda.stream(copy_stream):
                if used[s] is not None:
                    copy_stream.wait_event(used[s])  # the insert that read it came first
                dk.copy_(hk, non_blocking=True)
                dn.copy_(hn, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(copy_stream)
            copied[s] = ev

        def worker():
            try:
                for keys_u8, lengths, n in batches:
                    s = wait_get(free)
                    if s is None:
                        return
                    fill(s, keys_u8, lengths)
                    if not put((s, n)):
                        return
            except BaseException as e:  # noqa: BLE001 — re-raised below
                put((_ERR, e))
                return
            put((_END, None))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        prev = None
        try:
            while True:
                if prev is not None:  # the insert that read it is launched
                    if cuda:
                        ev = torch.cuda.Event()
                        ev.record(torch.cuda.current_stream(dev))
                        used[prev] = ev
                    free.put(prev)
                    prev = None
                s, n = ready.get()
                if s is _END:
                    return
                if s is _ERR:
                    raise n
                if cuda:
                    torch.cuda.current_stream(dev).wait_event(copied[s])
                prev = s
                yield devb[s][0], devb[s][1], n
        finally:
            cancel.set()
            t.join(timeout=30)

    def run(self, keys: Iterable[bytes], *, limit: Optional[int] = None) -> dict:
        """Consume the stream (optionally at most ``limit`` keys). Returns
        run stats. Reentrant: call again to continue the same stream."""
        it: Iterator[bytes] = iter(keys)
        inserted = 0
        packed = self._packed_batches(it, limit)
        batches = self._prefetched(packed) if self.prefetch else self._staged(packed)
        for d_keys, d_lengths, n_valid in batches:
            with obs.phase("kernel"):
                self.filter.insert_arrays(d_keys, d_lengths, n_valid=n_valid)
                fence = self.filter._completion()
                if fence is not None:
                    self._in_flight.append(fence)
                    if len(self._in_flight) >= self.max_in_flight:
                        # backpressure: wait for the oldest launched batch
                        self._in_flight.popleft().synchronize()
            inserted += n_valid
            self.consumed += n_valid
            if self.checkpointer:
                self.checkpointer.notify_inserts(n_valid)
        with obs.phase("kernel"):
            if self._in_flight:
                self._in_flight[-1].synchronize()  # the newest: every batch is in
                self._in_flight.clear()
        return {
            "inserted": inserted,
            "stream_offset": self.consumed,
            "checkpoints_written": (
                self.checkpointer.checkpoints_written if self.checkpointer else 0
            ),
        }

    def close(self, *, final_checkpoint: bool = True) -> bool:
        """Flush and stop checkpointing. Returns False when the requested
        final checkpoint did NOT land — callers using close() as the
        durability point before discarding the source stream must check it
        (``checkpointer.last_error`` has the cause). No checkpointer
        configured -> trivially True."""
        if self.checkpointer:
            return self.checkpointer.close(final_checkpoint=final_checkpoint)
        return True


def resume_offset(restored_filter) -> int:
    """Stream offset recorded in the checkpoint a filter was restored from
    (0 if none): restart the source at or before this offset and re-run —
    idempotent inserts make the replay safe."""
    meta = getattr(restored_filter, "_restored_meta", None) or {}
    return int(meta.get("stream_offset", 0))

"""Micro-batching query scheduler: max-batch / max-wait admission policy.

Counterpart of ``repro.serve.scheduler``, the same classes and policy
(pure Python; nothing here touches a tensor).

Path queries are O(path-length) host-side walks, so the win from batching
is not device dispatch — it is amortizing the *staleness check and refresh*
across a window of queries: one ``refresh()`` (one bucketed batched solve
or one rank-1 repair dispatch) serves the whole batch off a single
consistent snapshot.

``MicroBatcher`` is cooperative and single-threaded (like everything in
the serving layer): ``submit()`` enqueues and returns a ``Ticket``;
the queue flushes when it reaches ``max_batch``, when ``poll()`` sees the
oldest ticket has waited ``max_wait_s``, or when a caller forces a result
(``Ticket.result()`` on an unresolved ticket flushes — a query is never
allowed to block behind an idle queue).  The clock is injectable so the
max-wait path is testable with a fake clock.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable


@dataclasses.dataclass(frozen=True)
class PendingQuery:
    """One queued path query."""

    graph_id: str
    src: int
    dst: int


class Ticket:
    """Handle for one submitted query; resolves at flush time."""

    __slots__ = ("_batcher", "_value", "_done")

    def __init__(self, batcher: "MicroBatcher"):
        self._batcher = batcher
        self._value: Any = None
        self._done = False

    @property
    def done(self) -> bool:
        return self._done

    def result(self) -> Any:
        """The reply — forces a flush if this ticket is still queued."""
        if not self._done:
            self._batcher.flush()
        return self._value

    def _resolve(self, value: Any) -> None:
        self._value = value
        self._done = True


class MicroBatcher:
    """Batch queries up to ``max_batch`` or ``max_wait_s``, then flush.

    flush_fn: ``list[PendingQuery] -> list[reply]`` (same order).  The
    routing layer passes its ``query_many`` — one staleness check + at most
    one refresh per flushed batch.
    """

    def __init__(
        self,
        flush_fn: Callable[[list[PendingQuery]], Iterable[Any]],
        *,
        max_batch: int = 32,
        max_wait_s: float = 0.002,
        clock: Callable[[], float] = time.monotonic,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._flush_fn = flush_fn
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._clock = clock
        self._queue: list[tuple[PendingQuery, Ticket]] = []
        self._oldest: float | None = None
        self.flushes = 0
        self.queries = 0
        self.max_seen_batch = 0

    # --------------------------------------------------------------- intake
    def submit(self, graph_id: str, src: int, dst: int) -> Ticket:
        """Enqueue one query; flushes immediately at the max-batch bound."""
        t = Ticket(self)
        if self._oldest is None:
            self._oldest = self._clock()
        self._queue.append((PendingQuery(graph_id, src, dst), t))
        self.queries += 1
        if len(self._queue) >= self.max_batch:
            self.flush()
        return t

    def poll(self) -> bool:
        """Flush iff the oldest queued query has waited ``max_wait_s``.

        The caller's idle-loop hook; returns whether a flush happened.
        """
        if not self._queue or self._oldest is None:
            return False
        if self._clock() - self._oldest < self.max_wait_s:
            return False
        self.flush()
        return True

    @property
    def pending(self) -> int:
        return len(self._queue)

    # ---------------------------------------------------------------- flush
    def flush(self) -> int:
        """Run the queued batch through flush_fn; returns the batch size."""
        if not self._queue:
            return 0
        batch, self._queue = self._queue, []
        self._oldest = None
        replies = list(self._flush_fn([q for q, _ in batch]))
        if len(replies) != len(batch):
            raise RuntimeError(
                f"flush_fn returned {len(replies)} replies for "
                f"{len(batch)} queries"
            )
        for (_, ticket), reply in zip(batch, replies):
            ticket._resolve(reply)
        self.flushes += 1
        self.max_seen_batch = max(self.max_seen_batch, len(batch))
        return len(batch)

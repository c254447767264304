"""FeedbackStream: the labeled-example source of the continuous-training
loop.

Two intake modes behind one ``poll()`` surface:

- **push** — ``push(chunk)`` from any producer thread; the HTTP ingest
  endpoint (``serve()``: ``POST /ingest`` on a WorkerServer, so ``GET
  /metrics`` comes for free) is a push producer. The buffer is bounded:
  past ``max_chunks`` the OLDEST chunk is dropped and counted — under
  sustained overload a freshness-driven trainer wants the newest
  feedback, not a queue of stale examples.
- **pull** — ``from_generator`` / ``from_streaming_dataframe`` /
  ``from_csv`` wrap a re-iterable chunk source; ``poll()`` draws the
  next chunk on demand. This is the test/backfill shape, and keeps the
  source :class:`~mmlspark_tpu_torch.io.stream.StreamingDataFrame`-compatible
  (``materialize(max_rows=...)`` on an unbounded feedback source stops
  at the cap — the io/stream contract the online tests pin).

Every chunk carries its **ingest timestamp** (``time_fn`` at push/pull),
the left edge of the freshness SLO: example ingested -> model servable.

Fault point ``online.ingest`` fires per accepted chunk: an injected
error refuses the chunk (the HTTP endpoint answers 503 and buffers
nothing — chaos for the producer's retry handling), ``delay_s`` stalls
intake.

The PyTorch port's copy of ``mmlspark_tpu.online.feedback``: host code
over the port's ``WorkerServer``, with the JAX package's ingest wire,
spill-file format and metric names byte for byte (a spill written by one
package replays in the other).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Iterator, Optional

from mmlspark_tpu_torch import obs
from mmlspark_tpu_torch.core import faults
from mmlspark_tpu_torch.core.dataframe import DataFrame

_M_INGESTED = obs.counter(
    "mmlspark_online_ingested_total",
    "Feedback examples accepted into the stream buffer",
)
_M_CHUNKS = obs.counter(
    "mmlspark_online_ingest_chunks_total",
    "Feedback micro-batches accepted into the stream buffer",
)
_M_DROPPED = obs.counter(
    "mmlspark_online_dropped_chunks_total",
    "Oldest chunks dropped by the bounded buffer under overload",
)
_M_DEPTH = obs.gauge(
    "mmlspark_online_buffer_depth_count",
    "Feedback micro-batches buffered awaiting training",
)
_M_BUF_EXAMPLES = obs.gauge(
    "mmlspark_online_buffered_examples_count",
    "Feedback examples buffered awaiting training — a term of the "
    "conservation law ingested == trained + buffered + shed + poisoned "
    "(chaos/invariants.py)",
)
_M_SHED_EXAMPLES = obs.counter(
    "mmlspark_online_shed_examples_total",
    "Feedback examples in chunks deliberately shed by the bounded "
    "buffer (freshest-wins) — accounted, never silently lost",
)
_M_REFUSED = obs.counter(
    "mmlspark_online_ingest_refused_total",
    "Ingest requests refused (injected fault or malformed rows)",
)
_M_SPILL_REPLAYED = obs.counter(
    "mmlspark_online_spill_replayed_total",
    "Feedback examples replayed from the disk spill after a restart",
)
_M_SPILL_PENDING = obs.gauge(
    "mmlspark_online_spill_pending_count",
    "Spilled micro-batches not yet confirmed trained",
)

_JSON = {"Content-Type": "application/json"}


def _np_default(o: Any) -> Any:
    import numpy as np

    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, np.generic):
        return o.item()
    raise TypeError(f"not JSON-serializable: {type(o)!r}")


def _df_rows(df: DataFrame) -> list:
    cols = df.columns
    return [{c: df[c][i] for c in cols} for i in range(len(df))]


class _SpillLog:
    """Append-only chunk log backing a FeedbackStream.

    Layout: ``spill-<n>.jsonl`` segment files of JSON records
    ``{"seq", "ts", "rows"}`` plus an ``ACKED`` watermark file (the
    largest seq confirmed trained; atomic rewrite). Chunks leave the
    buffer oldest-first (trained or shed), so acknowledgement is a
    watermark, not a set; segments wholly below the watermark are
    unlinked — that is the "truncated on successful train step"
    guarantee. On restart, records above the watermark replay."""

    def __init__(self, path: str, segment_chunks: int = 64):
        self.path = path
        self.segment_chunks = max(1, int(segment_chunks))
        os.makedirs(path, exist_ok=True)
        self._f = None
        self._seg_idx = -1
        self._seg_count = 0
        # per-segment max seq, maintained in memory (append/replay) so
        # ack() can unlink without re-reading files under the lock
        self._seg_max: dict = {}
        segs = self._segments()
        if segs:
            self._seg_idx = max(int(s.split("-")[1].split(".")[0])
                                for s in segs)

    def _segments(self) -> list:
        return sorted(
            e for e in os.listdir(self.path)
            if e.startswith("spill-") and e.endswith(".jsonl")
        )

    def watermark(self) -> int:
        try:
            with open(os.path.join(self.path, "ACKED")) as f:
                return int(f.read().strip() or -1)
        except (OSError, ValueError):
            return -1

    def append(self, seq: int, ts: float, df: DataFrame) -> None:
        if self._f is None or self._seg_count >= self.segment_chunks:
            if self._f is not None:
                self._f.close()
            self._seg_idx += 1
            self._f = open(
                os.path.join(self.path, f"spill-{self._seg_idx:06d}.jsonl"),
                "a",
            )
            self._seg_count = 0
        self._f.write(json.dumps(
            {"seq": seq, "ts": ts, "rows": _df_rows(df)},
            default=_np_default,
        ) + "\n")
        self._f.flush()
        self._seg_count += 1
        name = f"spill-{self._seg_idx:06d}.jsonl"
        self._seg_max[name] = max(self._seg_max.get(name, -1), seq)

    def ack(self, watermark: int) -> None:
        """Persist the trained watermark and unlink fully-acked
        segments (the current write segment is never unlinked). Unlink
        eligibility comes from the in-memory per-segment max seq — no
        file re-reads under the stream lock; a segment whose max is
        unknown (shouldn't happen) just survives until restart."""
        tmp = os.path.join(self.path, f".ACKED-{os.getpid()}")
        with open(tmp, "w") as f:
            f.write(str(watermark))
        os.replace(tmp, os.path.join(self.path, "ACKED"))
        current = (
            f"spill-{self._seg_idx:06d}.jsonl" if self._seg_idx >= 0 else ""
        )
        for seg, max_seq in list(self._seg_max.items()):
            if seg == current or max_seq > watermark:
                continue
            try:
                os.unlink(os.path.join(self.path, seg))
            except OSError:
                pass
            del self._seg_max[seg]

    def replay(self) -> list:
        """Unacked ``(seq, ts, rows)`` records in seq order."""
        wm = self.watermark()
        out = []
        for seg in self._segments():
            try:
                with open(os.path.join(self.path, seg)) as f:
                    for line in f:
                        if not line.strip():
                            continue
                        rec = json.loads(line)
                        self._seg_max[seg] = max(
                            self._seg_max.get(seg, -1), rec["seq"]
                        )
                        if rec["seq"] > wm:
                            out.append(
                                (rec["seq"], rec["ts"], rec["rows"])
                            )
            except (OSError, ValueError, KeyError):
                continue  # torn tail of a crashed writer: best-effort
        out.sort(key=lambda r: r[0])
        return out

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class FeedbackStream:
    """Bounded, timestamped micro-batch buffer with optional pull source.

    ``max_chunks`` bounds memory; overflow drops the OLDEST buffered
    chunk (counted in ``mmlspark_online_dropped_chunks_total``).
    ``time_fn`` stamps ingest times (monotonic by default — freshness is
    an interval, not a wall-clock date)."""

    def __init__(
        self,
        source: Optional[Callable[[], Iterator[DataFrame]]] = None,
        max_chunks: int = 1024,
        time_fn: Callable[[], float] = time.monotonic,
        spill_dir: Optional[str] = None,
        spill_segment_chunks: int = 64,
    ):
        """``spill_dir``: optional durability — every PUSHED micro-batch
        is appended to an on-disk chunk log (:class:`_SpillLog`) before
        it is buffered, replayed into the buffer on construction after a
        crash, and truncated once the consumer confirms training
        (:meth:`ack_trained`, wired by OnlineLearningLoop). Pull-source
        chunks never spill — their source is already durable/re-iterable.
        Bounded-buffer sheds are acknowledged as handled (deliberate
        freshest-wins policy, counted), so only genuinely-untrained
        pushes ever replay."""
        self._buf: deque = deque()  # (ingest_ts, DataFrame, seq-or-None)
        self._buf_examples = 0      # running sum of len() over _buf
        self._cond = threading.Condition()
        self._max_chunks = max(1, int(max_chunks))
        self._now = time_fn
        self._source = source
        self._iter: Optional[Iterator[DataFrame]] = None
        self._exhausted = False
        self._closed = False
        self.ingested = 0   # examples accepted
        self.dropped = 0    # chunks dropped by the bound
        self.dropped_examples = 0
        self.replayed = 0   # examples restored from the spill
        self._ingress: Any = None
        self._router: Optional[threading.Thread] = None
        # spill bookkeeping: chunks leave the buffer oldest-first, so the
        # trained/shed frontier is a seq watermark
        self._spill: Optional[_SpillLog] = None
        self._seq = 0
        # chunks polled out, awaiting ack: (seq, ts, chunk) — the chunk
        # is kept so a FAILED train step can requeue it (nack_failed)
        self._handed: list = []
        self._done: set = set()     # seqs trained or deliberately shed
        self._watermark = -1
        self._spill_lock = threading.Lock()
        if spill_dir:
            self._spill = _SpillLog(spill_dir, spill_segment_chunks)
            self._watermark = self._spill.watermark()
            self._seq = self._watermark + 1
            now = self._now()
            for seq, ts, rows in self._spill.replay():
                chunk = DataFrame.from_rows(rows)
                # monotonic stamps do not survive a reboot (the clock
                # restarts): clamp to "now", so a replayed chunk's age
                # counts from replay — conservative, never garbage
                self._buf.append((min(ts, now), chunk, seq))
                self._buf_examples += len(chunk)
                self._seq = max(self._seq, seq + 1)
                self.replayed += len(chunk)
                _M_SPILL_REPLAYED.inc(len(chunk))
            # the bound applies to replayed backlog too: re-shed the
            # oldest past max_chunks (freshest-wins holds across a
            # crash; the sheds are acked so they never replay again)
            while len(self._buf) > self._max_chunks:
                self._shed_oldest_locked()
            _M_SPILL_PENDING.set(self._spill_pending_locked())
            self._export_buf_locked()

    # -- construction --------------------------------------------------------

    @staticmethod
    def from_generator(
        make_chunk: Callable[[int], Optional[DataFrame]],
        num_chunks: Optional[int] = None,
        **kw: Any,
    ) -> "FeedbackStream":
        """``make_chunk(i)`` -> DataFrame or None (None = end of stream);
        ``num_chunks=None`` = unbounded (the live-feedback shape)."""

        def source() -> Iterator[DataFrame]:
            i = 0
            while num_chunks is None or i < num_chunks:
                chunk = make_chunk(i)
                if chunk is None:
                    return
                yield chunk
                i += 1

        return FeedbackStream(source=source, **kw)

    @staticmethod
    def from_streaming_dataframe(sdf: Any, **kw: Any) -> "FeedbackStream":
        """Wrap a :class:`StreamingDataFrame` (file/CSV-backed feedback
        logs replay through the same loop as live traffic)."""
        return FeedbackStream(source=sdf.iter_chunks, **kw)

    @staticmethod
    def from_csv(path: str, chunk_rows: int = 4096, **kw: Any) -> "FeedbackStream":
        from mmlspark_tpu_torch.io.stream import StreamingDataFrame

        return FeedbackStream.from_streaming_dataframe(
            StreamingDataFrame.from_csv(path, chunk_rows=chunk_rows), **kw
        )

    # -- push intake ---------------------------------------------------------

    def push(self, chunk: DataFrame, ts: Optional[float] = None) -> int:
        """Buffer one micro-batch; returns rows accepted. Raises when the
        ``online.ingest`` fault point injects an error (the chunk is NOT
        buffered) or the stream is closed."""
        if self._closed:
            raise RuntimeError("feedback stream is closed")
        # fault point online.ingest: an injected error refuses this chunk
        # (producer-visible), delay_s stalls intake
        faults.inject("online.ingest", context={"rows": len(chunk)})
        ts = self._now() if ts is None else ts
        seq = None
        if self._spill is not None:
            # spill BEFORE buffering: once push() returns, a crash
            # cannot lose this chunk (replayed on restart). The disk
            # write holds only the spill lock — a slow disk must not
            # stall concurrent poll()/ingest on the buffer condition
            with self._spill_lock:
                seq = self._seq
                self._seq += 1
                self._spill.append(seq, ts, chunk)
        with self._cond:
            if seq is not None:
                _M_SPILL_PENDING.set(self._spill_pending_locked())
            self._buf.append((ts, chunk, seq))
            self._buf_examples += len(chunk)
            if len(self._buf) > self._max_chunks:
                self._shed_oldest_locked()  # freshest-wins
            self.ingested += len(chunk)
            self._export_buf_locked()
            self._cond.notify()
        _M_INGESTED.inc(len(chunk))
        _M_CHUNKS.inc()
        return len(chunk)

    # -- spill acknowledgement -------------------------------------------------

    def _shed_oldest_locked(self) -> None:
        """Drop the oldest buffered chunk, keeping every term of the
        conservation law (ingested == trained+buffered+shed+poisoned,
        chaos/invariants.py) in one place for BOTH shed sites: live
        overflow in push() and replayed-backlog overflow on restart. A
        deliberate shed is HANDLED, not lost: acking it keeps the spill
        from resurrecting rejected backlog."""
        _, shed, shed_seq = self._buf.popleft()
        self._buf_examples -= len(shed)
        self.dropped += 1
        self.dropped_examples += len(shed)
        _M_DROPPED.inc()
        _M_SHED_EXAMPLES.inc(len(shed))
        if shed_seq is not None:
            self._mark_done_locked(shed_seq)

    def _spill_pending_locked(self) -> int:
        return max(
            0, (self._seq - 1 - self._watermark) - len(self._done)
        )

    def _mark_done_locked(self, seq: int) -> None:
        self._done.add(seq)
        advanced = False
        while (self._watermark + 1) in self._done:
            self._watermark += 1
            self._done.discard(self._watermark)
            advanced = True
        if advanced and self._spill is not None:
            self._spill.ack(self._watermark)
        if self._spill is not None:
            _M_SPILL_PENDING.set(self._spill_pending_locked())

    def ack_trained(self) -> None:
        """Confirm every chunk currently handed out by :meth:`poll` was
        folded into the model — the spill truncates up to the trained
        watermark. Called by OnlineLearningLoop after each successful
        train step; a crash between poll and ack replays the chunk. A
        FAILED step must :meth:`nack_failed` first, or its chunk would
        ride a later success's acknowledgement."""
        with self._cond:
            handed, self._handed = self._handed, []
            for seq, _, _ in handed:
                if seq is not None:
                    self._mark_done_locked(seq)

    def nack_failed(self) -> None:
        """Requeue every handed-out-but-unconfirmed chunk at the FRONT
        of the buffer (original order): a train step that raised did not
        consume its chunk — it is retried by the next poll, and the
        spill keeps it replayable meanwhile."""
        with self._cond:
            handed, self._handed = self._handed, []
            for seq, ts, chunk in reversed(handed):
                self._buf.appendleft((ts, chunk, seq))
                self._buf_examples += len(chunk)
            self._export_buf_locked()

    def spill_pending(self) -> int:
        """Spilled chunks not yet confirmed trained (0 without a spill)."""
        if self._spill is None:
            return 0
        with self._cond:
            return self._spill_pending_locked()

    def _export_buf_locked(self) -> None:
        """Export buffer depth in chunks AND examples (the latter is a
        term of the invariant checker's conservation law). The example
        count is an incrementally-maintained integer — recomputing the
        sum under the condition lock would cost O(max_chunks) on every
        ingest/pop and serialize producers against the consumer."""
        _M_DEPTH.set(len(self._buf))
        _M_BUF_EXAMPLES.set(self._buf_examples)

    # -- consumption ---------------------------------------------------------

    def depth(self) -> int:
        with self._cond:
            return len(self._buf)

    def poll(self, timeout_s: float = 0.25) -> Optional[tuple]:
        """Next ``(ingest_ts, DataFrame)`` micro-batch, or None.

        Buffered (pushed) chunks win; otherwise a pull source is drawn
        from (stamped at draw time — that IS its ingest into the
        system); otherwise block up to ``timeout_s`` for a push."""
        with self._cond:
            if self._buf:
                ts0, chunk0, seq0 = self._buf.popleft()
                self._buf_examples -= len(chunk0)
                # seq may be None (no spill): still tracked, so
                # nack_failed() can requeue a transiently-failed chunk
                # on ANY stream, not only disk-backed ones
                self._handed.append((seq0, ts0, chunk0))
                self._export_buf_locked()
                return (ts0, chunk0)
        if self._source is not None and not self._exhausted:
            if self._iter is None:
                self._iter = self._source()
            # fault point BEFORE the draw: an injected refusal leaves the
            # chunk in the iterator (retried next poll), matching the
            # push path where the producer keeps the refused chunk —
            # firing after next() would silently lose examples
            faults.inject("online.ingest", context={"mode": "pull"})
            try:
                chunk = next(self._iter)
            except StopIteration:
                self._exhausted = True
                return None
            self.ingested += len(chunk)
            _M_INGESTED.inc(len(chunk))
            _M_CHUNKS.inc()
            return (self._now(), chunk)
        with self._cond:
            if not self._buf and timeout_s > 0:
                self._cond.wait(timeout_s)
            if self._buf:
                ts0, chunk0, seq0 = self._buf.popleft()
                self._buf_examples -= len(chunk0)
                self._handed.append((seq0, ts0, chunk0))
                self._export_buf_locked()
                return (ts0, chunk0)
        return None

    @property
    def exhausted(self) -> bool:
        """A pull source ran dry (push streams never exhaust)."""
        return self._exhausted and self.depth() == 0

    # -- HTTP ingest endpoint ------------------------------------------------

    def serve(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        name: str = "serving-online",
    ) -> Any:
        """Start the HTTP ingest ingress: ``POST /ingest`` with
        ``{"rows": [{...}, ...]}`` (or one bare row object) buffers a
        micro-batch; ``GET /health`` answers liveness; ``GET /metrics``
        is served inline by the WorkerServer machinery. Returns the
        :class:`ServiceInfo` (registered under ``name`` by the fleet
        wiring so ``fleet top`` and the deploy smoke can find the loop).
        """
        from mmlspark_tpu_torch.serving.server import WorkerServer

        srv = WorkerServer(host=host, port=port, name=name)
        info = srv.start()
        self._ingress = srv
        self._router = threading.Thread(
            target=self._ingest_loop, name="online-ingest", daemon=True
        )
        self._router.start()
        return info

    def _ingest_loop(self) -> None:
        srv = self._ingress
        while not self._closed:
            reqs = srv.get_next_batch(max_n=64, timeout_s=0.25)
            for r in reqs:
                try:
                    self._ingest_one(r)
                except Exception as e:  # noqa: BLE001 — ingress must survive
                    _M_REFUSED.inc()
                    srv.reply_to(
                        r.id,
                        json.dumps(
                            {"error": f"{type(e).__name__}: {e}"}
                        ).encode(),
                        503, _JSON,
                    )
            if reqs:
                srv.auto_commit()
        for r in srv.get_next_batch(max_n=1_000_000, timeout_s=0.0):
            srv.reply_to(r.id, b"ingest stopping", 503)

    def _ingest_one(self, r: Any) -> None:
        path = r.path.split("?", 1)[0]
        if path in ("/health", "/healthz") and r.method == "GET":
            self._ingress.reply_to(
                r.id,
                json.dumps(
                    {"status": "ok", "buffered_chunks": self.depth()}
                ).encode(),
                200, _JSON,
            )
            return
        if path != "/ingest" or r.method != "POST":
            self._ingress.reply_to(
                r.id, b'{"error": "POST /ingest"}', 404, _JSON
            )
            return
        body = json.loads(r.body) if r.body else {}
        rows = body["rows"] if isinstance(body, dict) and "rows" in body \
            else [body]
        if (
            not isinstance(rows, list) or not rows
            or not all(isinstance(x, dict) for x in rows)
        ):
            raise ValueError("rows must be a non-empty list of objects")
        n = self.push(DataFrame.from_rows(rows))
        self._ingress.reply_to(
            r.id,
            json.dumps(
                {"accepted": n, "buffered_chunks": self.depth()}
            ).encode(),
            200, _JSON,
        )

    def close(self) -> None:
        self._closed = True
        if self._router is not None:
            self._router.join(5.0)
        if self._ingress is not None:
            self._ingress.stop()
        if self._spill is not None:
            self._spill.close()
        with self._cond:
            self._cond.notify_all()


__all__ = ["FeedbackStream"]

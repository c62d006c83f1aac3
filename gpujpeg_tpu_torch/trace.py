"""The port's tracer: the spans of one encode or decode call at its layer
boundaries, kept in a bounded buffer of this module, and the call's stage
marks on the device.

With ``Parameters.perf_stats`` (``Encoder.encode``) or
``Decoder.perf_stats`` (``Decoder.decode``, ``decode_to_device``) each
call makes a :class:`Tracer`, which opens the call's root span
(``gpujpeg.enc`` or ``gpujpeg.dec``); the layers under it open and close
their spans on it. Without them the call holds ``None`` and every span
site is one ``is not None`` check: no object is made, no clock is read
and no torch function is called.

A span records its name, its start and end on ``time.perf_counter_ns()``
(the clock of ``time.perf_counter``), the index of its parent span (-1
for a root), the id of its call and, on the transfer spans, a byte count
(the lanes launched on ``gpujpeg.dec.lanes``). A counter
(:meth:`Tracer.count`) is a record of no duration whose byte count holds
its value: ``gpujpeg.dec.rounds``, the rounds a lane decode took,
``gpujpeg.dec.tables_fresh``, the DHT tables a decode's parse derived
rather than shared from an earlier parse (after the stream span), and
``gpujpeg.dec.card_rows``, the segments whose rows D0 built on the card
(in the root, after the wait; none on the lane route, whose rows the
host builds). On the lane route the span ``gpujpeg.dec.rows`` is the host's
row build and its bytes the rows'; on every other plan it is the
segments' ranges, and its bytes, as ``gpujpeg.dec.memory_to``'s, are
those uploaded: the scans' and the ranges'.
While ``torch.profiler`` records, each span also opens a
``torch.profiler.record_function`` range of its name, so that the spans
lie on the profiler's host timeline, to which the card's events are
aligned; otherwise no range is opened (one costs 9-15 us, even unrecorded).

The buffer holds :data:`CAPACITY` spans. It is allocated on the first
traced span; spans past its end are not kept but counted
(:func:`dropped`). :func:`spans` reads it and :func:`clear` empties it.
Nothing is written to disk.

The device marks (:meth:`Tracer.mark`): on the card a CUDA event
recorded on the current stream between two launches and read after the
call's one sync (:meth:`Tracer.durations`); on the CPU the host clock.
They fill the stage statistics that only the card can time
(``EncoderStats``, ``DecoderStats``).
"""
from __future__ import annotations

import itertools
import threading
import time

import numpy as np
import torch
from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

#: spans the buffer holds: 38 MB of address space, written (and so
#: resident) only as far as spans are recorded; a traced 51 s benchmark
#: run records up to about 190,000, at HD (PERF.md)
CAPACITY = 1 << 20

#: every span's name, in the order of its code (``spans()["name"]``)
NAMES = (
    "gpujpeg.enc",              # Encoder.encode (root)
    "gpujpeg.enc.plan",         # make_plan and the tables
    "gpujpeg.enc.context",      # the plan's device context, found or built
    "gpujpeg.enc.upload",       # the raw frame to the device (bytes moved)
    "gpujpeg.enc.launch",       # the kernels' enqueue
    "gpujpeg.enc.wait",         # the segment lengths back: the host waits
    "gpujpeg.enc.memory_from",  # compaction and copy back (scan bytes)
    "gpujpeg.enc.stream",       # the JPEG stream's assembly
    "gpujpeg.dec",              # Decoder.decode, decode_to_device (root)
    "gpujpeg.dec.stream",       # the stream's parse
    "gpujpeg.dec.plan",         # the plan, scans and tables of the stream
    "gpujpeg.dec.context",      # the decode context and its table keys
    "gpujpeg.dec.rows",         # the segments' ranges (bytes uploaded)
    "gpujpeg.dec.memory_to",    # the scans and ranges up (bytes uploaded)
    "gpujpeg.dec.launch",       # the kernels' enqueue
    "gpujpeg.dec.wait",         # the host waits for the card
    "gpujpeg.dec.memory_from",  # the frame to host memory (frame's bytes)
    "gpujpeg.dec.pin",          # its page-locked block (bytes taken fresh)
    "gpujpeg.dec.lanes",        # the lane route's enqueue (lanes launched)
    "gpujpeg.dec.rounds",       # counter: the lanes' rounds (no duration)
    "gpujpeg.dec.tables_fresh",  # counter: DHT tables the parse derived
    "gpujpeg.dec.card_rows",    # counter: segments D0 destuffed on the card
)
_CODE = {name: i for i, name in enumerate(NAMES)}

#: one record of the buffer
SPAN = np.dtype([("name", np.int16), ("parent", np.int32),
                 ("call", np.int64), ("start_ns", np.int64),
                 ("end_ns", np.int64), ("bytes", np.int64)])

_lock = threading.Lock()
_buf: np.ndarray | None = None
#: the buffer's fields, in SPAN's order, for writes of one element
_cols: tuple = ()
_used = 0
_dropped = 0
_call_ids = itertools.count()


def _take() -> int:
    """The next free index of the buffer (allocated here on the first
    call), or -1, counted as dropped, when it is full."""
    global _buf, _cols, _used, _dropped
    with _lock:
        if _buf is None:
            _buf = np.zeros(CAPACITY, SPAN)
            _cols = tuple(_buf[f] for f in SPAN.names)
        if _used == CAPACITY:
            _dropped += 1
            return -1
        _used += 1
        return _used - 1


def spans() -> np.ndarray:
    """The spans recorded since the start or the last :func:`clear`, in
    the order they were opened: a read-only view of the buffer, records
    of :data:`SPAN`. ``name`` indexes :data:`NAMES`, ``parent`` is the
    index of the parent span in this array (-1 for a root), ``end_ns`` is
    0 while a span is open, and ``bytes`` is 0 where no byte count is
    given."""
    with _lock:
        view = (np.zeros(0, SPAN) if _buf is None else _buf[:_used]).view()
    view.flags.writeable = False
    return view


def dropped() -> int:
    """Spans not kept because the buffer was full."""
    return _dropped


def clear() -> None:
    """Forget every span and the dropped count and free the buffer; call
    it while no traced call is running."""
    global _buf, _cols, _used, _dropped
    with _lock:
        _buf, _cols, _used, _dropped = None, (), 0, 0


class Tracer:
    """The spans and device marks of one traced encode or decode call.
    Made with the call's root span open; :meth:`finish` closes every span
    still open, the root last."""

    __slots__ = ("device", "cuda", "marks", "call", "_open")

    def __init__(self, device: torch.device, root: str):
        self.device = device
        self.cuda = device.type == "cuda"
        self.marks: list = []
        self.call = next(_call_ids)
        #: (buffer index or -1, profiler range or None) of each open span,
        #: the innermost last
        self._open: list = []
        self.open(root)

    def finish(self) -> None:
        """Close every open span: the call's end, or its exception's."""
        while self._open:
            self.close()

    def open(self, name: str) -> int:
        """Open the span ``name`` inside the innermost open one; returns
        its start (ns)."""
        t = time.perf_counter_ns()
        i = _take()
        if i >= 0:
            c = _cols
            c[0][i] = _CODE[name]
            c[1][i] = self._open[-1][0] if self._open else -1
            c[2][i] = self.call
            c[3][i] = t
        rng = None
        if _profiler_enabled():
            rng = record_function(name)
            rng.__enter__()
        self._open.append((i, rng))
        return t

    def close(self, nbytes: int | None = None) -> int:
        """Close the innermost open span, with ``nbytes`` as its byte
        count where given; returns its end (ns)."""
        i, rng = self._open.pop()
        if rng is not None:
            rng.__exit__(None, None, None)
        t = time.perf_counter_ns()
        if i >= 0:
            _cols[4][i] = t
            if nbytes is not None:
                _cols[5][i] = nbytes
        return t

    def count(self, name: str, n: int) -> None:
        """A counter: a record of no duration, now, inside the innermost
        open span, with ``n`` in its byte count (no profiler range)."""
        t = time.perf_counter_ns()
        i = _take()
        if i >= 0:
            c = _cols
            c[0][i] = _CODE[name]
            c[1][i] = self._open[-1][0] if self._open else -1
            c[2][i] = self.call
            c[3][i] = c[4][i] = t
            c[5][i] = n

    def mark(self) -> None:
        """A stage boundary on the device: a CUDA event on the current
        stream of the call's card, or the host clock on the CPU."""
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(self.device))
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def durations(self) -> list[float]:
        """ms between consecutive marks (on the card after one sync on
        the last event)."""
        pairs = list(zip(self.marks, self.marks[1:]))
        if self.cuda:
            self.marks[-1].synchronize()
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]

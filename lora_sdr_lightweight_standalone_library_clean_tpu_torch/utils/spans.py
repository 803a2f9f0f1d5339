"""Stage spans and counters of the port.

``span(name)`` marks a stage on ``torch.profiler``'s timeline, the one
clock that the profiler's device activities share: while a profiler
session records, it is a ``RecordFunction`` named ``name``, so every
kernel, copy and fill a stage launches, and every host wait in it, can be
read back by the stage that launched it; with no session it is one shared
no-op.  The session is the switch: any ``torch.profiler.profile`` turns
the spans on, and nothing else does.  ``spanned(name)`` wraps a whole
function in one.

Host costs, measured on an H100 machine's CPU: with no session the gate
0.6 us a span, where ``torch.profiler.record_function`` costs 11 us even
then; in a session torch's fast ``RecordFunction`` context
(``torch._C._profiler._RecordFunctionFast``, where this torch has it) 1.2
us against 10-12 us for ``record_function``, which goes through the
dispatcher.  The fast one records the same host span and makes no
device-side copy of it.

Span names start with ``lora.``.  An entry point's span is the root of the
stages it runs: ``lora.receive_stream``/``lora.receive_stream_frames``
hold ``lora.rx.extend``, ``.scan``, ``.select``, ``.extract``, the
demodulator's ``lora.rx.demod`` (``.norm``, ``.estimate``, ``.detect``),
the codec's ``lora.codec.*`` and ``lora.rx.outputs``; ``lora.tx.modulate``
is the TX, and ``lora.kernel.<kernel>`` each hand-written kernel's launch
path (its argument checks, tables, library load and the call).

``COUNTS`` is the port's one registry of counters, host-side increments
only (a counter that read a device value would be a synchronisation):
``launch.<kernel>`` for every launch of a hand-written kernel and
``collective_bytes.<halo|scan|results>`` for the bytes a rank puts into
the sharded receiver's collectives.  Readers take differences; nothing
resets it.
"""
from __future__ import annotations

import collections
import contextlib
import functools

import torch
from torch._C._autograd import _profiler_enabled

try:
    from torch._C._profiler import _RecordFunctionFast as _record
except ImportError:     # a torch older than 2.2
    _record = torch.profiler.record_function

__all__ = ["span", "spanned", "count", "COUNTS"]

COUNTS: collections.Counter = collections.Counter()

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``RecordFunction`` named ``name`` while a profiler session
    records, else the shared no-op."""
    if _profiler_enabled():
        return _record(name)
    return _OFF


def spanned(name: str):
    """Decorator: each call of the function runs inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            with _record(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    COUNTS[name] += n

"""Named ranges of the model step, recorded into an open ``torch.profiler``
session and into nothing else.

``span(name)`` is ``record_function(name)`` while a session is open (the
benchmark's tracer, ``analyze(profile_dir=)``, any caller's ``profile``)
and one shared null context otherwise, so that with no session a span costs
one module attribute read. The flag read is the one the session sets for
its whole life on every thread: ``torch.autograd._profiler_enabled()``
reads False on threads other than the one that started a session, and
even there under ``profile_all_threads``. The ranges export as
``user_annotation`` events, on the clock of the session's kernels.

The spans, by name (fixed; ``PERF.md`` lists what reads each):

* ``buzzdetect.dispatch``: one ``predict_async`` or ``predict_async_batch``;
* ``buzzdetect.wire``: ``_pad_to``, the wire conversion and padding;
* ``buzzdetect.upload``: ``_upload``, pinning and the non-blocking copy in;
* ``buzzdetect.classify``: every launch of the classify (``_classify``),
  and inside it ``buzzdetect.frontend`` (wire to float, resample, log-mel
  patches; on the card's int16 path one launch, the fused log-mel, which
  reads the wire itself), ``buzzdetect.embed`` (layer 1 and the conv stack) and
  ``buzzdetect.head``; under the Audio Spectrogram Transformer
  (``models/ast.py``) ``buzzdetect.frontend`` holds the Kaldi fbank's one
  launch, and each block of windows has ``buzzdetect.patch_embed``,
  ``buzzdetect.embed`` (the encoder, with a ``buzzdetect.attention``
  around each launch of the attention operator) and ``buzzdetect.head``;
  under BEATs (``models/beats.py``) likewise, with ``buzzdetect.pos_conv``
  (the convolutional position embedding) after ``buzzdetect.patch_embed``
  and a ``buzzdetect.post_ln`` around each deep-norm post-LN launch inside
  ``buzzdetect.embed``;
* ``buzzdetect.copy_back``: ``runtime/inferer._start_host_copy``;
* ``buzzdetect.wait``: ``runtime/writer._materialize``, the host blocked
  on a chunk's scores.

Chunk ids: a classifier numbers the chunks it dispatches. Each dispatch,
copy back and wait holds a ``buzzdetect.chunk#<n>`` marker per chunk, a
range of a few microseconds (category ``cpu_op``: ``_RecordFunctionFast``,
entered and left with no point between at which the thread could yield
the interpreter lock, so that the marker never outlasts its own recording
and never names an idle gap of the device in a breakdown). The id rides
from the dispatch's output tensor to the copy in flight and the wait on the
``buzzdetect_chunk`` attribute (``tag``, ``chunk_of``), never in the names
of the spans above.
"""

import contextlib

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

NULL = contextlib.nullcontext()
CHUNK = 'buzzdetect.chunk#'
_ATTR = 'buzzdetect_chunk'


def span(name: str):
    """``record_function(name)`` in an open profiler session, else NULL."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return NULL


def mark(chunks):
    """One ``buzzdetect.chunk#<n>`` marker for each id in ``chunks`` (an
    id, a list of ids or None) in an open session."""
    if chunks is None or not _profiler._is_profiler_enabled:
        return
    for n in chunks if isinstance(chunks, list) else (chunks,):
        with _RecordFunctionFast(f'{CHUNK}{n}'):
            pass


def tag(obj, chunks):
    """Attach chunk ids to ``obj`` (a result tensor or a copy in flight);
    returns ``obj``. None attaches nothing."""
    if chunks is not None:
        setattr(obj, _ATTR, chunks)
    return obj


def chunk_of(obj):
    """The chunk ids ``tag`` attached to ``obj``, or None."""
    return getattr(obj, _ATTR, None)

"""Inferer worker: chunk samples -> device dispatch -> results.

Parity with the reference inferer (`src/inference/worker.py:9-92`): per-chunk
analysis-rate PROGRESS reports (rate = audio-seconds per wall-second — the
benchmark metric) and queue-starvation "BUFFER BOTTLENECK" reports that tell
users to add streamers.

Predictions dispatch asynchronously (CUDA kernels are queued on the stream)
and the result rides the queue to the writer as a device->host copy in
flight (:class:`HostCopy`), so the device computes chunk N while this thread
dequeues and dispatches chunk N+1 and the writer formats chunk N-1 — a
three-stage pipeline without a scheduler.

On a CUDA device each worker dispatches on a CUDA stream of its own
(:func:`_dispatch_scope`): the upload, the kernels and the copy back of a
chunk are ordered on it, and two replicas on one card (``analyze(devices=
['cuda:0', 'cuda:0'])``) or two dispatch threads of one replica run side
by side instead of sharing the device's default stream. Under ``mesh=``
the worker has a stream of its own on every card of the mesh.
"""

import contextlib
import queue

import numpy as np
import torch

from buzzdetect_torch.runtime.assignments import AssignChunk, AssignLog
from buzzdetect_torch.runtime.writer import _materialize
from buzzdetect_torch.utils import Timer


def _is_empty(a_chunk: AssignChunk) -> bool:
    """Zero-sample final chunk (EOF exactly at the gap start): delivered to
    the writer for completion tracking, but never dispatched to the device
    and never stacked into a batch."""
    return a_chunk.samples is not None and len(a_chunk.samples) == 0


class HostCopy:
    """A device->host copy in flight: a pinned host tensor filled by a
    non-blocking copy on the current stream of the result's device (the
    stream that computed it), and the CUDA event recorded after it on that
    stream. ``wait()`` blocks on the event and returns the host array —
    ``np.asarray`` on the CUDA tensor itself would raise."""

    def __init__(self, results):
        self.host = torch.empty(results.shape, dtype=results.dtype,
                                pin_memory=True)
        self.host.copy_(results, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(results.device))

    def wait(self) -> np.ndarray:
        self.event.synchronize()
        return self.host.numpy()


def _start_host_copy(results):
    """Kick off the async device->host copy of a result the moment it is
    dispatched, so every chunk's download overlaps the writer's work on
    earlier chunks. Returns what the writer materializes: a
    :class:`HostCopy` for a CUDA tensor, else ``results`` unchanged (CPU
    tensors and plugin models' plain numpy)."""
    if isinstance(results, torch.Tensor) and results.is_cuda:
        return HostCopy(results)
    return results


def _model_device(model):
    """The torch device of the model's classifier, or None (plugin
    models)."""
    target = getattr(model, 'classifier', None) or model
    return getattr(target, 'device', None)


def _model_mesh(model):
    """The mesh the model's classifier splits over (``mesh`` or
    ``sharding.mesh``), or None."""
    target = getattr(model, 'classifier', None) or model
    mesh = getattr(target, 'mesh', None)
    if mesh is None:
        mesh = getattr(getattr(target, 'sharding', None), 'mesh', None)
    return mesh


def _dispatch_scope(model):
    """A context in which this thread dispatches on CUDA streams of its
    own, one on each card the model runs on (its device, and every card of
    its mesh), with the model's device current: the wire upload, the
    kernels and the copy back queue on them, and torch orders each copy
    between two cards after the current streams of both. Each stream first
    waits for the work its card's current stream already holds (the
    classifier's weights, copied at initialize()). A no-op off CUDA."""
    device = _model_device(model)
    if not (isinstance(device, torch.device) and device.type == 'cuda'):
        return contextlib.nullcontext()
    mesh = _model_mesh(model)
    cards = [] if mesh is None else [d for d in dict.fromkeys(
        mesh.devices.flat) if d != device]
    scope = contextlib.ExitStack()
    # the model's card last, so that it is the current device in the scope
    for card in cards + [device]:
        stream = torch.cuda.Stream(card)
        stream.wait_stream(torch.cuda.current_stream(card))
        scope.enter_context(torch.cuda.device(card))
        scope.enter_context(torch.cuda.stream(stream))
    return scope


def _describe_execution_target(model) -> str:
    """Name where this worker's dispatches actually execute: the mesh the
    model's classifier splits over (``'N-device mesh (CPU)'``, with the
    cards' names on CUDA), else its torch device (with the card's name on
    CUDA). Plugin models without a ``device`` run on the ambient device,
    torch's default (as the JAX copy reports the ambient backend).

    Runs after ``model.initialize()``, so the built-in bundle's device and
    mesh are read off its (now-built) ``.classifier``. Plugin models may
    expose the same names directly."""
    mesh = _model_mesh(model)
    if mesh is not None:
        label = f'{mesh.devices.size}-device mesh ({mesh.device_type.upper()}'
        if mesh.device_type == 'cuda':
            label += ': ' + ', '.join(dict.fromkeys(
                torch.cuda.get_device_name(d) for d in mesh.devices.flat))
        return label + ')'
    device = _model_device(model)
    if device is None:
        device = torch.get_default_device()
    if isinstance(device, torch.device) and device.type == 'cuda':
        return f'{device} ({torch.cuda.get_device_name(device)})'
    return str(device)


class WorkerInferer:
    def __init__(self, id_analyzer, model, coordinator, processor=None,
                 batch_chunks: int = 1, warmup_samples: int = None,
                 warmup_rate: int = None):
        self.id_analyzer = id_analyzer
        self.processor = processor
        self.model = model
        self.coordinator = coordinator
        self.batch_chunks = max(1, batch_chunks)
        self.warmup_samples = warmup_samples
        # native sample rate of the corpus (resample_on_device runs): warmup
        # compiles the resampling program, not just the model-rate one
        self.warmup_rate = warmup_rate
        self.timer_analysis = Timer()
        self.timer_bottleneck = Timer()

    def _warmup(self):
        """Run the shapes this worker will dispatch once (the nominal chunk
        shape, and each power-of-two batch size when batching), so no chunk
        pays first-use allocation mid-run."""
        if not self.warmup_samples:
            return
        n = self.warmup_samples
        rate_kw = {}
        if self.warmup_rate:
            model_rate = self.model.embedder.samplerate
            n = int(round(n * self.warmup_rate / model_rate))
            rate_kw = {'input_rate': self.warmup_rate}
        zeros = np.zeros(n, np.int16
                         if getattr(self.model, 'transfer_dtype', None)
                         == 'int16' else np.float32)
        try:
            if hasattr(self.model, 'predict_async'):
                out, _ = self.model.predict_async(zeros, **rate_kw)
                _materialize(_start_host_copy(out), None)
                if self.batch_chunks > 1 and hasattr(self.model,
                                                     'predict_async_batch'):
                    b = 2
                    while b <= self.batch_chunks:
                        out, _ = self.model.predict_async_batch([zeros] * b,
                                                                **rate_kw)
                        _materialize(_start_host_copy(out), None)
                        b *= 2
                self.log('warmup complete', 'DEBUG')
        except Exception as e:  # warmup is an optimization, never fatal
            self.log(f'warmup failed (continuing): {e}', 'DEBUG')

    def __call__(self):
        self.run()

    def log(self, msg, level_str):
        self.coordinator.q_log.put(AssignLog(
            message=f'analyzer {self.id_analyzer}: {msg}', level_str=level_str))

    def report_rate(self, a_chunk: AssignChunk):
        chunk_duration = a_chunk.chunk[1] - a_chunk.chunk[0]
        self.timer_analysis.stop()
        wall = max(self.timer_analysis.get_total(5), 1e-6)
        digits = self.model.embedder.digits_time
        self.log(f'analyzed {a_chunk.file.shortpath_audio}, chunk '
                 f'({a_chunk.chunk[0]:.{digits}f}, {a_chunk.chunk[1]:.{digits}f}) '
                 f'in {wall:.2f}s (rate: {chunk_duration / wall:.1f})',
                 'PROGRESS')
        self.timer_analysis.restart()

    def report_bottleneck(self):
        self.log(f'BUFFER BOTTLENECK: analyzer {self.id_analyzer} received '
                 f'assignment after {round(self.timer_bottleneck.get_total(), 1)}s',
                 'DEBUG')

    def process_chunk(self, a_chunk: AssignChunk):
        if _is_empty(a_chunk):
            # no device dispatch, but the chunk MUST reach the writer so the
            # file's completion tracking fires and the partial finalizes
            n_classes = len(self.model.config['classes'])
            a_chunk.results = np.zeros((0, n_classes), np.float32)
            a_chunk.n_valid = 0
            a_chunk.samples = None
            self.coordinator.put_write(a_chunk)
            a_chunk.delivered = True
            return
        kw = ({'input_rate': a_chunk.input_rate}
              if a_chunk.input_rate else {})
        if hasattr(self.model, 'predict_async'):
            results, a_chunk.n_valid = self.model.predict_async(
                a_chunk.samples, **kw)
            a_chunk.results = _start_host_copy(results)
        else:  # python-plugin models: synchronous predict
            a_chunk.results = self.model.predict(a_chunk.samples, **kw)
        a_chunk.samples = None  # release decode buffer early
        self.coordinator.put_write(a_chunk)
        a_chunk.delivered = True
        self.report_rate(a_chunk)

    def _drain_batch(self, first):
        """Opportunistically pull up to batch_chunks-1 more ready chunks (no
        blocking) so independent files share one device dispatch.

        The dispatched batch size is quantized to a power of two — every
        distinct batch shape is a separate XLA compilation, so free-running
        sizes would compile B=2,3,5,7... programs; {1,2,4,8} bounds it.
        """
        batch = [first]
        mixed = []
        exit_seen = False
        if _is_empty(first):
            return batch, mixed, exit_seen
        # different-rate chunks count toward the drain budget too: without
        # that, a mixed-rate corpus with scarce same-rate chunks would keep
        # this loop sweeping the entire bounded prefetch ring into the
        # unbounded `mixed` list (streamers refill the ring immediately),
        # roughly doubling peak decoded-chunk memory past the documented
        # queue-depth bound
        while len(batch) + len(mixed) < self.batch_chunks:
            try:
                item = self.coordinator.q_analyze.get_nowait()
            except queue.Empty:
                break
            if item == 'exit':
                exit_seen = True
                break
            if item.input_rate != first.input_rate or _is_empty(item):
                # a batch dispatch shares one resample program; chunks at a
                # different native rate — and zero-sample final chunks —
                # go out as their own dispatches
                mixed.append(item)
                continue
            batch.append(item)
        pow2 = 1
        while pow2 * 2 <= len(batch):
            pow2 *= 2
        return batch[:pow2], batch[pow2:] + mixed, exit_seen

    def process_batch(self, batch):
        kw = ({'input_rate': batch[0].input_rate}
              if batch[0].input_rate else {})
        out, n_valids = self.model.predict_async_batch(
            [c.samples for c in batch], **kw)
        for i, a_chunk in enumerate(batch):
            a_chunk.results = _start_host_copy(out[i])
            a_chunk.n_valid = n_valids[i]
            a_chunk.samples = None
            self.coordinator.put_write(a_chunk)
            a_chunk.delivered = True
            self.report_rate(a_chunk)

    def run(self):
        try:
            self._run()
        except Exception as e:
            # per-chunk errors are contained inside the loop; reaching here
            # means a FATAL death (model.initialize() raising). Trigger the
            # exit protocol: otherwise streamers keep decoding into a
            # consumer-less bounded ring (hanging the run on big corpora)
            # or the run falsely reports 'Analysis complete' with nothing
            # analyzed on small ones.
            import traceback
            from buzzdetect_torch.runtime.coordination import ExitSignal
            # fully reported through the log channel (incl. traceback);
            # re-raising into the thread excepthook would only double-print
            self.coordinator.exit_analysis(ExitSignal(
                message=f'analyzer {self.id_analyzer} failed fatally: {e}; '
                        f'stopping analysis (finished chunks are '
                        f'checkpointed and the run is resumable)\n'
                        f'{traceback.format_exc()}',
                level='ERROR', end_reason='analyzer failure'))
        finally:
            self.coordinator.worker_exited('analyzer')

    def _run(self):
        self.log('launching', 'INFO')
        self.model.initialize()
        # after initialize: plugin models may only pick a backend on init
        self.log(f'processing on '
                 f'{self.processor or _describe_execution_target(self.model)}',
                 'INFO')
        with _dispatch_scope(self.model):
            self._serve()
        self.log('terminating', 'DEBUG')

    def _serve(self):
        """Warm up, then dispatch chunks until the exit sentinel."""
        self._warmup()

        batching = (self.batch_chunks > 1
                    and hasattr(self.model, 'predict_async_batch'))
        # the rate metric must not charge model load + warmup compiles
        # (tens of seconds) to the first chunk's wall time
        self.timer_analysis.restart()
        self.timer_bottleneck.restart()
        while True:
            a_chunk = self.coordinator.get_analyze()
            if a_chunk == 'exit':
                break
            if self.coordinator.event_exitanalysis.is_set():
                # interrupted: drain without analyzing; results=None keeps the
                # tracker consistent and the writer leaves the file partial
                a_chunk.results = None
                a_chunk.samples = None
                self.coordinator.put_write(a_chunk)
                continue
            self.timer_bottleneck.stop()
            if self.timer_bottleneck.get_total() > 0.01:
                self.report_bottleneck()
            exit_seen = False
            batch = [a_chunk]
            leftover = []
            try:
                if batching:
                    batch, leftover, exit_seen = self._drain_batch(a_chunk)
                    if len(batch) == 1:
                        self.process_chunk(batch[0])
                    else:
                        self.process_batch(batch)
                    for c in leftover:  # beyond the power-of-two cut
                        self.process_chunk(c)
                else:
                    self.process_chunk(a_chunk)
            except Exception as e:
                # keep the tracker consistent: EVERY chunk of the batch must
                # reach the writer so completion detection still fires.
                # Filter on `delivered` (set only after put_write), NOT on
                # `results is None` — an exception landing between the
                # results assignment and put_write (e.g. in report_rate)
                # would otherwise strand a results-bearing chunk and leave
                # its file an unfinalized partial forever.
                undelivered = [c for c in batch + leftover if not c.delivered]
                names = ', '.join(f'{c.file.shortpath_audio}{c.chunk}'
                                  for c in undelivered) or '<none>'
                self.log(f'error during analysis ({e}); chunks not yet '
                         f'delivered to writer: {names}', 'ERROR')
                for c in undelivered:
                    c.samples = None
                    self.coordinator.put_write(c)
                    c.delivered = True
            if exit_seen:
                break
            self.timer_bottleneck.restart()

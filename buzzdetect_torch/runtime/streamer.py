"""Streamer worker: file -> resumable chunk list -> decoded sample buffers.

Behavioral parity with the reference streamer (`src/stream/worker.py:20-165`):
resume-gap computation from partial CSVs, skip-finished / skip-tiny files,
self-heal of uncleaned completed partials, truncated-audio handling with the
BAD_READ_ALLOWANCE severity split, opportunistic mid-file exit.

TPU-era difference: the native decode stage returns mono float32 at the model
rate directly (downmix+resample fused into decode, off the GIL), so the hot
loop here is just read -> enqueue. Chunk positions are in model-rate samples.
"""

import os

import numpy as np

from buzzdetect_torch import config as cfg
from buzzdetect_torch.audio import build_track, get_duration
from buzzdetect_torch.runtime.assignments import AssignChunk, AssignFile, AssignLog
from buzzdetect_torch.utils import encode_wire
from buzzdetect_torch.write.coverage import (coverage_from_rows, get_gaps,
                                           smooth_gaps, gaps_to_chunklist,
                                           read_result_rows,
                                           quarantine_partial)


class WorkerStreamer:
    def __init__(self, id_streamer, model, chunklength, coordinator,
                 resample_on_device=False, result_header=None):
        self.id_streamer = id_streamer
        self.model = model
        self.coordinator = coordinator
        self.chunklength = chunklength
        # the exact header line this run's writer produces
        # (write/formatting.result_header). A partial under a DIFFERENT
        # header must not count as resume coverage: the writer quarantines
        # it on first append, so rows counted here would finalize a
        # complete file permanently missing those spans. None (tests,
        # direct construction) skips the pin.
        self.result_header = result_header
        self.framelength_s = model.embedder.framelength_s
        self.resample_rate = model.embedder.samplerate
        # with on-device resampling the decoder keeps the file's native rate
        # (target_rate=0) and chunks ride the wire unresampled; the model's
        # jit graph resamples on the accelerator (ops/resample.py) — zero
        # host CPU spent on resampling (the GPU-era decode ceiling,
        # reference docs/source/tuning.rst:57-62)
        self.decode_rate = 0 if resample_on_device else self.resample_rate

    def __call__(self):
        self.run()

    def log(self, msg, level_str):
        self.coordinator.q_log.put(AssignLog(
            message=f'streamer {self.id_streamer}: {msg}', level_str=level_str))

    def _quarantine(self, a_file: AssignFile, why: str):
        """Move an unusable partial aside and announce the full re-analysis."""
        path_corrupt = quarantine_partial(a_file.path_results_partial)
        self.log(f'{a_file.shortpath_audio}: partial result {why}; '
                 f'quarantined to {os.path.basename(path_corrupt)} and '
                 f'analyzing from scratch', 'WARNING')

    def handle_bad_read(self, a_file: AssignFile):
        """Truncated/corrupt audio mid-read: classify severity by how much of
        the file is lost (recorders dying at file end are routine)."""
        final_second = a_file.track.tell() / a_file.track.samplerate
        msg = (f'Unreadable audio at {round(final_second, 1)}s out of '
               f'{round(a_file.duration_audio, 1)}s for {a_file.shortpath_audio}.')
        if 1 - (final_second / a_file.duration_audio) > cfg.BAD_READ_ALLOWANCE:
            level = 'WARNING'
            msg += '\nAborting early due to corrupt audio data.'
        else:
            level = 'DEBUG'
            msg += '\nBad audio is near file end, results should be mostly unaffected.'
        self.log(msg, level)

    def _chunk_file(self, a_file: AssignFile):
        """Open the track and compute the (resume-aware) chunk list."""
        if os.path.exists(a_file.path_results_complete):
            # (stale partials behind a complete file are cleaned where
            # finalized files are filtered out — Analyzer.queue_assignments;
            # a file only reaches this branch if it finalized between
            # assignment and streaming)
            self.log(f'Skipping {a_file.shortpath_audio}; already analyzed',
                     'DEBUG')
            a_file.chunklist = []
            return

        if os.path.getsize(a_file.path_audio) < cfg.FILE_SIZE_MINIMUM:
            self.log(f'Skipping {a_file.shortpath_audio}; below minimum '
                     f'analyzeable size', 'DEBUG')
            a_file.chunklist = []
            return

        a_file.track = build_track(a_file.path_audio,
                                   target_rate=self.decode_rate)
        a_file.duration_audio = get_duration(a_file.track)

        if not os.path.exists(a_file.path_results_partial):
            gaps = [(0.0, a_file.duration_audio)]
        else:
            # ONE parse serves the schema pin, the coverage math, and the
            # debris-vs-finished distinction below
            header, rows, torn = read_result_rows(
                a_file.path_results_partial)
            if (self.result_header is not None and header is not None
                    and ','.join(header) != self.result_header):
                # schema pin: this partial was written under different
                # settings (mode/classes — e.g. a foreign partial copied
                # into this folder). Its rows must NOT count as coverage:
                # the writer quarantines such a partial on first append,
                # so counting them here would finalize a complete file
                # permanently missing the quarantined spans. Second line
                # of defense — the manifest guard already refuses runs
                # whose folder holds results it cannot attest
                # (manifest.check_or_write_manifest), which covers the
                # mismatches a header CANNOT show (threshold, framehop).
                self._quarantine(a_file, 'was written under a different '
                                         'output schema (header mismatch)')
                gaps = [(0.0, a_file.duration_audio)]
            else:
                # framehop-aware: at sparse hops (> framelength) a row
                # attests its whole stride, and torn rows force their
                # frame's re-analysis
                coverage = coverage_from_rows(header, rows, torn,
                                              self.framelength_s,
                                              framehop=self.model.embedder
                                              .framehop_s)
                a_file.has_results = bool(coverage)
                gaps = get_gaps((0, a_file.duration_audio), coverage)
                gaps = smooth_gaps(gaps, (0, a_file.duration_audio),
                                   framelength=self.framelength_s,
                                   gap_tolerance=self.framelength_s / 4)
                if not gaps:
                    if header is None or not rows:
                        # the partial attests NOTHING (0-byte, or a torn
                        # header whose rows all column-mismatch — SIGKILL
                        # debris from before the first flush): gaps can
                        # still come back empty for sub-framelength files
                        # because smooth_gaps drops end-adjacent gaps.
                        # Promoting would mark the file complete with zero
                        # data; quarantine the debris and analyze from
                        # scratch instead.
                        self._quarantine(a_file, 'has no usable rows')
                        gaps = [(0.0, a_file.duration_audio)]
                    else:
                        # finished but never finalized (e.g. killed
                        # mid-cleanup): self-heal by finalizing now
                        self.log(f'Discovered non-cleaned file at '
                                 f'{a_file.shortpath_audio}; cleaning '
                                 f'results', 'DEBUG')
                        from buzzdetect_torch.runtime.writer import \
                            finalize_partial
                        finalize_partial(a_file.path_results_partial,
                                         a_file.path_results_complete)
                        # counts in the run summary like any other
                        # finalization — this run DID produce the file
                        self.coordinator.record_finalized()
                        a_file.chunklist = []
                        return

        a_file.chunklist = gaps_to_chunklist(gaps, self.chunklength)

    def queue_chunk(self, a_file: AssignFile, chunk, force_last=False) -> bool:
        """Decode one chunk and enqueue it. Returns False to stop the file."""
        rate = a_file.track.samplerate
        sample_from = int(chunk[0] * rate)
        sample_to = int(chunk[1] * rate)
        read_size = sample_to - sample_from
        if read_size <= 0:
            # degenerate chunk (defense in depth — gaps_to_chunklist drops
            # these): nothing to analyze; keep the tracker consistent if it
            # was the final chunk (the resume self-heal finalizes next run)
            if force_last:
                self.coordinator.mark_stream_finished(a_file.ident)
            return True

        a_file.track.seek(sample_from)
        # decode straight to the wire dtype: the native stage fuses the
        # int16 quantize / mu-law compand into its fifo copy (zero extra
        # passes); drivers without the fused reader decode float and convert
        # here, in the decode threads, so the dispatch thread doesn't pay
        # it. Either way the prefetch ring holds the wire-sized buffers.
        wire = getattr(self.model, 'transfer_dtype', None) or 'float32'
        reader = getattr(
            a_file.track,
            {'int16': 'read_s16', 'mulaw': 'read_mulaw'}.get(wire, ''), None)
        if reader is not None:
            samples = reader(read_size)
        else:
            samples = encode_wire(
                a_file.track.read(read_size, dtype=np.float32), wire)

        if len(samples) < read_size:
            self.handle_bad_read(a_file)
            # embedder time precision like every other chunk boundary, and
            # never below the chunk start (a 1-decimal round here used to
            # produce inverted chunks and negative audio-seconds accounting)
            digits = self.model.embedder.digits_time
            chunk = (chunk[0],
                     max(chunk[0],
                         round(chunk[0] + len(samples) / rate, digits)))
            continue_file = False
            if (len(samples) == 0 and not a_file.has_results
                    and not a_file.queued_data):
                # the very FIRST read of a never-analyzed file produced no
                # samples (metadata-only container, e.g. truncated-off
                # mdat): finalizing would promote a header-only complete
                # and skip 100% of the audio forever. Fail the stream so
                # nothing promotes and a later run retries.
                self.coordinator.mark_stream_failed(a_file.ident)
                return False
            # otherwise a zero-sample read still queues the (empty) chunk
            # below: the writer must see this ident's last chunk or the
            # file is never finalized — a partial whose only remaining gap
            # sits at/after the real data end (container header overstating
            # the duration) would be re-probed on every run forever
        else:
            continue_file = True

        a_chunk = AssignChunk(file=a_file, chunk=chunk, samples=samples,
                              last_chunk=force_last or not continue_file,
                              input_rate=(rate if rate != self.resample_rate
                                          else None))
        self.coordinator.put_analyze(a_chunk)
        if len(samples) > 0:
            a_file.queued_data = True
        return continue_file

    def stream_to_queue(self, a_file: AssignFile):
        try:
            self._chunk_file(a_file)
            if not a_file.chunklist:
                # nothing to do: make sure the tracker can't dangle
                self.coordinator.mark_stream_finished(a_file.ident)
                return
            last_index = len(a_file.chunklist) - 1
            for i, chunk in enumerate(a_file.chunklist):
                # decode can be slow; bail opportunistically on exit.
                # FAILED, not finished: chunks i.. were never queued, and
                # 'finished' would let the writer promote a truncated
                # partial to a permanent complete result the moment the
                # already-queued chunks drain (silent data loss on every
                # interrupted run); 'failed' leaves a resumable partial
                if self.coordinator.event_exitanalysis.is_set():
                    self.coordinator.mark_stream_failed(a_file.ident)
                    return
                if not self.queue_chunk(a_file, chunk,
                                        force_last=(i == last_index)):
                    self.coordinator.mark_stream_finished(a_file.ident)
                    break
        except Exception as e:  # corrupt containers must not kill the worker
            self.log(f'error streaming {a_file.shortpath_audio}: {e}; '
                     f'finished chunks checkpoint, the rest resumes on a '
                     f'later run', 'ERROR')
            # FAILED, not merely finished: chunks after the error were never
            # queued, so the writer must leave the file a resumable partial
            # instead of promoting a silently truncated complete result
            self.coordinator.mark_stream_failed(a_file.ident)
        finally:
            if a_file.track is not None:
                a_file.track.close()
                a_file.track = None

    def run(self):
        self.log('launching', 'INFO')
        try:
            while True:
                a_file = self.coordinator.get_stream()
                if a_file == 'exit':
                    break
                # prompt shutdown: files still queued ahead of the poison
                # sentinels must not each pay a container-open + coverage
                # parse in _chunk_file just to discover the exit
                if self.coordinator.event_exitanalysis.is_set():
                    continue
                self.log(f'buffering {a_file.shortpath_audio}', 'INFO')
                self.stream_to_queue(a_file)
        finally:
            self.coordinator.worker_exited('streamer')
        self.log('terminating', 'INFO')

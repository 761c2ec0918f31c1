"""The orchestrator: the ``analyze()`` API and ``Analyzer`` class.

API parity with the reference orchestrator (`src/analyze.py:26-492`): same
kwargs, same defaults, same behaviors — chunklength rounded to whole frames,
threshold calibration from requested precision, manifest compatibility check,
ident-conflict and already-complete filtering, worker thread lifecycle, and
the end-of-run wall-time report.

Copy of ``buzzdetect_tpu/analysis.py`` with ``device`` threaded through
(``'cuda'`` unless the caller asks for ``'cpu'``; in replica mode it names
the device type that ``devices=N`` or ``'all'`` counts). ``host_shard=True``
takes its rank from ``torch.distributed`` (``parallel.process_rank``).
``mesh=`` splits each chunk over a ``parallel.Mesh`` of ``device``'s type
(``models/classifier.py``); a ``device=`` of another type raises.
"""

import os
import sys
import threading
import time
import warnings

from buzzdetect_torch import config as cfg
from buzzdetect_torch.audio import decoder_choice, driver_map
from buzzdetect_torch.manifest import build_manifest, check_or_write_manifest
from buzzdetect_torch.models.registry import load_model
from buzzdetect_torch.runtime.assignments import AssignFile, AssignLog
from buzzdetect_torch.runtime.coordination import Coordinator, ExitSignal
from buzzdetect_torch.runtime.inferer import WorkerInferer
from buzzdetect_torch.runtime.logger import WorkerLogger
from buzzdetect_torch.runtime.streamer import WorkerStreamer
from buzzdetect_torch.runtime.writer import WorkerWriter
from buzzdetect_torch.utils import Timer, get_ext, pid_alive, search_dir
from buzzdetect_torch.write.thresholds import calculate_threshold


_MSG_DEVICES_MESH_EXCLUSIVE = (
    'devices= (independent per-device replicas) and mesh= (sharding one '
    'chunk across devices) are mutually exclusive — pick one scale-out '
    'layout')


def _load_serving_models(modelname, framehop_prop, compute_dtype,
                         transfer_dtype, *, device='cuda', mesh=None,
                         replica_devices=None, conv_precision=None):
    """The ONE place a run's serving model(s) are constructed.

    Analyzer.__init__ (single-pass runs) and analyze()'s watch-mode
    shared block (models built once, reused every polling cycle) must
    configure models identically. Returns ``{'replica_models': [...]}``
    when ``replica_devices`` is given (one model per listed device, which
    may repeat), else ``{'model': m}`` on ``device`` or over ``mesh``.
    """
    kw = {'transfer_dtype': transfer_dtype} if transfer_dtype else {}
    if conv_precision:
        kw['conv_precision'] = conv_precision
    if replica_devices:
        return {'replica_models': [
            load_model(modelname, framehop_prop=framehop_prop,
                       initialize=False, compute_dtype=compute_dtype,
                       device=d, **kw) for d in replica_devices]}
    return {'model': load_model(modelname, framehop_prop=framehop_prop,
                                initialize=False,
                                compute_dtype=compute_dtype,
                                device=device, mesh=mesh, **kw)}


def run_worker(workerclass, **kwargs):
    worker = workerclass(**kwargs)
    worker()


from contextlib import contextmanager  # noqa: E402  (grouped with its users)


@contextmanager
def _dir_flock(dir_out):
    """Best-effort exclusive flock on the dir_out directory — the ONE
    serialization point for every judge-then-unlink on the run lock
    (_reclaim_stale_lock and both release paths share it). Yields
    regardless on platforms/filesystems without directory flock (no
    fcntl, unopenable dir, NFS nolock/ENOLCK): proceeding unserialized
    is no worse than the historical behavior, and crashing the self-heal
    would be."""
    try:
        import fcntl
        dfd = os.open(dir_out, os.O_RDONLY)
    except (OSError, ImportError):
        dfd = None
    try:
        if dfd is not None:
            try:
                fcntl.flock(dfd, fcntl.LOCK_EX)
            except OSError:
                pass
        yield
    finally:
        if dfd is not None:
            os.close(dfd)  # releases the flock


def _unlink_own_lock(dir_out, path, claim):
    """Release a run-lock claim: unlink ``path`` only if it still carries
    ``claim``. If the operator hand-deleted the lock mid-run (the
    documented escape hatch) and another run claimed the folder, the file
    on disk is THEIRS — a blind unlink would hand a third run the
    corruption window the lock prevents. The read-owner-then-unlink pair
    is serialized under the same directory flock _reclaim_stale_lock
    takes: unserialized, a hand-delete plus a sibling's fresh claim can
    land BETWEEN our owner read and the unlink, so the unlink would
    remove the new owner's live lock — the narrower TOCTOU the reclaim
    path already closes."""
    with _dir_flock(dir_out):
        owner = Analyzer._read_lock_owner(path)
        if owner is None or owner.get('claim') != claim:
            return
        try:
            os.unlink(path)
        except OSError:
            pass




class Analyzer:
    """Audio-analysis orchestrator: wires the model, the coordinator, and the
    worker threads together and runs one analysis to completion."""

    def __init__(self,
                 modelname: str,
                 classes_out='all',
                 precision: float = None,
                 framehop_prop: float = 1,
                 chunklength: float = 200,
                 dir_audio: str = cfg.DIR_AUDIO,
                 dir_out: str = None,
                 verbosity_print: str = 'INFO',
                 verbosity_log: str = 'DEBUG',
                 log_progress: bool = False,
                 coordinator: Coordinator = None,
                 compute_dtype=None,
                 profile_dir: str = None,
                 mesh=None,
                 batch_chunks: int = 1,
                 transfer_dtype: str = None,
                 strict_f32: bool = False,
                 profile: str = None,
                 resample_on_device: bool = False,
                 devices=None,
                 host_shard=None,
                 model=None,
                 replica_models=None,
                 device='cuda',
                 watch_state: dict = None,
                 watch_cycle: int = None,
                 quiet_startup: bool = False,
                 path_log: str = None,
                 alert_classes=None,
                 alert_threshold: float = None,
                 alert_command: str = None,
                 stall_timeout: float = None,
                 session_lock=None):
        if stall_timeout is not None and stall_timeout <= 0:
            raise ValueError(
                f'stall_timeout must be positive seconds (got '
                f'{stall_timeout!r})')
        self.stall_timeout = stall_timeout
        self.modelname = modelname
        # checked before the (slow) model load: a misconfigured hook should
        # fail in milliseconds, and it depends on no model state. Blank or
        # whitespace-only means "no hook" (the GUI form's empty-field
        # convention) — a bare shell would otherwise spawn per alert.
        if isinstance(alert_command, str):
            alert_command = alert_command.strip()
        if alert_command and alert_classes is None:
            raise ValueError(
                'alert_command without alert_classes does nothing; pass '
                'alert_classes=... to enable live alerts')
        self.alert_command = alert_command if alert_command else None
        # one-flag deployment profile (config.resolve_profile): fills
        # transfer_dtype/strict_f32 defaults the caller left unset, BEFORE
        # the model load below consumes them; the caveat note (mu-law on
        # digitally-silent content) re-emits through the run log once the
        # logger is up (startup_warnings)
        self.analysis_profile = profile
        transfer_dtype, strict_f32, self._profile_note = cfg.resolve_profile(
            profile, transfer_dtype, strict_f32)
        self.framehop_prop = framehop_prop
        self.dir_audio = dir_audio
        self.verbosity_print = verbosity_print
        self.verbosity_log = verbosity_log
        self.log_progress = log_progress
        self.profile_dir = profile_dir
        self.batch_chunks = batch_chunks
        self.coordinator = coordinator or Coordinator()
        # watch mode (see analyze(watch=...)): a dict carried across cycles
        # mapping audio path -> os.stat signature, used to re-examine
        # finalized files only when the recording actually changed on disk
        self.watch_state = watch_state
        self.watch_cycle = watch_cycle
        self.quiet_startup = quiet_startup
        self.path_log = path_log
        # watch mode: a SessionLock that holds the dir_out claim across ALL
        # passes of the watch loop (None for single-pass runs, which claim
        # and release per run). Without it, two concurrent watchers whose
        # short passes never overlap in time would alternate the per-pass
        # lock forever, both believing they own the folder.
        self.session_lock = session_lock

        if devices is not None and mesh is not None:
            raise ValueError(_MSG_DEVICES_MESH_EXCLUSIVE)
        self.replica_models = None
        if devices is not None:
            # per-device replica data parallelism: one classifier replica
            # on each listed device, each with its own dispatch thread, fed
            # independent chunks from the shared prefetch ring — the
            # reference's "multiple GPU analyzers" (docs/source/
            # tuning.rst:110-117). Zero collectives.
            from buzzdetect_torch.parallel import resolve_replica_devices
            devs = resolve_replica_devices(devices, device)
            if replica_models is not None:
                models = replica_models  # watch cycles share the replicas
            else:
                models = _load_serving_models(
                    modelname, framehop_prop, compute_dtype, transfer_dtype,
                    replica_devices=devs,
                    conv_precision='highest' if strict_f32 else None
                    )['replica_models']
            for m in models:
                if not hasattr(m, '_device'):
                    raise ValueError(
                        f'model {modelname} is a python plugin and cannot '
                        f'be pinned to a device; devices= requires a bundle '
                        f'model')
            # the coordinator may run SEVERAL dispatch threads per replica
            # (the per-device version of the reference's "multiple GPU
            # analyzers +~10%" knob, docs/source/tuning.rst:110-117); the
            # classifier is thread-safe, so threads i*k..(i+1)*k-1 share
            # replica i
            total = self.coordinator.analyzers_total
            if total % len(models) != 0:
                raise ValueError(
                    f'replica mode needs a whole number of dispatch '
                    f'threads per device: coordinator has {total} analyzers '
                    f'for {len(models)} replicas (call analyze(devices=...) '
                    f'which sizes it as replicas x analyzers_cpu)')
            per = total // len(models)
            self.model = models[0]
            self.replica_models = [m for m in models for _ in range(per)]
        elif model is not None:
            # watch cycles share one model so device params upload once,
            # not once per polling cycle
            self.model = model
        else:
            self.model = _load_serving_models(
                modelname, framehop_prop, compute_dtype, transfer_dtype,
                device=device, mesh=mesh,
                conv_precision='highest' if strict_f32 else None)['model']
        if resample_on_device and not getattr(
                self.model, 'supports_device_resample', False):
            raise ValueError(
                f'model {modelname} cannot resample on-device '
                f'(plugin models receive model-rate samples); drop '
                f'resample_on_device')
        self.resample_on_device = resample_on_device

        # multi-host data parallelism: this process analyzes only its stable
        # hash-assigned shard of the corpus (parallel.shard_files); hosts
        # share one output directory and need no communication — completion
        # state IS the filesystem
        if host_shard is True:
            from buzzdetect_torch.parallel import process_rank
            host_shard = process_rank()
        if host_shard is not None:
            # shape-check BEFORE unpacking: host_shard=1 or '0/4' must hit
            # this message, not a raw unpack TypeError
            if not (isinstance(host_shard, (tuple, list))
                    and len(host_shard) == 2
                    and all(isinstance(v, int) and not isinstance(v, bool)
                            for v in host_shard)
                    and 0 <= host_shard[0] < host_shard[1]):
                raise ValueError(
                    f'host_shard must be (host_id, n_hosts) with '
                    f'0 <= host_id < n_hosts, got {host_shard!r}')
            host_shard = (host_shard[0], host_shard[1])
        self.host_shard = host_shard

        self.precision = precision
        # bf16 guardrail: measured max activation deviation vs f32 is ~0.006
        # (docs/tuning.md "Knobs"), which exceeds the 1e-3 activations-parity
        # contract (BASELINE.md). Detections mode is insensitive — a 0.006
        # nudge only flips frames whose score already sits inside the
        # threshold's noise margin (regression-tested in test_classifier.py)
        # — but raw-activation readers must know the 3rd decimal is noise.
        # Setup-time warnings fire via warnings.warn for API callers AND are
        # stashed here to re-emit through the run's log channel once the
        # logger worker is up (_launch_logger): the GUI runs analyze() in a
        # spawned child whose stderr nobody sees — the log queue is the only
        # path that reaches its log pane (and the run's .log file).
        self.startup_warnings = []
        dtype = compute_dtype
        if model is not None and dtype is None:
            dtype = getattr(model, '_compute_dtype', None)
        if dtype is not None and 'bfloat16' in str(dtype) and precision is None:
            self._startup_warn(
                'compute_dtype=bfloat16 with activations output: measured '
                'max activation deviation vs float32 is ~0.006, exceeding '
                'the 1e-3 score-parity contract (still inside the 2-decimal '
                'output rounding; detections mode is insensitive). Use '
                'float32 where the parity contract matters.')
        if self._profile_note:
            # log-channel only (startup_warnings reaches the .log file and
            # the GUI pane): the profile is a deliberate choice, not an
            # API misuse worth a warnings.warn
            self.startup_warnings.append(self._profile_note)
        self.chunklength = self._setup_chunklength(chunklength)
        self.classes_out = self._setup_classes_out(classes_out)
        self.threshold = self._setup_threshold(precision)
        self.alert = self._setup_alert(alert_classes, alert_threshold)

        self.timer_total = Timer()
        # native rate hint so inferer warmup pre-compiles the resampling
        # program the run will dispatch (set by queue_assignments)
        self.warmup_rate = None

        # the ONE shared blank-dir_out rule (config.resolve_dir_out): a
        # library caller passing dir_out='' must resolve the same folder
        # the CLI/GUI surfaces would, not a cwd-relative ''
        self.dir_out = cfg.resolve_dir_out(dir_out, modelname)

        self.thread_logger = None
        self.thread_writer = None
        self.threads_streamers = []
        self.threads_analyzers = []
        # exact started-worker counts for interrupt-time poisoning,
        # incremented only after t.start() RETURNS (start waits on the
        # child's started event, so the count never includes a thread
        # that is not yet draining its queue). Thread.ident is NOT a
        # reliable signal here: it is assigned by the child, so the main
        # thread can read None for a streamer that is already consuming.
        self._started = {'streamers': 0, 'analyzers': 0, 'writer': 0}

    # --- setup -----------------------------------------------------------
    def _startup_warn(self, message, stacklevel=4):
        """warnings.warn now (API visibility) + stash for the run log (GUI
        and .log visibility — see startup_warnings in __init__).

        stacklevel 4 attributes a warning issued directly from __init__ to
        the analyze() caller's line (self -> __init__ -> analyze -> user);
        deeper setup helpers must add their own frame count."""
        warnings.warn(message, UserWarning, stacklevel=stacklevel)
        self.startup_warnings.append(message)

    def _setup_chunklength(self, chunklength):
        """Round to a whole number of frames so frames tile seamlessly across
        chunk boundaries at framehop 1 (reference `src/analyze.py:102-111`)."""
        fl = self.model.embedder.framelength_s
        chunklength = round(chunklength / fl) * fl
        chunklength = round(chunklength, self.model.embedder.digits_time)
        return max(chunklength, fl)

    def _setup_classes_out(self, classes_out):
        if classes_out == 'all':
            return list(self.model.config['classes'])
        # fail fast on typos and bare strings (iterated per-character!): a
        # bad class would otherwise burn the whole run and fail per-chunk
        # inside the writer — same contract as _setup_threshold
        if classes_out is not None and not isinstance(classes_out, str):
            # materialize ONCE up front: a generator/map/filter input would
            # be exhausted by the emptiness check below and then silently
            # yield an empty classes_out — zero-column result files
            classes_out = list(classes_out)
        if classes_out is None or isinstance(classes_out, str) \
                or not classes_out:
            # an empty list passes the membership check vacuously and would
            # archive result files with zero activation columns
            raise ValueError(
                f"classes_out must be 'all' or a non-empty list of class "
                f"names, got {classes_out!r}")
        bad = [c for c in classes_out
               if c not in self.model.config['classes']]
        if bad:
            raise ValueError(
                f'classes_out contains classes not in model '
                f'{self.modelname}: {bad} (model classes: '
                f"{list(self.model.config['classes'])})")
        return list(classes_out)

    def _setup_threshold(self, precision):
        if precision is None:
            return None
        if 'ins_buzz' not in self.model.config['classes']:
            # fail fast: detections mode thresholds the ins_buzz class; a
            # model without it would otherwise burn the whole run and fail
            # per-chunk inside the writer
            raise ValueError(
                f'model {self.modelname} has no "ins_buzz" class; '
                f'detections mode (precision=...) requires one — use '
                f'activations mode instead')
        return calculate_threshold(self.modelname, precision)

    def _setup_alert(self, alert_classes, alert_threshold):
        """(names, column indices, threshold, framelength_s) for live
        detection alerts, or None. Fail fast on typos/missing threshold —
        a bad alert config would otherwise surface per-chunk inside the
        writer, mid-run."""
        if alert_classes is None:
            if alert_threshold is not None:
                raise ValueError(
                    'alert_threshold without alert_classes does nothing; '
                    'pass alert_classes=... to enable live alerts')
            return None
        if isinstance(alert_classes, str):
            alert_classes = [alert_classes]
        # materialize ONCE: a generator input would survive the emptiness
        # check (generators are truthy) and then exhaust during the typo
        # scan, yielding an empty alert tuple — alerts silently disabled
        # in a feature built for unattended monitoring
        alert_classes = list(alert_classes)
        if not alert_classes:
            raise ValueError(
                'alert_classes is empty — pass at least one class name, '
                'or omit it to disable live alerts')
        classes = list(self.model.config['classes'])
        bad = [c for c in alert_classes if c not in classes]
        if bad:
            raise ValueError(
                f'alert_classes {bad} not in model {self.modelname} classes '
                f'{classes}')
        thr = alert_threshold if alert_threshold is not None \
            else self.threshold
        if thr is None:
            raise ValueError(
                'live alerts need a threshold: pass alert_threshold=... '
                'explicitly, or precision=... to calibrate one from the '
                'model metrics')
        # Alerts are designed to reproduce from the result files (the writer
        # mirrors the archive's comparison), but only for classes the archive
        # actually records: detections mode writes d_ins_buzz alone, and
        # activations mode writes only classes_out. Alerting on anything else
        # still works (live monitoring is the point) — warn that those
        # alerts can't be confirmed from the CSVs afterward.
        if self.threshold is not None:
            unarchived = [c for c in alert_classes if c != 'ins_buzz']
        else:
            unarchived = [c for c in alert_classes
                          if c not in self.classes_out]
        if unarchived:
            self._startup_warn(
                f'alert class(es) {unarchived} are not archived in the '
                f'result files (detections mode records only ins_buzz; '
                f'activations mode records only classes_out) — their '
                f'alerts cannot be re-derived from the CSVs afterward',
                stacklevel=5)  # user -> analyze -> __init__ -> _setup_alert
        if self.threshold is not None and float(thr) != self.threshold:
            self._startup_warn(
                f'alert_threshold {float(thr)} differs from the detections '
                f'threshold {self.threshold} the result files archive — '
                f'alerts and d_ rows will disagree by design (omit '
                f'alert_threshold to alert exactly on the archived '
                f'detections)', stacklevel=5)
        return (alert_classes,
                [classes.index(c) for c in alert_classes], float(thr),
                self.model.embedder.framelength_s)

    # --- worker lifecycle ---------------------------------------------------
    def _launch_logger(self):
        # store the resolved path so watch cycles can reuse the exact file;
        # multi-host runs share dir_out and can start the same second — tag
        # the filename with the host id so their logs never interleave
        host_tag = (f'_host{self.host_shard[0]}'
                    if self.host_shard is not None else '')
        self.path_log = self.path_log or os.path.join(
            self.dir_out,
            f"{self.timer_total.time_start.strftime('%Y-%m-%d_%H%M%S')}"
            f"{host_tag}.log")
        os.makedirs(os.path.dirname(self.path_log) or '.', exist_ok=True)
        self.thread_logger = threading.Thread(
            target=run_worker, name='logger', daemon=True,
            kwargs=dict(workerclass=WorkerLogger, path_log=self.path_log,
                        verbosity_print=self.verbosity_print,
                        verbosity_log=self.verbosity_log,
                        log_progress=self.log_progress,
                        coordinator=self.coordinator))
        self.thread_logger.start()

        # setup-time warnings, re-emitted through the log channel so they
        # reach the GUI pane and the .log file (the spawned child's stderr
        # is invisible there). Gated like the startup banner: watch mode
        # builds a fresh Analyzer every polling cycle (quiet_startup=True
        # after the first), and an identical WARNING every 30 s would bury
        # the log — the configuration can't change between cycles.
        if not self.quiet_startup:
            if self.framehop_prop > 1:
                from buzzdetect_torch.validation import FRAMEHOP_WARNING
                self.coordinator.q_log.put(
                    AssignLog(message=FRAMEHOP_WARNING, level_str='WARNING'))
            for message in self.startup_warnings:
                self.coordinator.q_log.put(
                    AssignLog(message=message, level_str='WARNING'))

    def _log_startup(self):
        if self.quiet_startup:
            return
        self.coordinator.q_log.put(AssignLog(message=(
            f'Model: {self.modelname}\n'
            f'Frame hop: {self.framehop_prop}\n'
            f'Threshold: {self.threshold}\n'
            f'Output classes: {", ".join(self.classes_out)}\n'
            f'Input directory: {self.dir_audio}\n'
            f'Output directory: {self.dir_out}\n'
            f'Analyzers: {self.coordinator.analyzers_total}\n'
            f'Chunk length: {self.chunklength}s\n'
            f'Streamers: {self.coordinator.streamers_total}\n'
            f'Queue depth: {self.coordinator.queue_depth}\n'
            f'Resample on device: {bool(self.resample_on_device)}\n'
            f'{decoder_choice()}\n'),
            level_str='INFO'))

    def _launch_streamers(self):
        from buzzdetect_torch.write.formatting import result_header
        header = result_header(self.model.config['classes'],
                               classes_keep=self.classes_out,
                               threshold=self.threshold)
        for s in range(self.coordinator.streamers_total):
            t = threading.Thread(
                target=run_worker, name=f'streamer_{s}', daemon=True,
                kwargs=dict(workerclass=WorkerStreamer, id_streamer=s,
                            model=self.model, chunklength=self.chunklength,
                            coordinator=self.coordinator,
                            resample_on_device=self.resample_on_device,
                            result_header=header))
            self.threads_streamers.append(t)
            t.start()
            self._started['streamers'] += 1

    def _launch_analyzers(self):
        # replica mode: thread a gets replica a (its own device's
        # classifier); otherwise every dispatch thread shares one model
        models = (self.replica_models if self.replica_models is not None
                  else [self.model] * self.coordinator.analyzers_total)
        for a in range(self.coordinator.analyzers_total):
            t = threading.Thread(
                target=run_worker, name=f'analyzer_{a}', daemon=True,
                kwargs=dict(workerclass=WorkerInferer, id_analyzer=a,
                            model=models[a], coordinator=self.coordinator,
                            batch_chunks=self.batch_chunks,
                            warmup_rate=self.warmup_rate,
                            warmup_samples=int(
                                self.chunklength
                                * self.model.embedder.samplerate)))
            self.threads_analyzers.append(t)
            t.start()
            self._started['analyzers'] += 1

    def _launch_writer(self):
        self.thread_writer = threading.Thread(
            target=run_worker, name='writer', daemon=True,
            kwargs=dict(workerclass=WorkerWriter,
                        classes_out=self.classes_out,
                        threshold=self.threshold,
                        classes=self.model.config['classes'],
                        framehop_s=self.model.embedder.framehop_s,
                        digits_time=self.model.embedder.digits_time,
                        digits_results=self.model.config.get(
                            'digits_results', 2),
                        coordinator=self.coordinator,
                        alert=self.alert,
                        alert_command=self.alert_command))
        self.thread_writer.start()
        self._started['writer'] = 1

    def _launch_stall_watchdog(self):
        """Warn when NO results land within cfg.STALL_WARNING_S of launch;
        optionally (``stall_timeout=``) STOP the run when progress halts.

        A dead device backend hangs the first dispatch indefinitely
        (a hung device stalls the first dispatch with no error),
        which reads as a silent mid-startup freeze. The default watchdog
        cannot distinguish a hang from a legitimately long first compile,
        so it only WARNS — pointing at the doctor — and never kills the
        run. With ``stall_timeout`` set, a second (opt-in) watchdog ends
        the run loudly when NO chunk lands for that many seconds at ANY
        point — the link can also die mid-run, where a blocked dispatch
        is not a dead worker and fatal-death detection never fires. A
        loud stop is safe by construction: finished chunks are already
        checkpointed and a rerun resumes byte-identically (the SIGKILL
        durability contract), which is exactly what an unattended
        deployment's supervisor should do.
        """
        def watch():
            import time
            poll = min(5.0, max(0.05, cfg.STALL_WARNING_S / 10))
            t0 = time.monotonic()
            while not self.coordinator.event_exitanalysis.wait(poll):
                if self.coordinator.audio_seconds_done > 0:
                    return
                if time.monotonic() - t0 > cfg.STALL_WARNING_S:
                    self.coordinator.log(
                        f'no results in {cfg.STALL_WARNING_S:.0f}s — a '
                        f'first-time kernel build can take a while, but an '
                        f'unreachable device hangs exactly like this; '
                        f'triage with `python -m buzzdetect_torch.doctor` '
                        f'(or nvidia-smi) in another shell', 'WARNING')
                    return

        def watch_hard(timeout=self.stall_timeout):
            import time
            poll = min(5.0, max(0.05, timeout / 10))
            last, t_last = -1.0, time.monotonic()
            while not self.coordinator.event_exitanalysis.wait(poll):
                done = self.coordinator.audio_seconds_done
                if done != last:
                    last, t_last = done, time.monotonic()
                    continue
                if time.monotonic() - t_last > timeout:
                    self.coordinator.exit_analysis(ExitSignal(
                        message=(
                            f'device stall: no chunk completed in '
                            f'{timeout:.0f}s — the device may have hung '
                            f'mid-run (check it with nvidia-smi). Stopping; '
                            f'finished chunks are checkpointed and a rerun '
                            f'resumes exactly where this stopped.'),
                        level='CRITICAL', end_reason='device stall'))
                    return

        threading.Thread(target=watch, name='stall-watchdog',
                         daemon=True).start()
        if self.stall_timeout is not None:
            threading.Thread(target=watch_hard, name='stall-killer',
                             daemon=True).start()

    # --- assignment / guard logic ---------------------------------------------
    def _check_manifest(self):
        manifest = build_manifest(modelname=self.modelname,
                                  framehop_prop=self.framehop_prop,
                                  precision=self.precision,
                                  classes_out=self.classes_out,
                                  profile=self.analysis_profile)
        ok, msg = check_or_write_manifest(self.dir_out, manifest)
        if not ok:
            self.coordinator.exit_analysis(ExitSignal(
                message=msg, level='ERROR', end_reason='manifest mismatch'))
        return ok

    def queue_assignments(self):
        if os.path.isfile(self.dir_audio):
            # a single recording instead of a directory: analyze just it
            # (root = its parent, so ident = basename and the result is
            # dir_out/<name>_buzzdetect.csv). The reference only accepts
            # directories (`src/analyze.py:273-289`); this is a deliberate
            # quality-of-life superset — without it, a file path would
            # "complete" silently with an empty output directory.
            if get_ext(self.dir_audio) not in driver_map:
                # a fatal configuration error, not a 'no files yet' state:
                # the end_reason must NOT be in the watch loop's healthy
                # set — an unsupported extension can never heal, so a
                # watcher must stop instead of warning every cycle
                self.coordinator.exit_analysis(ExitSignal(
                    message=(f'{self.dir_audio} is not a supported audio '
                             f'format; must be one of: '
                             f'{", ".join(driver_map)}'),
                    level='ERROR', end_reason='unsupported input'))
                return False
            root = os.path.dirname(os.path.abspath(self.dir_audio))
            found = [os.path.abspath(self.dir_audio)]
        else:
            root = self.dir_audio
            found = search_dir(self.dir_audio, list(driver_map))
        assignments = [
            AssignFile(path_audio=p, dir_audio=root,
                       dir_results=self.dir_out)
            for p in found
        ]
        watching = self.watch_state is not None
        if not assignments:
            self.coordinator.exit_analysis(ExitSignal(
                message=(f'Exiting analysis: no compatible audio files found '
                         f'in raw directory {self.dir_audio}.\naudio format '
                         f'must be one of: \n{", ".join(driver_map)}'),
                # in watch mode an empty directory is the normal state while
                # waiting for a recorder to start writing — don't warn
                level='DEBUG' if watching else 'WARNING',
                end_reason='no files'))
            return False

        if self.host_shard is not None:
            # conflict detection below stays GLOBAL (every host sees the
            # same listing and drops the same colliding idents); only the
            # work partition is sharded
            from buzzdetect_torch.parallel import shard_files
            mine = set(shard_files([a.path_audio for a in assignments],
                                   host_id=self.host_shard[0],
                                   n_hosts=self.host_shard[1],
                                   root=root))
        else:
            mine = None

        # files whose idents collide (same name, different extension) would
        # interleave rows in one result file; drop them with a warning
        from collections import Counter, defaultdict
        counts = Counter(a.ident for a in assignments)
        conflicting = {i for i, c in counts.items() if c > 1}
        by_ident = defaultdict(list)
        for a in assignments:
            if a.ident in conflicting:
                by_ident[a.ident].append(a.shortpath_audio)
        for ident in sorted(conflicting):
            paths = by_ident[ident]
            self.coordinator.q_log.put(AssignLog(
                message=(f'The following files have conflicting names and '
                         f'will be skipped:\n{", ".join(paths)}\nThese files '
                         f'must be renamed before they can be analyzed.'),
                level_str='WARNING'))

        unfinished, finalized = [], []
        for a in assignments:
            if a.ident in conflicting:
                continue
            if mine is not None and a.path_audio not in mine:
                continue  # another host's shard (incl. its watch demotions)
            if os.path.exists(a.path_results_complete):
                finalized.append(a)
                # a crash between finalization's promote and its partial
                # removal leaves a stale partial behind the complete file;
                # left alone it would silently resurrect old coverage if the
                # user deletes the complete CSV to force re-analysis
                if os.path.exists(a.path_results_partial):
                    try:
                        os.remove(a.path_results_partial)
                    except OSError:
                        pass
            else:
                unfinished.append(a)
        if watching:
            unfinished.extend(self._demote_grown(finalized))
        if not unfinished:
            where = (f"this host's shard "
                     f"({self.host_shard[0] + 1} of {self.host_shard[1]}) of "
                     f"{self.dir_audio}" if self.host_shard is not None
                     else self.dir_audio)
            self.coordinator.exit_analysis(ExitSignal(
                message=(f'All files in {where} are fully analyzed; '
                         f'exiting analysis'),
                level='DEBUG' if watching else 'INFO',
                end_reason='fully analyzed'))
            return False

        if self.resample_on_device and unfinished:
            # probe the first file's native rate so warmup runs the
            # resampling path this run will dispatch (a mixed-rate corpus
            # meets each further rate at its first chunk)
            try:
                from buzzdetect_torch.audio import build_track
                track = build_track(unfinished[0].path_audio, target_rate=0)
                try:
                    rate = track.samplerate
                finally:
                    track.close()
                if rate != self.model.embedder.samplerate:
                    self.warmup_rate = rate
            except (ValueError, RuntimeError, OSError):
                # UnsupportedFormat, DecodeError, a vanished file: a corrupt
                # first file fails loudly later, in its streamer
                pass

        for a_file in unfinished:
            self.coordinator.q_stream.put(a_file)
        return True

    def _demote_grown(self, finalized):
        """Watch mode: a finalized recording whose audio file has since grown
        (a recorder appending to it) is demoted back to a partial result so
        the gap-resume machinery analyzes the new tail. Files are only
        re-examined when their on-disk stat signature changed since the last
        look, so a static file — including one finalized early over a corrupt
        tail — is inspected at most once, not every polling cycle."""
        from buzzdetect_torch.audio import build_track, get_duration
        from buzzdetect_torch.write.coverage import (coverage_from_csv,
                                                   get_gaps, smooth_gaps)
        grown = []
        fl = self.model.embedder.framelength_s
        for a in finalized:
            try:
                st = os.stat(a.path_audio)
                sig = (st.st_size, st.st_mtime_ns)
                if self.watch_state.get(a.path_audio) == sig:
                    continue
                track = build_track(a.path_audio)
                try:
                    duration = get_duration(track)
                finally:
                    track.close()
                # framehop-aware, exactly like the streamer's resume read
                # (streamer.py:91): at sparse hops a row attests its whole
                # stride; melting with only framelength would read every
                # inter-row stride of a fully-covered file as a gap and
                # demote/re-analyze it on each signature change
                coverage = coverage_from_csv(
                    a.path_results_complete, fl,
                    framehop=self.model.embedder.framehop_s)
                gaps = smooth_gaps(get_gaps((0, duration), coverage),
                                   (0, duration), framelength=fl,
                                   gap_tolerance=fl / 4)
                if gaps:
                    # drop trailing rows whose patch window may have scored
                    # zero padding past the then-EOF (padding extends less
                    # than one patch window beyond it), so the seam is
                    # re-scored against the real audio — otherwise each
                    # grow/finalize cycle would bake in one padded row
                    self._demote_to_partial(
                        a, fl, self.model.embedder.lookahead_s)
                    grown.append(a)
                    self.coordinator.q_log.put(AssignLog(
                        message=(f'{a.shortpath_audio} grew to '
                                 f'{round(duration, 1)}s since it was '
                                 f'finalized; analyzing the new audio'),
                        level_str='INFO'))
                # record the signature only after the examination (and any
                # demotion) succeeded — a transient IO error must leave the
                # file eligible for re-examination next cycle
                self.watch_state[a.path_audio] = sig
            except Exception as e:
                self.coordinator.q_log.put(AssignLog(
                    message=(f'could not re-examine finalized file '
                             f'{a.shortpath_audio}: {e}'),
                    level_str='WARNING'))
        # deleted/rotated recordings must not pin state entries forever
        for path in [p for p in self.watch_state if not os.path.exists(p)]:
            del self.watch_state[path]
        return grown

    @staticmethod
    def _demote_to_partial(a, framelength, lookahead_s=None):
        """Turn a finalized result back into a partial, dropping rows whose
        analysis window may have scored zero padding past the audio's
        then-EOF.

        The margin is one patch window PLUS the embedder's DECLARED
        look-ahead (``BaseEmbedder.lookahead_s``): a patch starting at t
        consumes audio through t + framelength + lookahead, so a row up
        to that much before the old EOF can carry padded DSP input (for
        YAMNet, the STFT window-completion tail: window - hop = 15 ms,
        declared as 60 ms for margin). A plugin embedder that does not
        declare its tail gets a conservative FULL framelength — the
        plugin contract nowhere bounds an undeclared DSP's look-ahead,
        and a too-small margin silently bakes padded scores into every
        watch-mode seam. Dropping a row costs nothing but its re-scoring
        — the demoted gap re-analyzes it against the real audio — while
        keeping one diverges from what a fresh non-watch run produces.
        """
        tail = framelength if lookahead_s is None else float(lookahead_s)
        # the ONE definition of a valid row (write/coverage.py) — a blank
        # or hand-damaged line in a finalized CSV must be skipped like
        # resume itself would skip it, not raise out of the demotion (the
        # stat signature is only recorded after success, so a raise here
        # re-warned on the identical file every watch cycle forever)
        from buzzdetect_torch.write.coverage import read_result_rows
        header, rows, _torn = read_result_rows(a.path_results_complete)
        if header is None:
            raise ValueError('finalized result has no parseable header')
        idx = header.index('start')
        starts = [float(r[idx]) for r in rows]
        if starts:
            cutoff = max(starts) - framelength - tail + 1e-9
            rows = [r for r, s in zip(rows, starts) if s < cutoff]
        with open(a.path_results_partial, 'w') as f:
            f.write('\n'.join([','.join(header)]
                              + [','.join(r) for r in rows]) + '\n')
        os.remove(a.path_results_complete)

    def _lock_path(self):
        fname = cfg.FNAME_LOCK
        if self.host_shard is not None:
            # hosts legitimately share dir_out (disjoint file shards), so
            # each locks only against a second run of ITS OWN shard — the
            # same per-host tagging as the log and the run summary
            fname = f'{fname}_host{self.host_shard[0]}'
        return os.path.join(self.dir_out, fname)

    def _acquire_lock(self) -> bool:
        """Claim dir_out for this run, or refuse loudly.

        TWO live runs appending into the same output folder interleave
        buffered rows in the partial CSVs — parseable-but-wrong data the
        torn-row guards (built for KILLED writers, not live ones) cannot
        detect. The reference has no guard here; this one is
        liveness-checked so a SIGKILLed run's stale lock self-heals:

        * the claim is ``os.link(tmp, path)`` of a fully-written temp
          file (atomic like O_EXCL, but the lock NAME never appears
          without its json content — with create-then-write, a racer
          reading the empty window would judge a live lock "corrupt
          stale" and delete it);
        * an existing lock from THIS host whose pid is dead is stale.
          Stale removal is serialized by an flock on the dir_out
          directory and RE-JUDGED under it: two racers that both read
          the same stale lock would otherwise both unlink — the second
          unlink landing on the first racer's fresh live lock;
        * an existing lock from another host can't be liveness-checked,
          so it refuses with the owner's identity and what to do.

        On refusal the run ends with end_reason 'already running' and —
        deliberately — writes NO run summary: the folder's summary marker
        belongs to the live owner, and clobbering it would corrupt the
        telemetry of the run that actually holds the lock.
        """
        import json
        import socket
        import uuid
        path = self._lock_path()
        # the claim token identifies THIS acquisition, not just this
        # process: (pid, host) cannot distinguish two runs in one process
        # (threads share the pid — analyze() is a library API), so after
        # an operator hand-deletes a lock mid-session, a sibling run's
        # fresh lock would read as "ours" under a pid/host check and both
        # the session re-verify and the release would treat it as owned
        me = {'pid': os.getpid(), 'host': socket.gethostname(),
              'claim': uuid.uuid4().hex,
              'started': self.timer_total.time_start.isoformat(
                  sep=' ', timespec='seconds')}
        os.makedirs(self.dir_out, exist_ok=True)
        # pid+tid-unique: racing PROCESSES never share a temp name, and
        # neither do racing THREADS in one process (same pid!) — a
        # thread's finally-unlink must never land on a sibling's temp
        # while the sibling sits between open() and link().
        tmp = f'{path}.{os.getpid()}.{threading.get_ident()}.tmp'
        with open(tmp, 'w') as f:
            json.dump(me, f)
        try:
            for attempt in (0, 1):
                try:
                    # the CLAIM takes the same directory flock the
                    # reclaim/release paths serialize under: without it, a
                    # hand-delete plus this fresh link can land inside a
                    # releasing run's flock-held read->unlink window, and
                    # that release would remove THIS live lock. (The
                    # reclaim below runs OUTSIDE the flock — it takes its
                    # own; nesting two opens of the same directory would
                    # self-deadlock the thread.)
                    with _dir_flock(self.dir_out):
                        try:
                            os.link(tmp, path)
                        except FileExistsError:
                            raise
                        except OSError:
                            # filesystem without hard links: O_EXCL
                            # fallback (re-opens the content-less window,
                            # but only where link() itself is unavailable)
                            fd = os.open(path,
                                         os.O_CREAT | os.O_EXCL
                                         | os.O_WRONLY)
                            with os.fdopen(fd, 'w') as f, open(tmp) as t:
                                f.write(t.read())
                    self._lock_held = True
                    self._lock_claim = me['claim']
                    return True
                except FileExistsError:
                    owner = self._read_lock_owner(path)
                    stale = (owner is None
                             or (owner.get('host') == me['host']
                                 and not pid_alive(owner.get('pid'))))
                    if stale and attempt == 0:
                        self._reclaim_stale_lock(path, me)
                        continue  # re-claim; a live racer wins the link
                    who = (f"pid {owner.get('pid')} on {owner.get('host')}, "
                           f"started {owner.get('started')}"
                           if owner else 'unreadable lock')
                    self.coordinator.exit_analysis(ExitSignal(
                        message=(f'another analysis ({who}) is already '
                                 f'writing into {self.dir_out}; two live '
                                 f'runs would interleave rows in the same '
                                 f'result files. Wait for it, stop it, or '
                                 f'— if you are CERTAIN it is dead (a '
                                 f'crashed run on another machine) — '
                                 f'delete {path} and rerun.'),
                        level='ERROR', end_reason='already running'))
                    return False
            return False
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    @staticmethod
    def _read_lock_owner(path):
        """The lock's json, or None for unreadable/corrupt (stale by
        definition: link-based claiming never publishes a content-less
        lock, so no LIVE owner can present as unreadable)."""
        import json
        try:
            with open(path) as f:
                return json.load(f)
        except Exception:
            return None

    def _reclaim_stale_lock(self, path, me):
        """Unlink a lock judged stale — serialized and re-judged.

        The judge-then-unlink sequence is the classic TOCTOU: two racers
        both read the same dead owner; the first unlinks and claims; the
        second's unlink then removes the first's LIVE lock and both runs
        proceed. An exclusive flock on the dir_out directory serializes
        same-host reclaimers (the only ones that can judge liveness), and
        the staleness verdict is recomputed under it, so the second racer
        sees the first's fresh lock and leaves it alone. Cross-host locks
        never reach here (they refuse above). Best-effort on filesystems
        without directory flock: falls back to blind unlink, no worse
        than the unserialized behavior.
        """
        with _dir_flock(self.dir_out):
            owner = self._read_lock_owner(path)
            if os.path.exists(path) and (
                    owner is None
                    or (owner.get('host') == me['host']
                        and not pid_alive(owner.get('pid')))):
                try:
                    os.unlink(path)
                except OSError:
                    pass

    def _release_lock(self):
        if not getattr(self, '_lock_held', False):
            return
        self._lock_held = False
        _unlink_own_lock(self.dir_out, self._lock_path(),
                         getattr(self, '_lock_claim', None))

    def _write_run_summary(self, running=False, crash_reason=None):
        """Machine-readable run outcome: ``buzzdetect_run_summary.json``
        in dir_out, atomically replaced at run START and on EVERY end
        path.

        The supervisor-facing counterpart of the CLI's exit-code
        contract (cli.py scripting contract): an unattended deployment reacts
        to HOW a run ended — and to its counts — without parsing the
        human log (the reference offers only the log text).

        The start-of-run write (``running=True``: ``end_reason
        'running'``, ``ok false``) exists for the paths that never reach
        a normal end write — SIGKILL, power loss — so a previous
        attempt's ``ok: true`` can never masquerade as the outcome of a
        crashed rerun. ``crash_reason`` covers the in-process analog: an
        unexpected exception escaping the run loop stamps ``crashed:
        <type>`` on the way out (the finally in ``_run``).

        Multi-host runs share dir_out, so the filename carries the host
        tag (``buzzdetect_run_summary_host<N>.json``) exactly like the
        per-run log — hosts must not clobber each other's outcome.

        Best-effort by design: a full disk, a read-only dir_out, or an
        unserializable field must not replace the run's real outcome
        with a summary error, so ANY failure here logs a WARNING and
        nothing more. In watch mode each pass atomically re-replaces the
        file, so it always describes the latest pass.
        """
        try:
            self._write_run_summary_inner(running=running,
                                          crash_reason=crash_reason)
        except Exception as e:
            # the whole summary is best-effort: it runs in _run's finally,
            # where an escaping exception would mask the run's real error
            # AND skip the lock release + logger shutdown after it
            try:
                self.coordinator.q_log.put(AssignLog(
                    message=f'could not build the run summary: '
                            f'{type(e).__name__}: {e}',
                    level_str='WARNING'))
            except Exception:
                pass

    def _write_run_summary_inner(self, running=False, crash_reason=None):
        import json
        from datetime import datetime

        from buzzdetect_torch import __version__
        from buzzdetect_torch.runtime.coordination import HEALTHY_END_REASONS
        if running:
            reason, finished = 'running', None
        else:
            reason = crash_reason or self.coordinator.end_reason or 'unknown'
            finished = datetime.now().isoformat(sep=' ', timespec='seconds')
        wall = self.timer_total.get_total()
        if wall <= 0:  # early end paths never call timer.stop()
            wall = round(self.timer_total.get_current(), 2)
        audio_s = float(self.coordinator.audio_seconds_done)
        record = {
            'schema': 'buzzdetect_run_summary/1',
            'buzzdetect_version': __version__,
            'modelname': str(self.modelname),
            # float()/str() coercions throughout: callers hand in numpy
            # scalars (np.float64 framehop from a sweep script), which
            # json.dump rejects
            'framehop_prop': float(self.framehop_prop),
            'precision': (None if self.precision is None
                          else float(self.precision)),
            'classes_out': [str(c) for c in self.classes_out],
            'dir_audio': str(self.dir_audio),
            'host_shard': (list(map(int, self.host_shard))
                           if self.host_shard is not None else None),
            'watch': self.watch_state is not None,
            # which polling pass this file describes (they all replace the
            # same path, so without the counter a supervisor can't tell a
            # fresh pass from a wedged watcher re-reporting pass 1)
            'watch_cycle': (None if self.watch_cycle is None
                            else int(self.watch_cycle)),
            'end_reason': reason,
            'ok': reason in HEALTHY_END_REASONS,
            # which process wrote this file: lets a supervisor (and the
            # GUI's outcome line) tell ITS run's summary from a summary
            # written by a DIFFERENT live run into the same folder — a
            # lock-refused attempt must not read the owner's 'running'
            # marker as its own death
            'pid': os.getpid(),
            'started': self.timer_total.time_start.isoformat(
                sep=' ', timespec='seconds'),
            'finished': finished,
            'wall_s': float(wall),
            'audio_seconds': round(audio_s, 2),
            'rate_realtime': round(audio_s / wall, 2) if wall > 0 else 0.0,
            'chunks': int(self.coordinator.chunks_done),
            'files_finalized': int(self.coordinator.files_finalized),
            'files_failed': self.coordinator.failed_streams_snapshot(),
            # final notification-hook counters (None without alert_command)
            'alerts': getattr(self.coordinator, 'alert_stats', None),
        }
        fname = cfg.FNAME_RUN_SUMMARY
        if self.host_shard is not None:
            stem, ext = os.path.splitext(fname)
            fname = f'{stem}_host{self.host_shard[0]}{ext}'
        path = os.path.join(self.dir_out, fname)
        tmp = path + '.tmp'
        try:
            os.makedirs(self.dir_out, exist_ok=True)
            with open(tmp, 'w') as f:
                json.dump(record, f, indent=2)
                f.write('\n')
            os.replace(tmp, path)
        except Exception as e:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            # the logger worker is still up (callers summarize BEFORE
            # shutting it down), so this reaches the run log and console
            self.coordinator.q_log.put(AssignLog(
                message=f'could not write {fname}: '
                        f'{type(e).__name__}: {e}',
                level_str='WARNING'))

    # --- run ------------------------------------------------------------------
    def run(self):
        if self.profile_dir:
            # a torch.profiler trace of the whole run (view it in
            # TensorBoard's profiler plugin or in Perfetto): the CPU ops of
            # every thread (inference runs on the analyzer_* threads, and
            # the profiler records only the thread that starts it unless
            # told otherwise), the model step's spans (runtime/spans.py)
            # and, on the card, every kernel and copy
            from torch.profiler import (ProfilerActivity, _ExperimentalConfig,
                                        profile, tensorboard_trace_handler)
            activities = [ProfilerActivity.CPU]
            device = getattr(self.model, 'device', None)
            if device is not None and device.type == 'cuda':
                activities.append(ProfilerActivity.CUDA)
            with profile(activities=activities,
                         experimental_config=_ExperimentalConfig(
                             profile_all_threads=True),
                         on_trace_ready=tensorboard_trace_handler(
                             self.profile_dir)):
                return self._run()
        return self._run()

    def _run(self):
        self._log_startup()
        self._launch_logger()

        def shutdown_logger():
            self.coordinator.q_log.put(
                AssignLog(message='', level_str='INFO', terminate=True))
            self.thread_logger.join()

        # the lock comes BEFORE the summary marker: when another run owns
        # this folder, writing our marker would clobber ITS telemetry.
        # Watch sessions claim through their SessionLock, which holds the
        # claim ACROSS passes (the lock's "TWO live runs" rationale applies
        # at session granularity for watchers: per-pass locking would let
        # two watchers with non-overlapping sub-second passes alternate the
        # folder forever); each pass still re-verifies ownership for
        # liveness (a hand-deleted or clobbered lock file is re-claimed).
        if self.session_lock is not None:
            acquired = self.session_lock.ensure(self)
        else:
            acquired = self._acquire_lock()
        if not acquired:
            shutdown_logger()
            return
        # start-of-run marker (end_reason 'running', ok false): a SIGKILL
        # or power loss never reaches the end-path write below, and the
        # PREVIOUS attempt's ok:true must not survive as this attempt's
        # apparent outcome
        self._write_run_summary(running=True)

        try:
            self._run_body()
        finally:
            # EVERY in-process end path lands here — normal completion,
            # early refusals, interrupts, and unexpected exceptions (which
            # stamp 'crashed: <type>' and then propagate)
            exc = sys.exc_info()[1]
            crash = (f'crashed: {type(exc).__name__}'
                     if exc is not None
                     and self.coordinator.end_reason is None else None)
            self._write_run_summary(crash_reason=crash)
            self._release_lock()
            shutdown_logger()

    def _run_body(self):
        try:
            if not self._check_manifest() or not self.queue_assignments():
                return

            for _ in range(self.coordinator.streamers_total):
                self.coordinator.q_stream.put('exit')

            self._launch_writer()
            self._launch_streamers()
            self._launch_analyzers()
            self._launch_stall_watchdog()

            self.coordinator.wait_for_exit(
                threads_streamers=self.threads_streamers,
                threads_analyzers=self.threads_analyzers,
                thread_writer=self.thread_writer)
        except KeyboardInterrupt:
            # Ctrl-C: orderly stop — finished chunks are already checkpointed
            # and the run is resumable. A second Ctrl-C hard-exits. The
            # interrupt may land before the writer (or any worker) was
            # launched — e.g. during a slow queue_assignments over a huge
            # tree — so guard every join on the thread existing.
            self.coordinator.exit_analysis(ExitSignal(
                message='keyboard interrupt — stopping; finished chunks are '
                        'saved, rerun to resume', level='WARNING',
                end_reason='interrupted'))
            # The interrupt may also land AFTER the workers launched but
            # BEFORE wait_for_exit started its watcher threads — then
            # nobody else poisons the queues, the writer blocks forever on
            # q_write.get(), and its queued chunks are never checkpointed
            # (the join below would burn its full timeout for nothing).
            # poison_all is idempotent, so the overlap with a watcher that
            # DID start is harmless. Pass the LAUNCHED counts: a stage
            # whose workers never started never drains its queue, and
            # poisoning it past the queue bound would spin forever (e.g.
            # 8 replicas over a 4-slot q_analyze, interrupted before
            # _launch_analyzers).
            # count only workers that actually STARTED (_started is
            # incremented after each t.start() returns): len(threads)
            # over-counts when the interrupt lands between append and
            # start — and the extra sentinel can spin _poison forever on
            # a stage whose queue still holds backlog after its real
            # workers exited (the never-started thread never drains it).
            # The residual window (interrupt between start() returning
            # and the increment) under-counts by one: that worker parks
            # on its queue as a daemon thread — bounded leakage, chosen
            # over the unbounded spin of over-counting.
            self.coordinator.poison_all(
                streamers=self._started['streamers'],
                analyzers=self._started['analyzers'],
                writer=self._started['writer'])
            # writer drain handled by the generic non-completed join below
            # (end_reason is 'interrupted' unless the run already finished,
            # in which case wait_for_exit joined the writer)

        if (self.coordinator.end_reason != 'completed'
                and self.thread_writer is not None):
            # early exit (stop event / q_earlyexit): wait_for_exit returns
            # the moment the event fires, while the writer may still be
            # draining its backlog into the partials. Returning to the
            # caller now would let a rerun over the same dir_out start a
            # SECOND writer appending to the same files (interleaved
            # buffered rows read as torn and are silently dropped at
            # finalization). The bound keeps a wedged writer from hanging
            # the stop forever; poison_all has already woken it.
            self.thread_writer.join(timeout=30)

        self.timer_total.stop()
        if self.coordinator.end_reason == 'completed':
            wall = self.timer_total.get_total()
            audio_s = self.coordinator.audio_seconds_done
            rate = audio_s / wall if wall > 0 else 0.0
            self.coordinator.q_log.put(AssignLog(
                message=(f'\nAll files analyzed and cleaned.\nTotal analysis '
                         f'time: {wall:,}s'
                         f' ({audio_s:,.0f} audio-seconds, overall rate '
                         f'{rate:,.1f}x realtime)'),
                level_str='INFO'))


class SessionLock:
    """Holds one dir_out claim across every pass of a watch session.

    The per-pass lock (`Analyzer._acquire_lock`) is claimed at pass start
    and released at pass end — correct for single runs, but a watch
    session is idle most of the time (sub-second passes on a 30 s
    interval), so two concurrent watchers on the same dir_out would
    usually alternate the lock without ever colliding, each demoting and
    re-finalizing the other's work and clobbering the other's run
    summary every pass. The SessionLock claims through the SAME
    liveness-checked protocol on the first pass and then keeps the claim
    until `release()` in the watch loop's finally, so a second watcher
    refuses at its FIRST pass regardless of timing. `ensure()` re-verifies
    ownership each pass: a lock file hand-deleted mid-session (the
    documented operator escape hatch for dead runs) is re-claimed rather
    than silently assumed.
    """

    def __init__(self):
        self.held = False
        self.path = None
        self.claim = None

    def ensure(self, analyzer) -> bool:
        path = analyzer._lock_path()
        if self.held and path == self.path:
            owner = Analyzer._read_lock_owner(path)
            # ownership = OUR claim token, not (pid, host): two runs in
            # one process share the pid, so a sibling's fresh lock (after
            # an operator hand-delete) must NOT read as ours
            if owner is not None and owner.get('claim') == self.claim:
                return True
            # the file vanished or was clobbered between passes: fall
            # through and re-claim (a live owner — foreign OR same-pid
            # sibling — refuses us, which ends the watch loop: its
            # end_reason is not healthy)
            self.held = False
        if not analyzer._acquire_lock():
            return False
        # transfer the claim from the pass to the session: the pass's
        # finally releases only when analyzer._lock_held is set
        analyzer._lock_held = False
        self.held, self.path = True, path
        self.claim = analyzer._lock_claim
        return True

    def release(self):
        if not self.held:
            return
        self.held = False
        # claim-checked unlink, serialized with the directory flock —
        # see _unlink_own_lock for the TOCTOU this closes
        _unlink_own_lock(os.path.dirname(self.path) or '.', self.path,
                         self.claim)


def _run_stop_forwarder(external_event, stop, current_pass,
                        poll_s: float = 0.1):
    """Forward an external stop (GUI stop button) into the watch loop.

    Blocks until the external event fires, sets the loop's ``stop`` flag,
    then keeps signaling whichever pass is CURRENT until the loop reports
    done — not one-shot, because the stop can land while the next pass's
    Analyzer is still being constructed (threshold calibration, alert
    setup): a single signal would hit the PREVIOUS pass's already-set
    event and the fresh pass would then run its full corpus sweep before
    the loop re-checks ``stop``. Re-signaling is idempotent
    (Event.set), and the post-stop poll ends as soon as the loop's
    finally marks ``current_pass['done']``, so the thread leaves no
    residue beyond the stop itself.
    """
    external_event.wait()
    stop.set()
    while not current_pass.get('done'):
        coordinator = current_pass.get('coordinator')
        if coordinator is not None:
            coordinator.event_exitanalysis.set()
        time.sleep(poll_s)


def analyze(modelname: str,
            classes_out='all',
            precision: float = None,
            framehop_prop: float = 1,
            chunklength: float = 200,
            analyzers_cpu: int = 1,
            analyzers_gpu: int = 0,
            n_streamers: int = None,
            stream_buffer_depth: int = None,
            dir_audio: str = cfg.DIR_AUDIO,
            dir_out: str = None,
            verbosity_print: str = 'PROGRESS',
            verbosity_log: str = 'DEBUG',
            log_progress: bool = False,
            q_gui=None,
            event_stopanalysis=None,
            compute_dtype=None,
            profile_dir: str = None,
            mesh=None,
            devices=None,
            host_shard=None,
            batch_chunks: int = 1,
            transfer_dtype: str = None,
            strict_f32: bool = False,
            profile: str = None,
            resample_on_device: bool = False,
            watch: bool = False,
            watch_interval: float = 30.0,
            watch_stop=None,
            watch_cycles: int = None,
            alert_classes=None,
            alert_threshold: float = None,
            alert_command: str = None,
            backend_timeout: float = None,
            stall_timeout: float = None,
            device='cuda'):
    """Analyze audio files with a buzz-detection model (kwarg-compatible with
    the reference `analyze()`, `src/analyze.py:387-404`).

    Parameters
    ----------
    modelname : name of the model directory under ``models/``.
    classes_out : 'all' or a list of class names to output (activations mode).
    precision : if set, output thresholded 0/1 ``ins_buzz`` detections at the
        threshold achieving this precision on the model's metrics table.
    framehop_prop : frame stride as a proportion of the 0.96 s frame
        (1 = contiguous; 0.5 = half-overlapping; any positive value works).
    chunklength : seconds of audio per device batch (rounded to whole frames).
    analyzers_cpu / analyzers_gpu : number of inference dispatch threads
        (names kept for API parity; their sum is what matters).
    n_streamers : decode threads (default: sized from CPU count).
    stream_buffer_depth : bounded prefetch ring depth (default: streamers*2).
    dir_audio / dir_out : input tree and output directory. ``dir_audio``
        may also be a single audio FILE (superset of the reference:
        analyze one recording without staging a directory). Where the
        native libav stage is unavailable the port reads PCM16 WAV only
        (audio/__init__.WavDriver).
    verbosity_print / verbosity_log / log_progress : logging controls.
    q_gui / event_stopanalysis : GUI integration hooks.
    compute_dtype : None or float32 (exact f32, the 1e-3 parity budget), or
        bfloat16 (``torch.bfloat16`` or ``'bfloat16'``): the conv kernels'
        bf16 mode, the JAX package's ``conv='pallas'`` bf16 function. With
        activations output it warns (scores move by up to ~0.006 against
        float32).
    profile_dir : if set, write a ``torch.profiler`` trace of the run into
        this directory (``<host>_<pid>.<time>.pt.trace.json``, for TensorBoard
        or Perfetto): the CPU ops of every thread and, on the card, its
        kernels and copies. The model step's spans are in it as
        ``user_annotation`` ranges on the dispatch and writer threads
        (``runtime/spans.py``): ``buzzdetect.dispatch`` holding
        ``buzzdetect.wire``, ``buzzdetect.upload`` and
        ``buzzdetect.classify`` (itself holding ``buzzdetect.frontend``,
        ``buzzdetect.embed`` and ``buzzdetect.head``), then
        ``buzzdetect.copy_back`` and, on the writer, ``buzzdetect.wait``.
        A ``buzzdetect.chunk#<n>`` marker (``cpu_op``) inside the dispatch,
        the copy back and the wait names the chunk they belong to.
    mesh : optional ``parallel.Mesh`` with a 'data' axis, of ``device``'s
        type (``parallel.make_mesh``, e.g. ``make_mesh(devices=['cuda:0',
        'cuda:1'])``, or ``['cpu'] * 4`` with ``device='cpu'``): each
        chunk's patches split across the mesh's devices (one chunk at a
        time uses every device — the latency-min layout), on the XLA conv
        path. A ``device`` of another type than the mesh's raises.
    devices : per-device replica data parallelism — an int N (the first N
        devices of ``device``'s type), 'all', or an explicit list of
        ``'cuda:i'``, ``'cpu'`` or ``torch.device``, which may name one
        device more than once (two replicas on one card). Each entry gets
        its OWN classifier replica and dispatch thread, with a CUDA stream
        of its own, fed independent chunks from the shared prefetch ring:
        zero collectives, the reference's "multiple GPU analyzers" row
        (docs/source/tuning.rst:110-117). Mutually exclusive with ``mesh``.
        In this mode ``analyzers_cpu + analyzers_gpu`` becomes the number
        of dispatch threads PER replica (default 1). Results are
        byte-identical to a single-device run.
    host_shard : multi-host data parallelism — ``(host_id, n_hosts)``, or
        ``True`` to take both from ``torch.distributed`` (rank and world
        size where a process group is initialized, else ``(0, 1)``). This
        process analyzes only its stable hash-assigned shard of the corpus
        (``parallel.shard_files``); point every host at the same output
        directory and they divide the corpus with NO coordination —
        completion state is the filesystem (partials + manifest), exactly
        like single-host resume. Composes with ``devices``.
    resample_on_device : decode at each file's NATIVE rate and resample to
        the model rate on the model's device (``ops/resample.py``,
        polyphase as one strided convolution) instead of in the host
        decode pass: the host ships native-rate int16 and does no per-sample
        resampling, at the cost of proportionally more wire bytes for rates
        above 16 kHz. Where the native libav stage is unavailable this reads
        PCM16 WAV at any rate (``audio.WavDriver``).
    batch_chunks : stack up to this many ready chunks (possibly from
        different files) into one device dispatch — larger device batches and
        fewer round trips; 1 disables batching.
    transfer_dtype : host->device wire format for waveforms: 'int16'
        (default; (near-)lossless for PCM sources), 'float32', or 'mulaw'
        (8-bit mu-law companding — halves transfer bytes again at ~38 dB
        SNR, for deployments where the host->device link is the bottleneck;
        activations typically shift by well under one rounding digit).
    strict_f32 : pin the conv kernels to exact f32 (``conv_precision=
        'highest'``), over a bundle config's ``'high'``; the default already
        runs exact f32, and bf16 compute ignores it.
    profile : one-flag deployment preset — ``'field'`` (throughput-first
        for real recordings: mu-law wire, measured up to 2.9x pipeline on
        link-bound deployments; its digital-silence caveat is logged and
        the manifest records the profile) or ``'strict'`` (bit-strict
        parity: float32 wire + exact-f32 conv precision). A profile fills
        only the knobs left unset, so an explicit ``transfer_dtype`` still
        wins. See docs/tuning.md "Profiles".
    watch : live-monitoring mode — after each pass over ``dir_audio``, wait
        ``watch_interval`` seconds and rescan, analyzing files that appeared
        and (via the gap-resume machinery) the newly recorded tail of files
        that grew since they were finalized. Runs until ``watch_stop`` (a
        ``threading.Event``) is set, ``watch_cycles`` passes complete, or
        Ctrl-C. Completed passes leave the output directory in the exact
        state a non-watch run would — stopping the watcher never loses work.
    alert_classes : class name(s) to announce live: the moment a chunk's
        scores land, any frame whose activation exceeds the alert threshold
        logs a WARNING line ("DETECTED ins_buzz in rec3: 4 frame(s)
        12.48-16.32s (peak activation 1.25)") to the console, log file and
        GUI — near-real-time notice for ``watch=True`` field monitoring,
        without waiting for result files. Output files are unaffected.
    alert_threshold : activation threshold for the alert lines; defaults to
        the ``precision``-calibrated detection threshold when one exists
        (required otherwise).
    alert_command : shell command to run on each alert (notification hook:
        an SMS gateway call, an MQTT publish, a beep). Event data arrives
        in environment variables — ``BUZZ_CLASS``, ``BUZZ_IDENT``,
        ``BUZZ_AUDIO`` (source path), ``BUZZ_START``/``BUZZ_END`` (s),
        ``BUZZ_FRAMES``, ``BUZZ_PEAK``, ``BUZZ_THRESHOLD`` — never
        interpolated into the command string. Commands run one at a time
        on a bounded queue off the hot path: a slow or failing command
        drops notifications (counted, warned) but never blocks or fails
        the analysis. Requires ``alert_classes``.
    backend_timeout : if set, prove the CUDA device can complete one real
        dispatch within this many seconds BEFORE starting the run, and
        fail loudly otherwise (a watched subprocess,
        utils.backend_preflight). Opt-in; ignored with ``device='cpu'``.
    stall_timeout : if set, stop the run loudly (end reason
        ``'device stall'``, CRITICAL log) when no chunk completes for this
        many seconds at ANY point mid-run — an accelerator link that dies
        after startup leaves a dispatch blocked forever, which is not a
        dead worker and so never trips fatal-death detection. Stopping is
        safe by construction (finished chunks are checkpointed; a rerun
        resumes byte-identically), so an unattended deployment's
        supervisor can simply restart. Set it well above the first-compile
        plus one-chunk wall time (>= 300 s is a sensible floor); pairs
        with ``backend_timeout`` (startup) for full coverage.
    device : ``'cuda'`` (default; the conv stack runs in the hand-written
        kernels) or ``'cpu'`` (every op runs its plain PyTorch version).
        Asking for CUDA without a CUDA device raises RuntimeError.
    """
    if devices is not None and mesh is not None:
        raise ValueError(_MSG_DEVICES_MESH_EXCLUSIVE)
    if mesh is not None:
        from buzzdetect_torch.parallel import mesh_device
        mesh_device(mesh, device)
    replica_devices = None
    if devices is not None:
        from buzzdetect_torch.parallel import resolve_replica_devices
        replica_devices = resolve_replica_devices(devices, device)
    if backend_timeout is not None:
        backend_timeout = float(backend_timeout)
        if backend_timeout <= 0:
            # same contract as stall_timeout: a caller bug must fail as a
            # caller bug — fed to subprocess.run(timeout=...) it would
            # expire instantly and be misdiagnosed as a dead accelerator
            raise ValueError(f'backend_timeout must be positive seconds '
                             f'(got {backend_timeout!r})')
        if str(device).startswith('cuda'):
            from buzzdetect_torch.utils import backend_preflight
            ok, why = backend_preflight(backend_timeout)
            if not ok:
                raise RuntimeError(
                    f'device backend preflight failed: {why}. Check the '
                    f"card with nvidia-smi, or run on the CPU with "
                    f"device='cpu'")

    def one_pass(event=event_stopanalysis, **extra):
        # replica mode: analyzers_cpu/analyzers_gpu become dispatch threads
        # PER replica (default 1 each -> one thread per device)
        per_replica = max(1, analyzers_cpu + analyzers_gpu)
        coordinator = Coordinator(analyzers_cpu=(len(replica_devices)
                                                 * per_replica
                                                 if replica_devices
                                                 else analyzers_cpu),
                                  analyzers_gpu=(0 if replica_devices
                                                 else analyzers_gpu),
                                  streamers_total=n_streamers,
                                  depth=stream_buffer_depth,
                                  q_gui=q_gui,
                                  event_analysisdone=event)
        analyzer = Analyzer(modelname=modelname, classes_out=classes_out,
                            precision=precision, framehop_prop=framehop_prop,
                            chunklength=chunklength, dir_audio=dir_audio,
                            dir_out=dir_out, verbosity_print=verbosity_print,
                            verbosity_log=verbosity_log,
                            log_progress=log_progress,
                            coordinator=coordinator,
                            compute_dtype=compute_dtype,
                            profile_dir=profile_dir, mesh=mesh,
                            devices=replica_devices,
                            host_shard=host_shard,
                            batch_chunks=batch_chunks,
                            transfer_dtype=transfer_dtype,
                            strict_f32=strict_f32,
                            profile=profile,
                            resample_on_device=resample_on_device,
                            alert_classes=alert_classes,
                            alert_command=alert_command,
                            alert_threshold=alert_threshold,
                            stall_timeout=stall_timeout, device=device,
                            **extra)
        _current_pass['coordinator'] = analyzer.coordinator
        analyzer.run()
        return analyzer

    _current_pass = {}

    if not watch:
        return one_pass()

    # watch cycles share the model(s) so each device's params upload once,
    # not once per polling cycle; built by the same helper Analyzer.__init__
    # uses so the two sites cannot drift apart. The shared models must see
    # the PROFILE-resolved knobs (the Analyzer resolves them from the
    # originals each pass, but watch mode loads the models here, once)
    r_transfer, r_strict, _note = cfg.resolve_profile(
        profile, transfer_dtype, strict_f32)
    shared = _load_serving_models(modelname, framehop_prop, compute_dtype,
                                  r_transfer, device=device, mesh=mesh,
                                  replica_devices=replica_devices,
                                  conv_precision=('highest' if r_strict
                                                  else None))
    stop = watch_stop if watch_stop is not None else threading.Event()
    # The pipeline sets event_stopanalysis at the END of every pass to
    # signal 'analysis done' (the GUI contract), so the caller's event
    # cannot be handed to each cycle's coordinator directly — carried into
    # the next cycle still set, the completion signal would read as a stop
    # request and kill the watcher after one pass. Instead every cycle gets
    # a fresh internal event, and a monitor thread forwards a genuine
    # external stop (e.g. the GUI stop button) the moment it arrives: it
    # ends the loop and interrupts whatever pass is running.
    if event_stopanalysis is not None:
        threading.Thread(target=_run_stop_forwarder, daemon=True,
                         name='watch_stop_forwarder',
                         args=(event_stopanalysis, stop, _current_pass)).start()

    state, cycles, analyzer, path_log = {}, 0, None, None
    # one dir_out claim for the WHOLE session (released in the finally):
    # per-pass locking would let a second watcher slot its passes into
    # this one's idle intervals and both would believe they own the folder
    session_lock = SessionLock()
    try:
        while not stop.is_set():
            analyzer = one_pass(event=threading.Event(), watch_state=state,
                                watch_cycle=cycles + 1,
                                quiet_startup=cycles > 0, path_log=path_log,
                                session_lock=session_lock,
                                **shared)
            # every cycle appends to the first cycle's log file (the Analyzer
            # stores the path it actually resolved)
            path_log = path_log or analyzer.path_log
            cycles += 1
            # keep watching only after HEALTHY pass outcomes — interrupts,
            # manifest mismatches, and fatal worker failures would otherwise
            # retry forever, failing identically every cycle
            from buzzdetect_torch.runtime.coordination import \
                HEALTHY_END_REASONS
            if analyzer.coordinator.end_reason not in HEALTHY_END_REASONS:
                break
            if watch_cycles is not None and cycles >= watch_cycles:
                break
            try:
                stop.wait(watch_interval)
            except KeyboardInterrupt:
                break
    finally:
        _current_pass['done'] = True  # releases the stop forwarder
        session_lock.release()
    return analyzer

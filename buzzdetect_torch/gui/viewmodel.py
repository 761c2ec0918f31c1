"""GUI view-model: settings state, defaults, validation and cache — all the
GUI logic that doesn't touch a toolkit, so it runs (and tests) headless.

Behavior parity with the reference settings window logic
(`src/gui/settings.py:16-285`): defaults introspected from ``analyze()``'s
signature, overridden by a ``guisettings.json`` cache; per-field validation
through ``validate_map``; and manifest-driven *locking* of schema-determining
fields when the chosen output folder already holds results.

Copy of ``buzzdetect_tpu/gui/viewmodel.py``, import prefix changed. Edit:
``device`` is an advanced field, so the form passes on the port's
``analyze(device=)`` (``'cuda'`` by default; ``'cpu'``, or ``'cuda:N'``).
"""

import functools
import inspect
import json
import os

from buzzdetect_torch.gui import config as gui_cfg
from buzzdetect_torch.manifest import (read_manifest, KEYS_LOCKED,
                                     FNAME_MANIFEST)
from buzzdetect_torch.validation import (validate_map, ArgValid, split_names,
                                       watch_exempt)

# fields shown in the basic settings form, in display order
BASIC_FIELDS = ('modelname', 'dir_audio', 'dir_out', 'classes_out',
                'precision', 'framehop_prop')
ADVANCED_FIELDS = ('chunklength', 'analyzers_cpu', 'analyzers_gpu',
                   'devices', 'n_streamers', 'stream_buffer_depth',
                   'profile',
                   'verbosity_print', 'verbosity_log', 'log_progress',
                   'watch', 'watch_interval',
                   'alert_classes', 'alert_threshold', 'alert_command',
                   'backend_timeout', 'stall_timeout', 'device')


def analysis_defaults():
    """Default settings straight from the analyze() signature (single source
    of truth — the GUI can never drift from the API)."""
    from buzzdetect_torch.analysis import analyze
    sig = inspect.signature(analyze)
    defaults = {}
    for name, p in sig.parameters.items():
        if p.default is not inspect.Parameter.empty:
            defaults[name] = p.default
    defaults.setdefault('modelname', '')
    return defaults


@functools.lru_cache(maxsize=1)
def field_types():
    """Field -> declared type from analyze()'s annotations (falls back to the
    default's type). Coercion must follow the ANNOTATION: framehop_prop and
    chunklength default to int literals but are float parameters."""
    from buzzdetect_torch.analysis import analyze
    sig = inspect.signature(analyze)
    types = {}
    for name, p in sig.parameters.items():
        if p.annotation is not inspect.Parameter.empty \
                and isinstance(p.annotation, type):
            types[name] = p.annotation
        elif p.default is not inspect.Parameter.empty \
                and p.default is not None:
            types[name] = type(p.default)
    return types


# optional fields whose empty form value means "unset" (None), matching the
# analyze() defaults — validators must see None, not ''
OPTIONAL_EMPTY_FIELDS = ('dir_out', 'precision', 'n_streamers',
                         'stream_buffer_depth', 'devices', 'profile',
                         'alert_classes', 'alert_threshold',
                         'alert_command', 'backend_timeout',
                         'stall_timeout')


def coerce_field(name, raw):
    """Form string -> the value analyze() (and the validators) expect.

    The single coercion path for both live widget validation and the
    pull-into-model step: '' means None for optional fields, and numerics
    follow the analyze() annotation. Uncoercible input is returned raw so
    the validator reports it."""
    if raw == '' and name in OPTIONAL_EMPTY_FIELDS:
        return None
    if name == 'devices':
        # int or the literal 'all' (per-chip replica parallelism); strict
        # int parse — '2.9' is a typo for a replica COUNT, not a value to
        # truncate, so it stays raw and the validator rejects it
        if isinstance(raw, str) and raw.strip().lower() == 'all':
            return 'all'
        try:
            return int(raw)
        except (TypeError, ValueError):
            return raw
    want = field_types().get(name)
    try:
        if want is bool:
            return bool(raw)
        if want is float:
            return float(raw)
        if want is int:
            # strict, like devices above: '2.9' typed into a thread/depth
            # COUNT is a typo to reject (the validator fires on the raw
            # string), not a value to silently truncate to 2
            f = float(raw)
            if f.is_integer():
                return int(f)
    except (TypeError, ValueError):
        pass
    return raw


class SettingsModel:
    """State + validation + persistence for the settings form."""

    def __init__(self, path_cache: str = None):
        self.path_cache = path_cache or gui_cfg.FNAME_GUISETTINGS
        self.values = analysis_defaults()
        self.load_cache()

    # --- persistence ------------------------------------------------------
    def load_cache(self):
        if os.path.exists(self.path_cache):
            try:
                with open(self.path_cache) as f:
                    cached = json.load(f)
                self.values.update({k: v for k, v in cached.items()
                                    if k in self.values})
            except (json.JSONDecodeError, OSError):
                pass  # a corrupt cache must never block the GUI

    def save_cache(self):
        serializable = {k: v for k, v in self.values.items()
                        if isinstance(v, (str, int, float, bool, list,
                                          type(None)))}
        try:
            with open(self.path_cache, 'w') as f:
                json.dump(serializable, f, indent=2)
        except OSError:
            # an unwritable CWD (read-only install, full disk) must never
            # block launching the analysis — same contract as load_cache
            pass

    # --- validation -------------------------------------------------------
    def _field_is_set(self, name) -> bool:
        """Unset for form purposes: None, or an empty/whitespace string."""
        value = self.values.get(name)
        if value is None:
            return False
        if isinstance(value, str) and not value.strip():
            return False
        return True

    def validate_field(self, name) -> ArgValid:
        validator = validate_map.get(name)
        if validator is None:
            return ArgValid(True, None)
        value = self.values.get(name)
        if watch_exempt(name, self.values.get('watch')):
            return ArgValid(True, None)
        result = validator(value)
        if not result.valid:
            return result
        # Cross-field alert configuration: analyze()'s _setup_alert fails
        # fast on these, but from the GUI "fast" would be AFTER the child
        # process launches — surface the error inline on the form instead.
        if name == 'alert_threshold' and self._field_is_set(name) \
                and not self._field_is_set('alert_classes'):
            return ArgValid(False, 'needs alert_classes (a threshold alone '
                                   'does nothing)')
        if name == 'alert_command' and self._field_is_set(name) \
                and not self._field_is_set('alert_classes'):
            return ArgValid(False, 'needs alert_classes (a command alone '
                                   'does nothing)')
        if name == 'alert_classes' and self._field_is_set(name) \
                and not self._field_is_set('alert_threshold') \
                and not self._field_is_set('precision'):
            return ArgValid(False, 'needs alert_threshold (or precision, '
                                   'to calibrate one)')
        # Orphaned results: the folder holds result files but no readable
        # manifest, so their settings cannot be verified and analyze()
        # will refuse admission — fail inline rather than after the child
        # launches.
        if name == 'dir_out' and self._orphan_results():
            return ArgValid(False, 'holds results but its '
                                   f'{FNAME_MANIFEST} is missing or '
                                   'unreadable — their settings cannot '
                                   'be verified; repair/restore the '
                                   'manifest or pick a fresh folder')
        # Live run lock: analyze() will refuse admission while another
        # run owns the folder — fail inline, not after the child launches.
        if name == 'dir_out':
            owner = self._live_lock()
            if owner is not None:
                return ArgValid(False,
                                f'another analysis (pid {owner.get("pid")} '
                                f'on {owner.get("host")}) is writing into '
                                f'this folder; wait for it or stop it')
        return result

    def validate_all(self):
        """{field: ArgValid} for every known field."""
        return {name: self.validate_field(name)
                for name in (*BASIC_FIELDS, *ADVANCED_FIELDS)
                if name in validate_map}

    def ready(self) -> bool:
        return all(v.valid for v in self.validate_all().values())

    # --- manifest locking -----------------------------------------------------
    def resolved_dir_out(self):
        from buzzdetect_torch import config as cfg
        return cfg.resolve_dir_out(self.values.get('dir_out'),
                                   self.values.get('modelname'))

    def locked_fields(self):
        """Schema-determining fields that must not change because the output
        folder already holds results; returns {} when unconstrained.

        The manifest read is cached by (path, stat signature): this runs on
        every keystroke via the change handler, and re-opening a (possibly
        network-mounted) manifest file per keypress stalls the Tk loop."""
        path = self.resolved_dir_out()
        try:
            st = os.stat(os.path.join(path, FNAME_MANIFEST))
            sig = (path, st.st_mtime_ns, st.st_size)
        except OSError:
            sig = (path, None, None)
        if getattr(self, '_manifest_sig', None) != sig:
            self._manifest_sig = sig
            self._manifest_cache = read_manifest(path)
        manifest = self._manifest_cache
        if manifest is None:
            return {}
        locked = {}
        for key in KEYS_LOCKED:
            if key in manifest and key != 'output_mode':
                value = manifest[key]
                if key == 'classes_out' and value is None:
                    # detections-mode manifests store classes_out=null
                    # (class selection doesn't shape that schema); the
                    # locked — hence uneditable — widget needs a valid
                    # display value or form validation fails and launch is
                    # bricked for the folder. 'all' relaunches identically:
                    # Manifest.from_settings normalizes it back to None
                    # whenever precision is set.
                    value = 'all'
                locked[key] = value
        return locked

    def _orphan_results(self) -> bool:
        """True when the resolved output folder holds result files but no
        readable manifest — analyze() refuses admission then (provenance
        unattestable), so the form should too. This runs per keystroke
        (the settings window's cross-field sync), so the walk is BOUNDED
        (max_entries, counting directories too) and CACHED by (path,
        manifest signature, folder mtime); the run-time admission guard
        re-checks unbounded."""
        self.locked_fields()  # refreshes the cached manifest read
        if self._manifest_cache is not None:
            return False  # manifest present: provenance attested
        path = self.resolved_dir_out()
        try:
            mtime = os.stat(path).st_mtime_ns
        except OSError:
            return False  # nonexistent/fresh folder: nothing to attest
        sig = (self._manifest_sig, mtime)
        if getattr(self, '_orphan_sig', None) != sig:
            self._orphan_sig = sig
            from buzzdetect_torch.manifest import find_orphan_results
            self._orphan_cache = bool(find_orphan_results(
                path, limit=1, max_entries=4000))
        return self._orphan_cache

    def _live_lock(self):
        """The owning run's lock record when the resolved output folder is
        claimed by a LIVE analysis (analyze() refuses admission then),
        else None. The file READ is cached by the lock's stat signature
        (per-keystroke like the checks above) but liveness is re-checked
        on every call — a cheap signal-0 — so an owner that dies without
        touching the file unblocks the form immediately, not on the next
        mtime change."""
        from buzzdetect_torch import config as cfg
        path = os.path.join(self.resolved_dir_out(), cfg.FNAME_LOCK)
        try:
            st = os.stat(path)
            sig = (path, st.st_mtime_ns, st.st_size)
        except OSError:
            return None
        if getattr(self, '_lock_sig', None) != sig:
            self._lock_sig = sig
            import json
            try:
                with open(path) as f:
                    self._lock_cache = json.load(f)
            except Exception:
                # corrupt lock = crashed owner; analyze() self-heals it
                self._lock_cache = None
        rec = self._lock_cache
        if rec is None:
            return None
        import socket
        from buzzdetect_torch.utils import pid_alive
        if rec.get('host') != socket.gethostname():
            return rec  # liveness unknowable across machines: refuse-side
        return rec if pid_alive(rec.get('pid')) else None

    def apply_manifest_lock(self):
        """Adopt locked values from the existing manifest into the form.

        None IS a meaningful pin (precision=None = activations mode): a
        cached non-None precision must be overwritten, or the widget locks
        displaying a value the manifest forbids and the launch dies on a
        manifest mismatch the user cannot edit away."""
        locked = self.locked_fields()
        for key, value in locked.items():
            if key in self.values:
                self.values[key] = value
        return locked

    # --- launch -----------------------------------------------------------------
    def analyze_kwargs(self):
        """The kwargs dict to hand to analyze().

        Restricted to the form fields: the defaults snapshot also contains
        process-integration parameters (q_gui, event_stopanalysis, ...) that
        the launcher supplies itself — passing them through would collide.
        """
        fields = set(BASIC_FIELDS) | set(ADVANCED_FIELDS)
        kwargs = {k: v for k, v in self.values.items() if k in fields}
        # ' all ' / 'All' mean 'all' — a near-miss would pass validation,
        # pin classes_out=['all'] into the folder's manifest, then fail in
        # the writer
        if isinstance(kwargs.get('classes_out'), str) \
                and kwargs['classes_out'].strip().lower() == 'all':
            kwargs['classes_out'] = 'all'
        if isinstance(kwargs.get('classes_out'), str) \
                and kwargs['classes_out'] != 'all':
            kwargs['classes_out'] = split_names(kwargs['classes_out'])
        # same form convention for the live-alert classes (no 'all' case)
        if isinstance(kwargs.get('alert_classes'), str):
            kwargs['alert_classes'] = \
                split_names(kwargs['alert_classes']) or None
        return kwargs

"""Per-argument validators for ``analyze()`` parameters.

Front-ends (GUI forms, notebooks) validate fields individually through
``validate_map``; each validator returns an :class:`ArgValid` whose message,
when present on a *valid* result, is a warning worth surfacing.

Semantics match the reference validator set (`src/validation.py:8-184`):
precision must sit in (0, 1) and warns below 0.9; framehop must be positive
and warns above 1 (gaps read as missing data); worker counts are
non-negative ints; verbosities must name a known log level. Implemented as
a small rule toolkit rather than one function per field.
"""

import os

from buzzdetect_torch import config as cfg
from buzzdetect_torch.loglevels import loglevels


class ArgValid:
    """(valid, message): message on a valid result is a warning."""

    __slots__ = ('valid', 'message')

    def __init__(self, valid: bool, message: str = None):
        self.valid = valid
        self.message = message

    def __repr__(self):
        return f'ArgValid(valid={self.valid}, message={self.message!r})'


OK = ArgValid(True, None)


# --- rule toolkit -----------------------------------------------------------

def _as_number(value, kind):
    err = ArgValid(False, 'must be numeric'
                   if kind is float else 'must be an integer')
    if kind is int and isinstance(value, float) and not value.is_integer():
        # int(2.9) would silently truncate a value analyze() later crashes
        # on (range(2.9)); reject non-integral floats like the string
        # parse already does (int('2.9') raises)
        return None, err
    try:
        return kind(value), None
    except (TypeError, ValueError):
        return None, err


def numeric_rule(*, kind=float, minimum=None, maximum=None,
                 exclusive_min=None, exclusive_max=None, none_ok=False,
                 warn_below=None, warn_message=None, over_warning=None):
    """Build a validator for one numeric field."""

    def validate(value):
        if value is None:
            return OK if none_ok else ArgValid(False, 'cannot be None')
        number, err = _as_number(value, kind)
        if err is not None:
            return err
        if exclusive_min is not None and number <= exclusive_min:
            return ArgValid(False, f'must be > {exclusive_min}')
        if exclusive_max is not None and number >= exclusive_max:
            return ArgValid(False, f'must be < {exclusive_max}')
        if minimum is not None and number < minimum:
            return ArgValid(False, f'must be >= {minimum}')
        if maximum is not None and number > maximum:
            return ArgValid(False, f'must be <= {maximum}')
        if warn_below is not None and number < warn_below:
            return ArgValid(True, warn_message)
        if over_warning is not None and number > over_warning[0]:
            return ArgValid(True, over_warning[1])
        return OK

    return validate


# --- field-specific validators ------------------------------------------------

def validate_modelname(modelname):
    dir_model = os.path.join(cfg.resolve_dir(cfg.DIR_MODELS), str(modelname))
    if not os.path.isdir(dir_model):
        return ArgValid(False, f'Model folder does not exist for model '
                               f'"{modelname}"')
    if not os.path.exists(os.path.join(dir_model, 'config_model.json')):
        return ArgValid(False, f'Config file does not exist for model '
                               f'"{modelname}"')
    if not any(os.path.exists(os.path.join(dir_model, f))
               for f in ('model.npz', 'model.py')):
        return ArgValid(False, f'Neither model.py nor model.npz found for '
                               f'model "{modelname}"')
    return OK


def split_names(raw: str) -> list:
    """The GUI form's class-name convention, in one place: a comma and/or
    whitespace separated string -> list of names. Shared by the classes_out
    and alert_classes validators AND the viewmodel's form->kwargs coercion so
    the two can never disagree about what a form string means."""
    return [s for s in raw.replace(',', ' ').split() if s]


def validate_classes_out(classes_out):
    if classes_out == 'all':
        return OK
    if isinstance(classes_out, str):
        # the GUI form holds a comma/space-separated string; the launcher
        # splits it into the list analyze() takes (viewmodel.analyze_kwargs)
        if split_names(classes_out):
            return OK
        return ArgValid(False, "'all' or one or more class names")
    if not isinstance(classes_out, list):
        return ArgValid(False, 'must be a list')
    # an EMPTY list would pass every downstream membership check vacuously
    # and run a full analysis that archives zero activation columns (e.g.
    # `--classes_out ,` flattening to []) — reject it here
    if not classes_out or not all(isinstance(c, str) for c in classes_out):
        return ArgValid(False, "'all' or a non-empty list of class names")
    return OK


def validate_alert_classes(alert_classes):
    """None (alerts off), a non-empty name string (GUI form), or a
    non-empty list of names. Membership in the model's classes is checked
    at analyze() time, where the model config is loaded."""
    if alert_classes is None:
        return OK
    if isinstance(alert_classes, str):
        if split_names(alert_classes):
            return OK
        return ArgValid(False, 'one or more class names '
                               '(or blank to disable alerts)')
    if not isinstance(alert_classes, (list, tuple)) or not alert_classes \
            or not all(isinstance(c, str) for c in alert_classes):
        return ArgValid(False, 'a non-empty list of class names')
    return OK


FRAMEHOP_WARNING = (
    'Currently, analyses with framehop > 1 will produce valid results, but '
    'buzzdetect will interpret the resulting gaps as missing data.\n'
    f'Fully analyzed files will not be converted from {cfg.SUFFIX_RESULT_PARTIAL} '
    f'to {cfg.SUFFIX_RESULT_COMPLETE}.\n'
    'Repeated analysis will attempt to fill gaps between frames.')

validate_precision = numeric_rule(
    kind=float, exclusive_min=0, exclusive_max=1, none_ok=True,
    warn_below=0.9,
    warn_message='analyses with precision < 0.9 are likely to be prone to '
                 'false positives')

validate_framehop = numeric_rule(
    kind=float, exclusive_min=0, over_warning=(1, FRAMEHOP_WARNING))

validate_chunklength = numeric_rule(kind=float, exclusive_min=0)


def validate_int(value, none_ok, value_min=None, value_max=None):
    rule = numeric_rule(kind=int, minimum=value_min, maximum=value_max,
                        none_ok=none_ok)
    return rule(value)


def validate_dir_audio(dir_audio):
    if not os.path.exists(dir_audio):
        return ArgValid(False, f'folder does not exist: {dir_audio!r}')
    return OK


def watch_exempt(name, watch) -> bool:
    """The one cross-field validation exemption, single-sourced for the
    CLI, the GUI widgets, and the headless viewmodel: ``dir_audio`` skips
    existence validation while watch mode is on — a not-yet-created
    recorder directory is normal there (the pipeline downgrades the empty
    listing to DEBUG and keeps polling)."""
    return name == 'dir_audio' and bool(watch)


def validate_dir_out(dir_out):
    if dir_out is not None and not os.path.exists(dir_out):
        return ArgValid(True, 'Output folder does not exist; it will be '
                              'created upon analysis')
    return OK


def validate_verbosity(verbosity_str):
    if verbosity_str in loglevels:
        return OK
    return ArgValid(False, f"must be one of: {', '.join(loglevels)}")


def validate_transfer_dtype(value):
    if value in (None, '', 'float32', 'int16', 'mulaw'):
        return OK
    return ArgValid(False, "must be one of: float32, int16, mulaw")


def validate_profile(value):
    """Deployment preset (config.resolve_profile): blank = none."""
    if value in (None, '', 'field', 'strict'):
        return OK
    return ArgValid(False, "must be one of: field, strict (or blank)")


def validate_devices(value):
    """Per-chip replica count: None (off), 'all', or an int >= 1. Whether
    that many chips are actually attached is checked at launch (the
    front-end cannot know the accelerator topology without importing jax,
    which is too heavy for a per-keystroke validator)."""
    if value in (None, ''):
        return OK
    if isinstance(value, str) and value.strip().lower() == 'all':
        return OK
    return numeric_rule(kind=int, minimum=1)(value)


def validate_alert_command(alert_command):
    """None, blank, or a command string. Blank/whitespace means "no hook"
    everywhere the engine reads it (Analyzer/WorkerWriter treat it as
    None — the `--alert_command "$HOOK"` with HOOK unset idiom), so the
    validator must accept it too. Whether a command WORKS is only
    knowable by running it; alert-classes pairing is a cross-field rule
    (viewmodel / analyze())."""
    if alert_command is None:
        return OK
    if isinstance(alert_command, str):
        return OK  # blank/whitespace == no hook; anything else is a command
    return ArgValid(False, 'a shell command (or blank for no hook)')


validate_map = {
    'modelname': validate_modelname,
    'classes_out': validate_classes_out,
    'precision': validate_precision,
    'framehop_prop': validate_framehop,
    'chunklength': validate_chunklength,
    'analyzers_cpu': numeric_rule(kind=int, minimum=0),
    'analyzers_gpu': numeric_rule(kind=int, minimum=0),
    'n_streamers': numeric_rule(kind=int, minimum=1, none_ok=True),
    'stream_buffer_depth': numeric_rule(kind=int, minimum=1, none_ok=True),
    'dir_audio': validate_dir_audio,
    'dir_out': validate_dir_out,
    'verbosity_print': validate_verbosity,
    'verbosity_log': validate_verbosity,
    'log_progress': numeric_rule(kind=int, minimum=0, maximum=1),
    'transfer_dtype': validate_transfer_dtype,
    'profile': validate_profile,
    'devices': validate_devices,
    'resample_on_device': numeric_rule(kind=int, minimum=0, maximum=1),
    'watch': numeric_rule(kind=int, minimum=0, maximum=1),
    'watch_interval': numeric_rule(kind=float, exclusive_min=0),
    'alert_classes': validate_alert_classes,
    'alert_threshold': numeric_rule(kind=float, none_ok=True),
    'alert_command': validate_alert_command,
    'backend_timeout': numeric_rule(kind=float, exclusive_min=0,
                                    none_ok=True),
    'stall_timeout': numeric_rule(kind=float, exclusive_min=0,
                                  none_ok=True),
}

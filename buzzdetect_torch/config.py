"""Global constants: directory layout, result-file naming, runtime tolerances.

Capability parity with the reference constants module (`src/config.py:1-29`):
same directory layout contract (``models/<name>``, ``embedders/<name>``), same result
suffixes so result folders written by the reference and by this framework are mutually
resumable, and the same corrupt-read / tiny-file tolerances.
"""

import os

# --- file structure -------------------------------------------------------
# Default input directory for audio (relative to the working directory).
DIR_AUDIO = 'audio_in'

# Per-model output subdirectory used when no --dir_out is given.
SUBDIR_OUTPUT = 'output'

# Root of the repo (so model/embedder discovery works regardless of CWD).
DIR_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Model and embedder plugin roots. Searched in order: absolute env override,
# the working directory, then the repo checkout.
DIR_MODELS = os.environ.get('BUZZDETECT_DIR_MODELS', 'models')
DIR_EMBEDDERS = os.environ.get('BUZZDETECT_DIR_EMBEDDERS', 'embedders')
DEFAULT_MODEL = 'model_general_v3'
SUBDIR_TESTS = 'tests'
FNAME_METRICS = 'metrics.csv'

# --- results --------------------------------------------------------------
FNAME_RUN_SUMMARY = 'buzzdetect_run_summary.json'
FNAME_LOCK = '.buzzdetect_lock'
SUFFIX_RESULT_COMPLETE = '_buzzdetect.csv'
SUFFIX_RESULT_PARTIAL = '_buzzpart.csv'
PREFIX_COLUMN_ACTIVATION = 'activation_'
PREFIX_COLUMN_DETECTION = 'detections_'

# --- audio tolerances -----------------------------------------------------
# Proportion of a file's tail that may be unreadable before the bad-read report
# escalates from DEBUG to WARNING (recorders dying mid-file corrupt the tail).
BAD_READ_ALLOWANCE = 0.01
# Files smaller than this many bytes are skipped as presumed-corrupt.
FILE_SIZE_MINIMUM = 5000

# Seconds of zero results after worker launch before the stall watchdog
# WARNS (a dead device backend hangs the first dispatch with no error; a
# first-time TPU compile legitimately takes ~40-60 s — hence warn-only).
STALL_WARNING_S = 300.0


def resolve_dir(d: str) -> str:
    """Resolve a model/embedder root: absolute paths pass through; relative
    paths resolve against CWD if present there, else against the repo root."""
    if os.path.isabs(d):
        return d
    if os.path.isdir(d):
        return os.path.abspath(d)
    return os.path.join(DIR_REPO, d)


def resolve_profile(profile, transfer_dtype, strict_f32):
    """One-flag deployment profiles: resolve (transfer_dtype, strict_f32,
    note) from ``--profile`` without knob archaeology (docs/tuning.md
    "Profiles"). A profile fills only the knobs the caller left unset, so
    an explicit --transfer_dtype still wins.

    * ``field``: throughput-first for real-world recordings — mu-law wire
      (halves host->device bytes; measured 2.9x pipeline on a throttled
      link). Caveat (returned as ``note`` and recorded in the run log):
      mu-law's ~-48 dB noise floor is inaudible under any field
      recording's ambient noise, but DIGITALLY silent content (synthetic
      tones, studio masters) picks it up through log(mel + 1e-3) and can
      shift scores visibly — use the default profile for synthetic audio.
    * ``strict``: bit-strict parity — float32 wire (no quantization) and
      exact-f32 conv precision (HIGHEST; the --strict_f32 escape).
    """
    if profile is None:
        return transfer_dtype, strict_f32, None
    if profile == 'field':
        note = None
        if transfer_dtype is None:
            transfer_dtype = 'mulaw'
            note = ("profile 'field': mu-law wire format selected (2x "
                    "fewer host->device bytes). Caveat: digitally-silent "
                    "content (synthetic tones, studio silence) can pick "
                    "up the companding noise floor through log-mel — use "
                    "the default profile for synthetic/mastered audio.")
        return transfer_dtype, strict_f32, note
    if profile == 'strict':
        return (transfer_dtype or 'float32'), True, None
    raise ValueError(f"profile must be 'field' or 'strict', got {profile!r}")


def resolve_dir_out(dir_out, modelname) -> str:
    """Blank/None dir_out -> the model's default output folder.

    The ONE definition of the zero-config output rule shared by the
    Analyzer, the CLI, the GUI viewmodel's manifest locking, and the GUI
    outcome line — resolving it differently in any one of them makes that
    surface look at a different folder than the one results land in.
    A blank modelname falls back to DEFAULT_MODEL (the GUI form's
    empty-field state during editing)."""
    if dir_out:
        return dir_out
    return default_dir_out(modelname or DEFAULT_MODEL)


def default_dir_out(modelname: str) -> str:
    """The default output directory for a model (models/<name>/output).

    The ONE definition of the rule — the CLI's manifest reconciliation, the
    GUI's manifest locking, and the Analyzer must all resolve the same
    folder or they reconcile against a different directory than the one
    results land in."""
    return os.path.join(resolve_dir(DIR_MODELS), modelname, SUBDIR_OUTPUT)

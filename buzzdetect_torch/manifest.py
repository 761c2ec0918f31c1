"""Output-folder manifest: the result-schema compatibility guard.

Every output directory carries a small JSON manifest recording the settings
that determine its result files' schema and resumability. Before any run
writes into a folder, its settings are checked against the manifest so rows
from incompatible configurations (different class subset, different frame
stride, activations vs detections) can never silently interleave.

The on-disk format is wire-compatible with the reference implementation
(`src/pipeline/manifest.py:10-85` — same filename, same keys, same
order-insensitive class comparison), so output folders are mutually
resumable between the two.
"""

import json
import os
from dataclasses import dataclass, asdict
from typing import Optional

FNAME_MANIFEST = 'buzzdetect_manifest.json'

# the settings a folder pins once results exist in it
KEYS_LOCKED = ('modelname', 'output_mode', 'classes_out', 'precision',
               'framehop_prop')


@dataclass
class Manifest:
    modelname: str
    output_mode: str                 # 'activations' | 'detections'
    classes_out: Optional[list]      # sorted; None in detections mode
    precision: Optional[float]
    framehop_prop: float
    # informational provenance, NOT in KEYS_LOCKED: the deployment profile
    # (--profile field|strict) changes only wire format / MXU precision —
    # sub-rounding-digit effects that stay result-compatible — but a
    # reader auditing a folder should see which trade the run made
    # (e.g. mu-law's documented digital-silence caveat). Absent (None) in
    # runs that set knobs individually; older/reference manifests without
    # the key read as None.
    profile: Optional[str] = None

    @classmethod
    def from_settings(cls, modelname, framehop_prop, precision, classes_out,
                      profile=None):
        detections = precision is not None
        return cls(
            modelname=modelname,
            output_mode='detections' if detections else 'activations',
            # class selection only shapes the schema in activations mode;
            # stored sorted so selection order is irrelevant
            classes_out=None if detections else sorted(classes_out),
            precision=precision,
            framehop_prop=framehop_prop,
            profile=profile,
        )

    def to_dict(self):
        d = asdict(self)
        if d.get('profile') is None:
            # keep byte-level wire parity with the reference manifest (and
            # all pre-profile folders) unless a profile was actually used
            del d['profile']
        return d

    def conflicts_with(self, other: dict):
        """Human-readable list of locked-key mismatches vs a stored dict."""
        problems = []
        mine = self.to_dict()
        for key in KEYS_LOCKED:
            stored, requested = other.get(key), mine.get(key)
            if key == 'classes_out' and stored is not None \
                    and requested is not None:
                if set(stored) != set(requested):
                    gained = sorted(set(requested) - set(stored))
                    lost = sorted(set(stored) - set(requested))
                    detail = '; '.join(
                        p for p in (gained and f"added {', '.join(gained)}",
                                    lost and f"removed {', '.join(lost)}")
                        if p)
                    problems.append(f'output classes differ ({detail})')
            elif stored != requested:
                problems.append(
                    f'{key}: existing={stored!r}, requested={requested!r}')
        return problems


def _manifest_path(dir_out):
    return os.path.join(dir_out, FNAME_MANIFEST)


def read_manifest(dir_out):
    """The stored manifest dict, or None when the folder has none.

    An UNREADABLE manifest (truncated by a mid-write crash, dir_out
    pointing at a file, permission trouble) also reads as None: a raw
    JSONDecodeError here would crash the CLI reconcile prompt and fire
    inside the GUI's per-keystroke change handler. The next successful run
    rewrites a valid manifest."""
    try:
        with open(_manifest_path(dir_out)) as f:
            data = json.load(f)
    except (FileNotFoundError, NotADirectoryError, IsADirectoryError,
            PermissionError, json.JSONDecodeError):
        return None
    # valid JSON that isn't an object (hand-edited/corrupted) would take the
    # same crash paths the except clause guards against (diff_manifests
    # calls .get on it)
    return data if isinstance(data, dict) else None


def write_manifest(dir_out, manifest):
    os.makedirs(dir_out, exist_ok=True)
    data = manifest.to_dict() if isinstance(manifest, Manifest) else manifest
    # atomic (temp + rename): multi-host runs share one output directory and
    # every host writes the same manifest at startup — a reader racing a
    # plain in-place write could see a torn file and mistake it for absent
    path = _manifest_path(dir_out)
    # uuid, not just pid: multi-host writers share dir_out and containerized
    # hosts commonly have identical pids — colliding tmp names would make
    # one host's os.replace race the other's and crash at startup
    import uuid
    path_tmp = f'{path}.{uuid.uuid4().hex[:12]}.tmp'
    with open(path_tmp, 'w') as f:
        json.dump(data, f, indent=2)
    os.replace(path_tmp, path)


# --- functional wrappers (the API the rest of the framework uses) ----------

def build_manifest(modelname, framehop_prop, precision, classes_out,
                   profile=None) -> dict:
    return Manifest.from_settings(modelname, framehop_prop, precision,
                                  classes_out, profile=profile).to_dict()


def diff_manifests(existing: dict, current: dict):
    return Manifest(**current).conflicts_with(existing)


def find_orphan_results(dir_out, limit=3, max_entries=None):
    """Up to ``limit`` result files (partial or finalized) under a folder,
    as paths relative to it. Used to detect orphaned results: result files
    in a folder with no manifest.

    ``max_entries`` bounds the number of directory entries visited —
    per-keystroke GUI validation must not walk a huge unrelated folder to
    exhaustion (the run-time admission guard re-checks unbounded).
    Directories count toward the bound too: a tree of many nested,
    mostly file-less folders (a per-site/per-date dataset mirror) costs
    an opendir+stat per directory, and a files-only bound would walk
    all of them."""
    from buzzdetect_torch import config as cfg
    suffixes = (cfg.SUFFIX_RESULT_PARTIAL, cfg.SUFFIX_RESULT_COMPLETE)
    found = []
    seen = 0
    for root, dirs, files in os.walk(dir_out):
        seen += len(dirs) + len(files)
        for fname in files:
            if fname.endswith(suffixes):
                found.append(os.path.relpath(os.path.join(root, fname),
                                             dir_out))
                if len(found) >= limit:
                    return found
        if max_entries is not None and seen >= max_entries:
            return found
    return found


def check_or_write_manifest(dir_out, manifest: dict):
    """Admit or refuse a run against the folder's stored manifest.

    No manifest yet and no results yet: store this run's manifest and
    admit. Stored and compatible: admit. Stored but conflicting: refuse
    with an explanation and leave the stored manifest untouched.

    Results but NO manifest (deleted, or CSVs copied without it): refuse.
    The settings that produced those files cannot be verified, and the
    dangerous mismatches are invisible in the files themselves — a
    different detection threshold or frame stride yields the *same* CSV
    header, so admitting the run would let a resume silently interleave
    rows scored under incompatible settings into one finalized result.
    The refusal names the remedy: restore the manifest (the message
    includes the exact JSON for this run's settings) or start fresh.
    """
    existing = read_manifest(dir_out)
    if existing is None:
        orphans = find_orphan_results(dir_out)
        if orphans:
            shared = (
                f"'{dir_out}' already contains result files (e.g. "
                f"{', '.join(sorted(orphans))}) {{cause}}, "
                f"so the settings that produced them cannot be verified. "
                f"Resuming could silently mix rows from incompatible "
                f"settings: a different detection threshold or frame "
                f"stride produces the SAME column header, so the files "
                f"themselves cannot prove compatibility.\n")
            if os.path.lexists(_manifest_path(dir_out)):
                # the manifest EXISTS but didn't parse (truncated external
                # copy, permissions, hand-edit). Do NOT hand the user
                # overwrite-ready JSON here: the damaged file likely
                # recorded DIFFERENT settings, and pasting this run's over
                # it would re-attest wrong provenance — the exact hole
                # this guard closes.
                return False, (
                    shared.format(cause=f'but its {FNAME_MANIFEST} is '
                                        f'unreadable') +
                    f"Inspect and repair "
                    f"{os.path.join(dir_out, FNAME_MANIFEST)} (expected: "
                    f"a JSON object with keys {', '.join(KEYS_LOCKED)}) — "
                    f"do NOT overwrite it with this run's settings unless "
                    f"you are certain the results were produced with "
                    f"them. Otherwise move the old results aside or "
                    f"choose a different output folder.")
            return False, (
                shared.format(cause=f'but no {FNAME_MANIFEST}') +
                f"If (and only if) the existing results were produced "
                f"with this run's exact settings, restore the manifest "
                f"by writing this to "
                f"{os.path.join(dir_out, FNAME_MANIFEST)}:\n"
                f"{json.dumps(manifest, indent=2)}\n"
                f"Otherwise move the old results aside or choose a "
                f"different output folder.")
        write_manifest(dir_out, manifest)
        return True, None

    problems = diff_manifests(existing, manifest)
    if not problems:
        return True, None

    bullet_list = '\n  - '.join(problems)
    return False, (
        f"Results have already been written to '{dir_out}' using different "
        f"settings, so new results would be incompatible with the existing "
        f"files:\n  - {bullet_list}\n"
        f"Either match the existing settings, or choose an empty output "
        f"folder.")

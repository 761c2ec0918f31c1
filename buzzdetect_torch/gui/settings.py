"""Settings window: validated form -> launch analysis.

Parity: reference `src/gui/settings.py:16-531` — defaults from the analyze()
signature / guisettings.json cache, inline validation, advanced-settings
section, and manifest-driven locking of schema fields when the output folder
already holds results.

Copy of ``buzzdetect_tpu/gui/settings.py``, import prefix changed; no other
edit (the ``device`` field is a validated text entry, like every field
without a dedicated widget).
"""

import tkinter as tk
from tkinter import ttk

from buzzdetect_torch.gui import config as gui_cfg
from buzzdetect_torch.gui.viewmodel import (SettingsModel, BASIC_FIELDS,
                                          ADVANCED_FIELDS, coerce_field,
                                          field_types)
from buzzdetect_torch.gui.widgets import (TextEntry, FilePathEntry,
                                        CheckBoxEntry, DropDownEntry)
from buzzdetect_torch.loglevels import loglevels
from buzzdetect_torch.validation import ArgValid, validate_map, watch_exempt


class AnalysisSettings(tk.Tk):
    def __init__(self, model: SettingsModel = None):
        super().__init__()
        self.title('buzzdetect — settings')
        self.model = model or SettingsModel()
        self.entries = {}
        # guards the set()-inside-_on_change cycle: entry.set() fires the
        # Tk write trace even for an unchanged value, so programmatic
        # writes (load/lock) must not re-enter the change handler
        self._syncing = False

        container = ttk.Frame(self)
        container.pack(fill='both', expand=True, padx=12, pady=12)

        ttk.Label(container, text='Analysis settings',
                  font=(gui_cfg.FONT_FAMILY, gui_cfg.FONT_SIZE_TITLE)
                  ).pack(anchor='w')

        self._build_fields(container, BASIC_FIELDS)

        self.advanced_open = tk.BooleanVar(value=False)
        ttk.Checkbutton(container, text='Advanced settings',
                        variable=self.advanced_open,
                        command=self._toggle_advanced).pack(anchor='w',
                                                            pady=(8, 0))
        self.advanced_frame = ttk.Frame(container)
        self._build_fields(self.advanced_frame, ADVANCED_FIELDS)

        self.launch_button = ttk.Button(container, text='Analyze',
                                        command=self.launch)
        self.launch_button.pack(anchor='e', pady=8)
        self.status_label = ttk.Label(container, text='',
                                      foreground=gui_cfg.LEVEL_COLORS.get(
                                          'ERROR', '#b00020'))
        self.status_label.pack(anchor='e')

        self._load_values()
        self._apply_lock()
        # closing the root must route through the analysis window's own
        # close protocol: Tk destroys Toplevels WITHOUT firing their
        # WM_DELETE_WINDOW, which would kill a running child process with
        # no confirmation, mid-append
        self.protocol('WM_DELETE_WINDOW', self._on_close_root)

    def _widget_for(self, name, parent):
        validator = validate_map.get(name)
        if validator is not None:
            # widgets hold raw strings; validators expect coerced values
            # ('' -> None for optional fields, numerics per annotation).
            # The exemption rule itself is single-sourced in
            # validation.watch_exempt; only the live-checkbox read is
            # widget-specific (the viewmodel sees coerced values, this
            # sees the checkbox as the user toggles it)
            validator = (lambda raw, _v=validator, _n=name:
                         ArgValid(True, None)
                         if watch_exempt(_n, self._watch_checked())
                         else _v(coerce_field(_n, raw)))
        if name in ('dir_audio', 'dir_out'):
            return FilePathEntry(parent, name, validator, self._on_change)
        if name in ('verbosity_print', 'verbosity_log'):
            return DropDownEntry(parent, name, list(loglevels), validator,
                                 self._on_change)
        if name == 'profile':
            # one-flag deployment preset (docs/tuning.md "Profiles");
            # blank = none, matching the CLI's optional flag
            return DropDownEntry(parent, name, ['', 'field', 'strict'],
                                 validator, self._on_change)
        if field_types().get(name) is bool:
            return CheckBoxEntry(parent, name, None, self._on_change)
        return TextEntry(parent, name, validator, self._on_change)

    def _build_fields(self, parent, names):
        for name in names:
            w = self._widget_for(name, parent)
            w.pack(fill='x', pady=2)
            self.entries[name] = w

    def _toggle_advanced(self):
        if self.advanced_open.get():
            self.advanced_frame.pack(fill='x')
        else:
            self.advanced_frame.pack_forget()

    def _load_values(self):
        self._syncing = True
        try:
            for name, w in self.entries.items():
                value = self.model.values.get(name)
                if isinstance(value, list):
                    value = ' '.join(value)
                w.set(value)
        finally:
            self._syncing = False

    def _apply_lock(self):
        """Disable schema-determining controls when the output folder's
        manifest pins them (the resume-compatibility lock)."""
        locked = self.model.apply_manifest_lock()
        unlocked = [n for n in ('modelname', 'classes_out', 'precision',
                                'framehop_prop')
                    if n in self.entries and n not in locked]
        self._syncing = True
        try:
            for name in locked:
                if name in self.entries:
                    value = self.model.values[name]
                    if isinstance(value, list):
                        value = ' '.join(value)
                    w = self.entries[name]
                    want = '' if value is None else str(value)
                    if w.get() != want:
                        w.set(value)
                    w.set_enabled(False)
            # dir_out changed away from a manifested folder: re-enable
            for name in unlocked:
                self.entries[name].set_enabled(True)
        finally:
            self._syncing = False

    def _on_close_root(self):
        win = getattr(self, '_analysis_window', None)
        if win is not None and win.winfo_exists():
            win.lift()
            win._on_close()  # owns the 'stop and close?' prompt
            if win.winfo_exists():
                return  # user declined stopping the running analysis
        self.destroy()

    def _on_change(self):
        if self._syncing:
            return
        self._pull_values()
        self._apply_lock()
        self._sync_cross_field()

    def _sync_cross_field(self):
        """Keep cross-field validation messages live: editing EITHER alert
        field must update (or clear) the message on the other — a stale
        'needs alert_classes' on the threshold widget after the user just
        typed the classes in would show a false invalid state until the
        next Analyze click."""
        # dir_out is in the live set for the orphan-results check (results
        # present, manifest missing/unreadable): browsing to such a folder
        # must flag the field immediately, not on the Analyze click — the
        # view-model bounds and caches the underlying directory walk
        for name in ('alert_classes', 'alert_threshold', 'alert_command',
                     'dir_out'):
            w = self.entries.get(name)
            if w is None or not w.validate():
                continue  # the per-field error owns the message line
            v = self.model.validate_field(name)
            if not v.valid:
                w.show_error(v.message)
        # the watch checkbox changes dir_audio's validity (the one
        # documented exemption, validation.watch_exempt): re-render its
        # message on EVERY change so toggling watch clears a stale
        # 'folder does not exist' error (or restores a missing one)
        w = self.entries.get('dir_audio')
        if w is not None:
            w.validate()

    def _pull_values(self):
        for name, w in self.entries.items():
            self.model.values[name] = coerce_field(name, w.get())

    def _watch_checked(self) -> bool:
        w = getattr(self, 'entries', {}).get('watch')
        try:
            return bool(w.get()) if w is not None else False
        except Exception:
            return False

    def launch(self):
        # one analysis window at a time: two children appending to the same
        # partial CSVs would violate the checkpoint format's single-writer
        # assumption (a double-click must not double-analyze)
        existing = getattr(self, '_analysis_window', None)
        if existing is not None and existing.winfo_exists():
            existing.lift()
            existing.focus_set()
            return
        self._pull_values()
        invalid = [n for n, w in self.entries.items() if not w.validate()]
        # cross-field rules (e.g. alert_threshold without alert_classes)
        # live in the view-model, where a field can see the others; per-
        # widget validation above cannot express them, and without this
        # gate the misconfig would pass the form and crash the spawned
        # analysis process instead of failing inline
        for name, v in self.model.validate_all().items():
            if not v.valid and name in self.entries and name not in invalid:
                # the widget's own validate() just passed and cleared its
                # message line — surface the cross-field reason there
                self.entries[name].show_error(v.message)
                invalid.append(name)
        if invalid:
            # make the failure visible: the invalid field may sit inside
            # the collapsed advanced section, where its inline message is
            # hidden and the button would appear to do nothing
            if any(n in ADVANCED_FIELDS for n in invalid):
                self.advanced_open.set(True)
                self._toggle_advanced()
            self.status_label.config(
                text=f"fix invalid settings: {', '.join(invalid)}")
            self.bell()
            return
        self.status_label.config(text='')
        self.model.save_cache()
        from buzzdetect_torch.gui.analysis import AnalysisWindow
        self._analysis_window = AnalysisWindow(self,
                                               self.model.analyze_kwargs())

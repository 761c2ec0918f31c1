"""Reusable labeled form widgets with inline validation messages.

Parity: reference `src/gui/ctk_entries.py:12-100` (AbstractEntry /
TextEntry / FilePathEntry / DropDownEntry / CheckBoxEntry), rebuilt on
stdlib tkinter/ttk instead of customtkinter.

Copy of ``buzzdetect_tpu/gui/widgets.py``, import prefix changed; no other
edit.
"""

import tkinter as tk
from tkinter import filedialog, ttk

from buzzdetect_torch.gui import config as gui_cfg


class AbstractEntry(ttk.Frame):
    """Label + input + validation message line."""

    def __init__(self, parent, label, validator=None, on_change=None):
        super().__init__(parent)
        self.validator = validator
        self.on_change = on_change
        self.label = ttk.Label(self, text=label)
        self.label.grid(row=0, column=0, sticky='w', padx=4)
        self.message = ttk.Label(self, text='', foreground='#e05050')
        self.message.grid(row=1, column=0, columnspan=3, sticky='w', padx=4)

    def get(self):
        raise NotImplementedError

    def set(self, value):
        raise NotImplementedError

    def set_enabled(self, enabled: bool):
        raise NotImplementedError

    def show_error(self, message):
        """Render an externally supplied validation failure — cross-field
        rules are checked by the view-model (which can see every field);
        this widget's own validator cannot express them."""
        self.message.configure(text=message or 'invalid',
                               foreground=gui_cfg.LEVEL_COLORS['ERROR'])

    def validate(self) -> bool:
        if self.validator is None:
            return True
        result = self.validator(self.get())
        if not result.valid:
            self.message.configure(text=result.message or 'invalid',
                                   foreground=gui_cfg.LEVEL_COLORS['ERROR'])
            return False
        if result.message:  # valid-with-warning
            self.message.configure(text=result.message,
                                   foreground=gui_cfg.LEVEL_COLORS['WARNING'])
        else:
            self.message.configure(text='')
        return True

    def _changed(self, *_):
        self.validate()
        if self.on_change:
            self.on_change()


class TextEntry(AbstractEntry):
    def __init__(self, parent, label, validator=None, on_change=None):
        super().__init__(parent, label, validator, on_change)
        self.var = tk.StringVar()
        self.entry = ttk.Entry(self, textvariable=self.var, width=40)
        self.entry.grid(row=0, column=1, sticky='we', padx=4)
        self.var.trace_add('write', self._changed)

    def get(self):
        return self.var.get()

    def set(self, value):
        self.var.set('' if value is None else str(value))

    def set_enabled(self, enabled):
        self.entry.configure(state='normal' if enabled else 'disabled')


class FilePathEntry(TextEntry):
    """Text entry plus a directory-browse button."""

    def __init__(self, parent, label, validator=None, on_change=None):
        super().__init__(parent, label, validator, on_change)
        self.button = ttk.Button(self, text='Browse…', command=self._browse)
        self.button.grid(row=0, column=2, padx=4)

    def _browse(self):
        path = filedialog.askdirectory()
        if path:
            self.var.set(path)

    def set_enabled(self, enabled):
        super().set_enabled(enabled)
        self.button.configure(state='normal' if enabled else 'disabled')


class DropDownEntry(AbstractEntry):
    def __init__(self, parent, label, options, validator=None, on_change=None):
        super().__init__(parent, label, validator, on_change)
        self.var = tk.StringVar()
        self.box = ttk.Combobox(self, textvariable=self.var, values=options,
                                state='readonly', width=38)
        self.box.grid(row=0, column=1, sticky='we', padx=4)
        self.var.trace_add('write', self._changed)

    def get(self):
        return self.var.get()

    def set(self, value):
        self.var.set('' if value is None else str(value))

    def set_enabled(self, enabled):
        self.box.configure(state='readonly' if enabled else 'disabled')


class CheckBoxEntry(AbstractEntry):
    def __init__(self, parent, label, validator=None, on_change=None):
        super().__init__(parent, label, validator, on_change)
        self.var = tk.BooleanVar()
        self.box = ttk.Checkbutton(self, variable=self.var,
                                   command=self._changed)
        self.box.grid(row=0, column=1, sticky='w', padx=4)

    def get(self):
        return bool(self.var.get())

    def set(self, value):
        self.var.set(bool(value))

    def set_enabled(self, enabled):
        self.box.configure(state='normal' if enabled else 'disabled')

"""GUI front-end (tkinter). Launch with ``python -m buzzdetect_torch.gui``.

Parity with the reference GUI (`buzzdetect_gui.py:8-31`, `src/gui/`):
splash -> validated settings form (with manifest locking and a settings
cache) -> analysis window running the pipeline in a child process with live
colored logs and stop/rerun. The view-model (`viewmodel.py`) holds all the
logic and runs headless; the tkinter layer is a thin shell.

Copy of ``buzzdetect_tpu/gui/__init__.py``, import prefix changed; no other
edit. Also installed as ``buzzdetect-torch-gui``.
"""


def analyze_gui():
    import multiprocessing
    multiprocessing.freeze_support()
    try:
        multiprocessing.set_start_method('spawn', force=True)
    except RuntimeError:
        pass

    from buzzdetect_torch.gui.splash import SplashScreen
    from buzzdetect_torch.gui.settings import AnalysisSettings

    splash = SplashScreen()
    splash.mainloop()

    window = AnalysisSettings()
    window.mainloop()

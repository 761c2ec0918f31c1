"""Splash screen (parity: reference `src/gui/splashscreen.py:7-51`).

Copy of ``buzzdetect_tpu/gui/splash.py``; no edit.
"""

import tkinter as tk


class SplashScreen(tk.Tk):
    def __init__(self, duration_ms: int = 1200):
        super().__init__()
        self.overrideredirect(True)
        w, h = 420, 180
        x = (self.winfo_screenwidth() - w) // 2
        y = (self.winfo_screenheight() - h) // 2
        self.geometry(f'{w}x{h}+{x}+{y}')
        frame = tk.Frame(self, bg='#20242c')
        frame.pack(fill='both', expand=True)
        tk.Label(frame, text='buzzdetect', fg='#f2c744', bg='#20242c',
                 font=('TkDefaultFont', 28, 'bold')).pack(expand=True)
        tk.Label(frame, text='TPU-native bioacoustics inference',
                 fg='#aaaaaa', bg='#20242c').pack()
        self.after(duration_ms, self.destroy)

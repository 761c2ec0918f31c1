"""The full field-monitoring loop in one runnable script.

Counterpart of ``examples/field_monitoring.py``. A deployment at a hive
looks like: a recorder writes files into a directory; buzzdetect watches
it, analyzing new audio as it lands; detections announce themselves the
moment scores materialize — in the log AND through a notification
command; afterwards, the archived scores are re-thresholded into events,
exported for annotation tools, and cut into listenable clips. This script
runs that whole loop against a simulated recorder. Edits: it runs as a
module and analyzes on ``--device`` (the card unless told ``cpu``).

    python -m buzzdetect_torch.examples.field_monitoring [--device cpu]
"""

import argparse
import os
import tempfile
import threading
import time

import numpy as np


def _recording(seconds, seed, buzzy=False, rate=16000):
    t = np.arange(int(seconds * rate)) / rate
    x = 0.02 * np.random.default_rng(seed).standard_normal(len(t))
    if buzzy:
        seg = (seconds * 0.3 <= t) & (t < seconds * 0.6)
        x[seg] += sum(0.15 / k * np.sin(2 * np.pi * 220 * k * t[seg])
                      for k in (1, 2, 3))
    return x


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument('--device', choices=('cuda', 'cpu'), default='cuda')
    args = ap.parse_args(argv)

    from buzzdetect_torch.models.classifier import resolve_device
    resolve_device(args.device)   # CUDA without a card raises here

    from buzzdetect_torch import analyze
    from buzzdetect_torch.utils import write_wav
    from buzzdetect_torch.write.detections import (call_detections_directory,
                                                   write_audacity_labels,
                                                   write_event_clips)

    with tempfile.TemporaryDirectory() as td:
        dir_audio = os.path.join(td, 'recorder')
        dir_out = os.path.join(td, 'results')
        notify_log = os.path.join(td, 'notifications.txt')
        os.makedirs(dir_audio)

        # --- the "recorder": drops a new file every couple of seconds ----
        def recorder():
            write_wav(os.path.join(dir_audio, 'hive_0001.wav'),
                      _recording(10, seed=1, buzzy=True))
            time.sleep(2.0)
            write_wav(os.path.join(dir_audio, 'hive_0002.wav'),
                      _recording(10, seed=2))
            time.sleep(2.0)
            write_wav(os.path.join(dir_audio, 'hive_0003.wav'),
                      _recording(10, seed=3, buzzy=True))

        rec = threading.Thread(target=recorder, daemon=True)
        rec.start()

        # --- live monitoring: watch + alerts + notification hook ---------
        # the hook is any shell command; event data arrives in BUZZ_* env
        # vars (class, ident, audio path, span, peak) — here it appends to
        # a file, in the field it would hit an SMS gateway or MQTT broker
        print(f'watching the recorder directory (10 cycles) on '
              f'{args.device}...')
        # profile='field' = the one-flag throughput preset (mu-law wire;
        # its digital-silence caveat is logged and the output manifest
        # records the profile)
        analyze(modelname='model_general_v3', dir_audio=dir_audio,
                dir_out=dir_out, verbosity_print='WARNING',
                profile='field', device=args.device,
                watch=True, watch_interval=1.0, watch_cycles=10,
                alert_classes='ins_buzz', alert_threshold=-2.0,
                alert_command=(
                    'echo "ALERT $BUZZ_CLASS in $BUZZ_IDENT '
                    f'$BUZZ_START-${{BUZZ_END}}s" >> {notify_log}'))
        rec.join(timeout=30)

        alerts = []
        if os.path.exists(notify_log):
            with open(notify_log) as f:
                alerts = f.readlines()
            print('\nnotifications delivered by the alert command:')
            print('  ' + '  '.join(alerts))

        # --- after the session: archive -> events -> review artifacts ----
        events = call_detections_directory(dir_out, threshold=-2.0)
        print(f'{len(events)} event(s) re-called from the archive '
              f'(matches the live alerts by construction):')
        for e in events:
            print(f"  {e['ident']}: {e['start']:.2f}-{e['end']:.2f}s "
                  f"(peak {e['activation_max']:+.2f})")

        labels = write_audacity_labels(events, os.path.join(td, 'labels'))
        clips = write_event_clips(events, dir_audio,
                                  os.path.join(td, 'clips'), pad_s=1.0)
        print(f'\nwrote {len(labels)} Audacity label track(s) and '
              f'{len(clips)} reviewable clip(s):')
        for p in clips:
            print(f'  {os.path.basename(p)}')
        return alerts, events, labels, clips


if __name__ == '__main__':
    main()

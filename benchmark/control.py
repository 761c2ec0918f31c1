"""The two readings each correctness limit is set between, judged as a run
judges its window.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

For each seed it makes the cell's traffic at the cell's own size, as a run
does, computes the plain reference's scores in the configuration's
function, and puts two sets of answers through the run's own checks
(``checks.answer_checks``, with the cell's limits):

* the control: the plain reference computed in the configuration's
  ``control_function``, the precision just below the one it states (TF32
  under f32, e4m3 fp8 under bf16), in the program's place;
* the program: each distinct chunk once through the cell's own path
  (``predict_async`` on the wire buffer inside the dispatch thread's
  stream scope, and the copy back).

It prints each reading beside its limit and exits with 0 only where the
control came out not correct and the program correct on every seed. The
benchmark's own runs never run this.
"""

import argparse
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


class Args:
    trace = 0

    def __init__(self, workload, seed, seconds, rehearse):
        self.workload, self.seed, self.seconds = workload, seed, seconds
        self.rehearse = rehearse


def program_outputs(model, inputs: dict):
    """[(key, scores)] of each input once through the cell's path."""
    from benchmark import program
    outs = []
    with program.dispatch_scope(model):
        for k, x in inputs.items():
            outs.append((k, program.collect(*program.dispatch(model, x))))
    return outs


def judged(run, model):
    """(the control's checks, the program's checks) of one seed."""
    from benchmark import checks
    inputs = dict(enumerate(run.generate()['chunks']))
    refs = run.reference(inputs)
    ctrl = run.reference(inputs, run.config['control_function'])
    control = checks.answer_checks(list(ctrl.items()), refs, run.limits,
                                   len(inputs))
    prog = checks.answer_checks(program_outputs(model, inputs), refs,
                                run.limits, len(inputs))
    return control, prog


def _line(checks_) -> str:
    return ', '.join(f'{c.name} {c.value!r} (limit {c.limit!r})'
                     for c in checks_)


def main(argv=None, root=ROOT):
    """``root`` holds ``BENCHMARK.json`` and the ``benchmark`` folder it
    names files in (the checkout's own by default)."""
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True, help='comma-separated seeds')
    ap.add_argument('--rehearse', action='store_true',
                    help='the CPU at the rehearsal sizes')
    args = ap.parse_args(argv)
    from benchmark import program
    from benchmark.manifest import Benchmark
    from benchmark.run import Run
    bench = Benchmark(root)
    cell = bench.cell(args.workload, rehearse=args.rehearse)
    model = None
    sound = True
    for seed in (int(s) for s in args.seeds.split(',')):
        with tempfile.TemporaryDirectory(prefix='control_') as tmp:
            run = Run(Args(args.workload, seed, 0.0, args.rehearse), bench,
                      cell, tmp)
            if model is None:
                model = program.load_model(run.config, run.device)
            t0 = time.perf_counter()
            control, prog = judged(run, model)
        c_ok = all(c.ok for c in control)
        p_ok = all(c.ok for c in prog)
        sound &= p_ok and not c_ok
        print(f'{args.workload} seed {seed}: control '
              f'({cell["config"]["control_function"]}) '
              f'{"correct" if c_ok else "not correct"}: {_line(control)}; '
              f'program {"correct" if p_ok else "not correct"}: '
              f'{_line(prog)} ({time.perf_counter() - t0:.1f} s on '
              f'{run.card})', flush=True)
    print(f'{args.workload}: '
          + ('the control failed and the program passed on every seed'
             if sound else 'NOT SOUND: a control passed or the program '
             'failed'), flush=True)
    return 0 if sound else 1


if __name__ == '__main__':
    sys.exit(main())

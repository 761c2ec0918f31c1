"""One run of one benchmark cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Sets up (loads, builds, warms every shape the cell uses: ``setup_s``, from
the process's start), drives the cell's entry into the program for
``--seconds``, checks what the window produced against the plain reference,
and prints one JSON line: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` and, traced, ``breakdown``; last, ``checks``:
each number compared beside its limit, which also close standard error.

It needs as many CUDA devices as the cell asks for and exits with 2
otherwise. ``--rehearse`` runs the same steps on the CPU, with the
``rehearsal`` entries of the configuration (a tiny bundle, say) and of the
traffic file (tiny sizes) merged over them; its last line starts with
``rehearsal:`` and carries no metric, since a CPU run measures nothing of
the card.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'buzzdetect_tpu')
CACHES = {'TORCH_EXTENSIONS_DIR': 'torch_extensions',
          'TRITON_CACHE_DIR': 'triton'}


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    ap.add_argument('--rehearse', action='store_true',
                    help='run on the CPU at the rehearsal sizes; no metrics')
    return ap.parse_args(argv)


def forbidden_modules():
    """Top-level names of loaded modules that the run may not hold."""
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What an entry and a metric reader see of one run."""

    sample_rate = 16000

    def __init__(self, args, bench, cell, tmpdir):
        import torch
        self.torch = torch
        self.bench, self.cell = bench, cell
        self.seed, self.seconds = args.seed, args.seconds
        self.rehearse = args.rehearse
        self.config = cell['config']
        self.params = cell['traffic']['params']
        self.limits = cell['limits']
        self.device = 'cpu' if self.rehearse else 'cuda'
        self.tmpdir = tmpdir
        self.tracer = None
        self.trace = None
        self.outcome = None
        self.setup_s = None
        if args.trace:
            from benchmark.trace import Tracer
            self.tracer = Tracer(tmpdir, cuda=not self.rehearse)
        self.card = (torch.cuda.get_device_name(0) if not self.rehearse
                     else 'cpu')

    def mark(self, what: str):
        """Print how far into the process a step of the set-up ended."""
        print(f'setup: {what} at {time.perf_counter() - T_START:.3f} s',
              file=sys.stderr, flush=True)

    def generate(self):
        """The cell's traffic, from the seed."""
        gen = self.bench.module('traffic', self.cell['traffic']['generator'])
        out = gen.generate(self.params, self.config, self.seed)
        self.mark('traffic made')
        return out

    def sync(self):
        if not self.rehearse:
            self.torch.cuda.synchronize()

    def reference(self, inputs: dict, precision: str = None) -> dict:
        """The plain reference's scores for {key: int16 samples}."""
        from benchmark import checks
        return checks.reference_scores(self.config, inputs, self.device,
                                       precision, root=self.bench.root)


def print_usage(a, b):
    """The process's host work over the window, on standard error."""
    print(f'window host: user {b.ru_utime - a.ru_utime:.3f} s, system '
          f'{b.ru_stime - a.ru_stime:.3f} s of CPU', file=sys.stderr)


def device_info(run, peak):
    info = {'platform': 'gpu', 'kind': run.card, 'count': run.cell['chips'],
            'memory_peak_bytes': peak}
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit', '--format=csv,noheader',
             '-i', '0'], capture_output=True, text=True, timeout=30)
        info['power_limit'] = out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        info['power_limit'] = 'not read'
    return info


def read_metrics(run, metrics, required):
    from benchmark.manifest import reference_of
    reference = reference_of(run.config)
    out = {}
    for m in metrics:
        value = run.bench.reader(m['name'], reference)(run)
        if value is None:
            if required:
                raise RuntimeError(f'{m["name"]}: nothing to read')
            continue
        out[m['name']] = {'value': float(value), 'unit': m['unit']}
    return out


def main(argv=None, root=ROOT):
    """One run; ``root`` holds ``BENCHMARK.json`` and the ``benchmark``
    folder it names files in (the checkout's own by default)."""
    args = parse(argv)
    for var, sub in CACHES.items():
        os.environ[var] = os.path.join(ROOT, '.cache', sub)
    os.environ['USE_FLAX'] = '0'
    from benchmark.manifest import Benchmark
    bench = Benchmark(root)
    cell = bench.cell(args.workload, rehearse=args.rehearse)
    threads = str(cell['config']['host_threads'])
    for var in ('OMP_NUM_THREADS', 'MKL_NUM_THREADS'):
        os.environ[var] = threads
    import torch
    if not args.rehearse and (not torch.cuda.is_available()
                              or torch.cuda.device_count() < cell['chips']):
        print(f'{args.workload} needs {cell["chips"]} CUDA device(s); torch '
              f'finds {torch.cuda.device_count()}', file=sys.stderr)
        return 2
    params = cell['traffic']['params']
    if args.trace and 'trace_seconds' in params and not args.rehearse and (
            params['trace_after'] * args.seconds + params['trace_lead']
            + params['trace_seconds'] >= args.seconds):
        print('the traced window does not fit in --seconds', file=sys.stderr)
        return 2
    tmpdir = tempfile.mkdtemp(prefix='bench_')
    try:
        return _run(args, bench, cell, tmpdir)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)


def _run(args, bench, cell, tmpdir):
    run = Run(args, bench, cell, tmpdir)
    torch = run.torch
    run.mark('torch imported')
    if not run.rehearse:
        torch.zeros(1, device='cuda')
        run.mark('card ready')
    entry = bench.module('entries', cell['traffic']['entry'])
    state = entry.setup(run)
    run.sync()
    run.setup_s = time.perf_counter() - T_START
    usage = resource.getrusage(resource.RUSAGE_SELF)
    run.outcome = entry.window(run, state)
    run.sync()
    print_usage(usage, resource.getrusage(resource.RUSAGE_SELF))
    peak = 0 if run.rehearse else int(torch.cuda.max_memory_allocated())
    entry.release(state)
    if not run.rehearse:
        torch.cuda.empty_cache()
    if run.tracer is not None:
        run.trace = run.tracer.read()
    checks = entry.check(run, state, run.outcome)
    metrics = (cell['per_layer'] if args.trace else cell['end_to_end'])
    result = {'correct': all(c.ok for c in checks),
              'attempted': int(run.outcome['attempted']),
              'failed': int(run.outcome['failed'])}
    values = read_metrics(run, metrics, required=not args.trace
                          and not run.rehearse)
    if run.rehearse:
        result['host_numbers'] = values
        result['device'] = {'platform': 'cpu'}
    else:
        result['metrics'] = values
        result['device'] = device_info(run, peak)
        if run.trace is not None:
            result['device'].update(busy_s=run.trace.busy_s,
                                    window_s=run.trace.window_s)
            result['breakdown'] = run.trace.breakdown()
    found = forbidden_modules()
    if found:
        print(f'the run loaded {", ".join(found)}', file=sys.stderr)
        return 1
    result['checks'] = {c.name: {'value': c.value, 'limit': c.limit}
                        for c in checks}
    for c in checks:
        print(c.line(), file=sys.stderr)
    sys.stderr.flush()
    line = json.dumps(result)
    print(('rehearsal: ' + line) if run.rehearse else line, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())

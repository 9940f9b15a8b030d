"""A per-thread CPU profile of one process, by function, from a sampler.

:class:`ThreadSampler` wakes every ``interval_s``, reads every other
thread's CPU clock (``pthread_getcpuclockid``) and its Python stack
(``sys._current_frames``), and charges the CPU seconds the thread used
since the last wake to the function at the top of its stack (self) and
to every function on it once (inclusive).  A thread inside native code
that released the interpreter lock is charged to the Python function that
called it; one that holds the lock in a long native call (``json.loads``'
scanner) is sampled when it lets go, so its CPU lands on the function it
is in then, usually the caller's next line.  ``cProfile`` cannot do this
on Python 3.12: it is one ``sys.monitoring`` tool for the whole process,
and its timer mixes the threads.

Run a module under it (the profile is written when the module returns or
the process gets SIGINT or SIGTERM; with ``--wait-signal`` it charges
nothing until the first SIGUSR1, and stops at the second)::

    python dist_svgd_torch/tools/thread_profile.py --out PATH [--interval-s S] \\
        [--wait-signal] -- -m dist_svgd_torch.serving.server --checkpoint DIR ...

The script is run by path, and imports nothing of the package itself, so
it profiles whichever checkout's module ``PYTHONPATH`` finds
(``chip_smoke.py --fleet-load --profile`` runs each replica so, and the
router's process in-process).
"""

import json
import os
import re
import sys
import threading
import time
from collections import defaultdict

#: Sampler period, seconds.
INTERVAL_S = 0.002


def _func_key(code):
    path = code.co_filename.replace(os.sep, "/")
    return f"{'/'.join(path.split('/')[-3:])}:{code.co_firstlineno}({code.co_name})"


def _group(name):
    # "Thread-12 (process_request_thread)" and its siblings are one group
    return re.sub(r"\d+", "N", name)


class ThreadSampler:
    """Samples this process's other threads from :meth:`start` to
    :meth:`stop`, charging only while :attr:`active` (:meth:`toggle` turns
    it off and, on again, clears what was charged: the window a caller
    wants, such as a fleet's load, without the process's start-up)."""

    def __init__(self, interval_s=INTERVAL_S, active=True):
        self.interval_s = float(interval_s)
        self.active = active
        self._clear()
        self._last = {}
        self._stop = threading.Event()
        self._thread = None
        self.own_cpu_s = 0.0

    def _clear(self):
        self.self_s = defaultdict(float)
        self.inclusive_s = defaultdict(float)
        self.thread_s = defaultdict(float)
        self.samples = 0
        self._t0 = time.perf_counter()
        self._t1 = None

    def toggle(self, *_):
        """Stop charging, or clear the tables and start again (usable as a
        signal handler)."""
        if self.active:
            self._t1 = time.perf_counter()
        else:
            self._clear()
        self.active = not self.active

    def _tick(self):
        me = threading.get_ident()
        # an ident is reused once its thread ends: the native id tells a
        # new thread from the old one
        threads = {t.ident: (t.name, t.native_id) for t in threading.enumerate()}
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            name, native = threads.get(tid, ("?", None))
            try:
                now = time.clock_gettime(time.pthread_getcpuclockid(tid))
            except OSError:  # the thread ended between the two reads
                continue
            used = now - self._last.get((tid, native), now)
            self._last[(tid, native)] = now
            if used <= 0 or not self.active:
                continue
            self.thread_s[_group(name)] += used
            self.self_s[_func_key(frame.f_code)] += used
            seen = set()
            while frame is not None:
                key = _func_key(frame.f_code)
                if key not in seen:
                    seen.add(key)
                    self.inclusive_s[key] += used
                frame = frame.f_back
        self.samples += 1

    def _run(self):
        while not self._stop.wait(self.interval_s):
            self._tick()
        self.own_cpu_s = time.thread_time()

    def start(self):
        self._thread = threading.Thread(target=self._run, name="thread-profile",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if self.active:
            self._t1 = time.perf_counter()
        return self

    def report(self, top=30):
        """CPU seconds by thread group, and the ``top`` functions by self
        and by inclusive CPU seconds, each with its share of the total."""
        total = sum(self.thread_s.values())

        def rows(table):
            ranked = sorted(table.items(), key=lambda kv: -kv[1])[:top]
            return [[k, round(v, 6), round(v / total, 4) if total else None]
                    for k, v in ranked]

        return {"wall_s": (self._t1 or time.perf_counter()) - self._t0,
                "interval_s": self.interval_s, "samples": self.samples,
                "cpu_s": total, "sampler_cpu_s": self.own_cpu_s, "pid": os.getpid(),
                "by_thread": rows(self.thread_s), "self": rows(self.self_s),
                "inclusive": rows(self.inclusive_s)}


def main(argv=None):
    import argparse
    import runpy
    import signal

    argv = sys.argv[1:] if argv is None else argv
    if "--" not in argv:
        raise SystemExit("usage: thread_profile.py --out PATH [--interval-s S] "
                         "-- -m MODULE [ARGS...]")
    cut = argv.index("--")
    ap = argparse.ArgumentParser(prog="thread_profile.py")
    ap.add_argument("--out", required=True)
    ap.add_argument("--interval-s", type=float, default=INTERVAL_S)
    ap.add_argument("--wait-signal", action="store_true")
    args = ap.parse_args(argv[:cut])
    rest = argv[cut + 1:]
    if rest[:1] != ["-m"] or len(rest) < 2:
        raise SystemExit("thread_profile.py runs a module: -- -m MODULE [ARGS...]")
    # a run by path puts this directory first on sys.path; the module is
    # found as `python -m` finds it, from the working directory
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(os.path.abspath(__file__)):
        sys.path[0] = os.getcwd()
    signal.signal(signal.SIGTERM, signal.default_int_handler)
    sampler = ThreadSampler(args.interval_s, active=not args.wait_signal)
    signal.signal(signal.SIGUSR1, sampler.toggle)
    sampler.start()
    sys.argv = [rest[1], *rest[2:]]
    try:
        runpy.run_module(rest[1], run_name="__main__", alter_sys=True)
    except KeyboardInterrupt:
        pass
    finally:
        sampler.stop()
        with open(args.out, "w") as fh:
            json.dump(sampler.report(), fh)


if __name__ == "__main__":
    main()

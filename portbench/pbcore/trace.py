"""The traced window: ``torch.profiler`` device records, and what the host
was doing while the device idled.

``Tracer`` wraps the window of a ``--trace 1`` run.  It records with
``torch.profiler`` (CUPTI on the card), marks the window with a
``record_function`` span, and samples the main thread's Python stack every
2 ms on a thread of its own.  ``reduce`` then gives

- ``busy_s``: the union of the device's kernel, memcpy and memset intervals
  inside the window (so overlapping records count once);
- ``kernel_s``: the sum of every kernel's time inside the window, whatever
  its name, so a renamed or fused kernel keeps its metrics;
- ``device_ops``: device time by operation name, the ten largest;
- ``idle_gaps``: the time the device idled, by what the main thread was
  running (the innermost frame of the program and, after ``in``, the
  innermost frame of all), the ten largest.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import Counter, defaultdict

import torch

MARK = "portbench.window"
SAMPLE_S = 0.002
PROGRAM = "strainer2_tpu_torch"


def _label(frame) -> str:
    inner = prog = None
    f = frame
    while f is not None:
        name = f.f_code.co_filename
        if inner is None:
            inner = f
        if PROGRAM in name:
            prog = f
            break
        f = f.f_back

    def short(fr):
        mod = fr.f_code.co_filename.rsplit("/", 1)[-1].removesuffix(".py")
        return f"{mod}.{fr.f_code.co_name}"

    if prog is None:
        return f"outside the program: {short(inner)}" if inner is not None else "(no frame)"
    return short(prog) if prog is inner else f"{short(prog)} in {short(inner)}"


class Tracer:
    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self.cuda = cuda
        self.prof = profile(activities=acts)
        self.mark = record_function(MARK)
        self.samples: list = []
        self._stop = threading.Event()
        self._main = threading.get_ident()

    def _sample(self) -> None:
        while not self._stop.wait(SAMPLE_S):
            frame = sys._current_frames().get(self._main)
            if frame is not None:
                self.samples.append((time.time_ns(), _label(frame)))
            del frame

    def __enter__(self):
        self.prof.__enter__()
        self.thread = threading.Thread(target=self._sample, name="portbench-sampler",
                                       daemon=True)
        self.thread.start()
        self.t_mark = time.time_ns()
        self.mark.__enter__()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self.mark.__exit__(None, None, None)
        self._stop.set()
        self.thread.join()
        self.prof.__exit__(None, None, None)
        return False

    def reduce(self) -> dict:
        events = self.prof.profiler.kineto_results.events()
        win = [e for e in events if e.name() == MARK]
        if not win:
            raise RuntimeError("the profiler recorded no window span")
        w0, w1 = win[0].start_ns(), win[0].start_ns() + win[0].duration_ns()
        offset = w0 - self.t_mark  # the sampler's clock to the profiler's
        dev = []
        by_name: dict = defaultdict(int)
        kernel_ns = 0
        for e in events:
            # the window's own span has a device-side twin: not device work
            if e.device_type() != torch.autograd.DeviceType.CUDA or e.name() == MARK \
                    or e.is_user_annotation():
                continue
            a, b = max(e.start_ns(), w0), min(e.start_ns() + e.duration_ns(), w1)
            if b <= a:
                continue
            name = e.name()
            dev.append((a, b))
            by_name[name[:120]] += b - a
            if not name.startswith(("Memcpy", "Memset")):
                kernel_ns += b - a
        dev.sort()
        busy = 0
        gaps = []
        cur = w0
        for a, b in dev:
            if a > cur:
                gaps.append((cur, a))
            if b > cur:
                busy += b - max(a, cur)
                cur = b
        if cur < w1:
            gaps.append((cur, w1))
        idle: dict = defaultdict(float)
        times = [t + offset for t, _ in self.samples]
        labels = [lab for _, lab in self.samples]
        j = 0
        for a, b in gaps:
            while j < len(times) and times[j] < a:
                j += 1
            seen = Counter()
            i = j
            while i < len(times) and times[i] < b:
                seen[labels[i]] += 1
                i += 1
            if not seen:  # a gap shorter than the sampling step: the nearest sample
                near = min((x for x in (j - 1, j) if 0 <= x < len(times)),
                           key=lambda x: abs(times[x] - (a + b) / 2), default=None)
                far = near is None or abs(times[near] - (a + b) / 2) > 5 * SAMPLE_S * 1e9
                idle["(no sample)" if far else labels[near]] += (b - a) / 1e9
                continue
            n = sum(seen.values())
            for lab, c in seen.items():
                idle[lab] += (b - a) / 1e9 * c / n
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
        return {
            "window_s": (w1 - w0) / 1e9,
            "busy_s": busy / 1e9,
            "kernel_s": kernel_ns / 1e9,
            "device_ops": top({k: v / 1e9 for k, v in by_name.items()}),
            "idle_gaps": top(idle),
        }

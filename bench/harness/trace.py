"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` (device
activity only) over whole scheduler ticks, reduced to the device's busy
time (the union of every device activity's interval), each kernel's
device time, and the idle gaps between device activities, each named by
the harness's span (``submit``, ``step``, ``wait``, or ``harness`` between
them) that was open on the host at the gap's middle. The profiler's clock
is the wall clock in ns; the harness's spans are mapped onto it from one
reading of both clocks at the slice's start."""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Tuple

import torch

ACTIVITIES = [torch.profiler.ProfilerActivity.CUDA]
NAME_CHARS = 120        # a kernel's name as the breakdown gives it


class Slice:
    def __init__(self):
        self.prof: Optional[torch.profiler.profile] = None
        self.open = False
        self.t0 = self.t1 = 0.0
        self.wall0 = 0

    @staticmethod
    def warm() -> None:
        """Initialise the profiler once in set-up: its first start is
        slow."""
        x = torch.ones(8, device="cuda")
        with torch.profiler.profile(activities=ACTIVITIES):
            (x + 1).sum().item()

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof = torch.profiler.profile(activities=ACTIVITIES)
        self.prof.__enter__()
        self.open = True
        self.t0 = time.perf_counter()
        self.wall0 = time.time_ns()

    def wall_ns(self, perf: float) -> int:
        """A ``perf_counter`` reading on the profiler's clock."""
        return self.wall0 + int((perf - self.t0) * 1e9)

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.open = False


def _device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every device activity: kernels,
    copies, sets (user annotations left out)."""
    dev = []
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and e.duration_ns() > 0 and not e.is_user_annotation()):
            dev.append((e.name(), e.start_ns(),
                        e.start_ns() + e.duration_ns()))
    return dev


def reduce(sl: Slice, spans, loop_t0: float,
           top: int = 10) -> Dict[str, object]:
    """busy_s, window_s, per-kernel device seconds, the longest idle gaps
    named by the harness's span open at their middle, and the top device
    operations. ``spans`` are ``drive.Span``s, in seconds after
    ``loop_t0`` on the ``perf_counter`` clock."""
    dev = _device_events(sl.prof)
    host = [(s.kind, sl.wall_ns(loop_t0 + s.t0), sl.wall_ns(loop_t0 + s.t1))
            for s in spans]
    window_s = sl.t1 - sl.t0
    per_kernel: Dict[str, float] = collections.defaultdict(float)
    for name, a, b in dev:
        per_kernel[name] += (b - a) * 1e-9
    merged: List[List[int]] = []
    for _, a, b in sorted(dev, key=lambda x: x[1]):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy_s = sum(b - a for a, b in merged) * 1e-9
    host.sort(key=lambda x: x[1])
    gaps = []
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = (a + b) // 2
        name = "harness"
        for lab, s, e in host:
            if s <= mid <= e:
                name = lab
            elif s > mid:
                break
        gaps.append((name, (b - a) * 1e-9))
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    return {"busy_s": busy_s, "window_s": window_s,
            "per_kernel": dict(per_kernel),
            "device_ops": [[k[:NAME_CHARS], v] for k, v in ops[:top]],
            "idle_gaps": [[k, v] for k, v in gaps[:top]]}

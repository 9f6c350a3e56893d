"""The profiler's arithmetic: device time by kernel, busy and idle share,
and what the host was doing while the device sat idle.

After ``chip_smoke.py::profiled`` at commit a36dd41 (device time by kernel
name from ``torch.profiler``'s device records, idle share = 1 - busy / wall),
with one change: busy time is the union of the device records' intervals,
which equals their sum on one stream and does not count twice what two
streams (the data pipeline's link has its own) run at once.

The harness marks its own stretches with ``record_function`` ranges named
``bench.*``; their host intervals share the profiler's clock with the
device records, so a reader can take the device work inside any of them.
"""

from __future__ import annotations

import bisect
import contextlib
from typing import Dict, Iterator, List, Optional, Tuple

SPAN_PREFIX = "bench."


class Trace:
    """The records of one profiled stretch, in nanoseconds on one clock."""

    def __init__(self, device: List[Tuple[int, int, str]], host: List[Tuple[int, int, str]],
                 t0: int, t1: int):
        self.device = sorted(device)        # (start, end, name)
        self.host = sorted(host)            # (start, end, name) on the harness's thread
        self._starts = [h[0] for h in self.host]
        self._spans = sorted(h for h in self.host if h[2].startswith(SPAN_PREFIX))
        self.t0, self.t1 = t0, t1

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        from torch.autograd import DeviceType

        device, host = [], []
        for e in prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    device.append((start, start + dur, e.name()))
            else:
                host.append((start, start + dur, e.name(), e.start_thread_id()))
        spans = [h for h in host if h[2].startswith(SPAN_PREFIX)]
        if spans:
            # The harness's own thread: the data pipeline's prefetch thread
            # runs beside it.
            thread = spans[0][3]
            host = [h for h in host if h[3] == thread]
        host = [h[:3] for h in host]
        if spans:
            t0, t1 = min(s[0] for s in spans), max(s[1] for s in spans)
        elif device or host:
            t0 = min([d[0] for d in device] + [h[0] for h in host])
            t1 = max([d[1] for d in device] + [h[1] for h in host])
        else:
            t0 = t1 = 0
        return cls(device, host, t0, t1)

    def spans(self, name: str) -> List[Tuple[int, int]]:
        return sorted((s, e) for s, e, n in self.host if n == SPAN_PREFIX + name)

    def kernels(self, t0: Optional[int] = None, t1: Optional[int] = None) -> List[Tuple[int, int, str]]:
        """Device records that start inside [t0, t1) (default: all)."""
        lo = self.t0 if t0 is None else t0
        hi = self.t1 if t1 is None else t1
        return [d for d in self.device if lo <= d[0] < hi]

    def busy_ns(self, t0: Optional[int] = None, t1: Optional[int] = None) -> int:
        """Length of the union of device intervals clipped to [t0, t1]."""
        lo = self.t0 if t0 is None else t0
        hi = self.t1 if t1 is None else t1
        busy, cur_s, cur_e = 0, None, None
        for s, e, _ in self.device:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def gaps(self, t0: Optional[int] = None, t1: Optional[int] = None) -> List[Tuple[int, int]]:
        """Stretches of [t0, t1] with no device record running."""
        lo = self.t0 if t0 is None else t0
        hi = self.t1 if t1 is None else t1
        out, cur = [], lo
        for s, e, _ in self.device:
            if e <= cur:
                continue
            if s >= hi:
                break
            if s > cur:
                out.append((cur, s))
            cur = max(cur, e)
        if cur < hi:
            out.append((cur, hi))
        return out

    def host_at(self, t: int, walk: int = 4096) -> str:
        """The innermost host record (an operator or a ``bench.`` range)
        running at ``t`` on the harness's thread: the latest to start of
        those that hold ``t`` (records nest); '(none)' where none does."""
        i = bisect.bisect_right(self._starts, t) - 1
        for j in range(i, max(i - walk, -1), -1):
            s, e, name = self.host[j]
            if e > t:
                return name
        # Past the walk: the host was between operators inside one of the
        # harness's ranges.
        inside = [name for s, e, name in self._spans if s <= t < e]
        return f"{inside[-1]} (between operators)" if inside else "(none)"

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        """The device operations that took most time, and the idle time by
        what the host was doing at the middle of each gap, in seconds."""
        by_name: Dict[str, int] = {}
        for s, e, n in self.kernels():
            by_name[n[:120]] = by_name.get(n[:120], 0) + (e - s)
        by_host: Dict[str, int] = {}
        for s, e in self.gaps():
            label = self.host_at((s + e) // 2)[:120]
            by_host[label] = by_host.get(label, 0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, ns / 1e9] for n, ns in ops],
                "idle_gaps": [[n, ns / 1e9] for n, ns in idle]}


@contextlib.contextmanager
def span(name: str, on: bool) -> Iterator[None]:
    """A ``bench.<name>`` range in the profiler's trace where ``on``."""
    if not on:
        yield
        return
    from torch.profiler import record_function

    with record_function(SPAN_PREFIX + name):
        yield


@contextlib.contextmanager
def profiled(device_type: str) -> Iterator[List[Trace]]:
    """Profile the body; the list it yields holds the ``Trace`` on exit."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    out: List[Trace] = []
    with profile(activities=acts) as prof:
        yield out
    out.append(Trace.from_profiler(prof))

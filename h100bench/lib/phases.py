"""The program's own ranges against the device records their work launched.

The port marks its layers with ``record_function`` ranges named
``dyskew.*`` (``repro_torch.tracing``) while a profiler records.  Here each
device record of the traced stretch is joined to the launch call that
enqueued it (a kernel launch, a copy or a memset on the host), and belongs
to a range when that call ran inside one of the range's intervals: a range
of one name is the union of its intervals, on the profiler's clock.  A
device record with no launch call is ``(unattributed)``; one launched
outside every range is ``(outside)``.

The join is made from what ``lib.trace.Trace`` keeps, which has no
correlation ids: the host records of the harness's thread (the port runs a
traced step's backward on the calling thread, so they hold the whole step;
the profiler files the launch calls of the data pipeline's prefetch thread
there too) and every device record.  A device runs one stream's records
in the order they were launched, so the i-th record is the i-th call's;
the pipeline's few records, on a stream of their own, may trade places
with their neighbours, and the owners of the step's records between the
two places then shift by one call.  So a reading joined through ``pair``
in a training stretch, where the pipeline launches, is approximate: two
stretches of one process agreed to 5 % on the optimizer's device time.
Where the two are not as many (the profiler loses
a record now and then), the calls or records in excess are passed over
where the kinds (kernel, copy, memset) of the two sequences part
(``pair``), and a record passed over is ``(unattributed)``.

Range membership is by the host time of the launch call, and the data
pipeline's launch calls lie on the harness's thread in this trace: a count
of launches inside a range of a training stretch counts those that fall
inside it too.  A serving stretch has no second thread.

Every reading is None where the run has nothing to read: no trace, no
device record (the CPU), or no ``dyskew.`` range (a program without them).
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

PREFIX = "dyskew."
#: Host calls that enqueue one device record each.
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel", "cudaMemcpy", "cudaMemset",
            "cuMemcpy", "cuMemset")
#: How far ahead ``pair`` compares kinds where they part.
LOOK = 64
UNATTRIBUTED = "(unattributed)"
OUTSIDE = "(outside)"


@dataclasses.dataclass
class Joined:
    """A profile's ``dyskew.`` ranges, as merged intervals by name (prefix
    dropped), the launch calls' start times, the device records, for each
    record the index of its call (-1: none), and the union of the records'
    intervals with its running length."""

    ranges: Dict[str, List[Tuple[int, int]]]
    calls: List[int]
    device: List[Tuple[int, int, str]]
    owner: List[int]
    busy: List[Tuple[int, int]] = dataclasses.field(init=False)
    _busy_before: List[int] = dataclasses.field(init=False)

    def __post_init__(self):
        self.busy = merge([(s, e) for s, e, _ in self.device])
        self._busy_before = [0]
        for s, e in self.busy:
            self._busy_before.append(self._busy_before[-1] + e - s)

    def busy_ns(self, lo: int, hi: int) -> int:
        """Length of the union of device records inside [lo, hi)."""
        i = bisect.bisect_right(self.busy, (lo, lo))
        k = bisect.bisect_left(self.busy, (hi, hi))
        total = self._busy_before[k] - self._busy_before[i]
        if i > 0:                                  # a run begun before lo
            total += max(0, min(self.busy[i - 1][1], hi) - lo)
        if k > i and self.busy[k - 1][1] > hi:     # the last run past hi
            total -= self.busy[k - 1][1] - hi
        return total


def merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def kind(name: str) -> str:
    """What a launch call or a device record moves: a copy, a memset or a
    kernel."""
    if name.startswith(("cudaMemcpy", "cuMemcpy", "Memcpy")):
        return "copy"
    return "memset" if name.startswith(("cudaMemset", "cuMemset", "Memset")) else "kernel"


def pair(calls: List[str], device: List[str]) -> List[int]:
    """For each device record, the index of the launch call that enqueued
    it, or -1, from the kinds of the calls and of the records, each in the
    order of their starts.  Call i takes record i, except that where the
    two lists differ in length, as many calls (or records) as the
    difference are passed over, each where the kinds part and passing it
    over lets the next ``LOOK`` agree further."""
    n, m = len(calls), len(device)
    skip_calls, skip_records = max(n - m, 0), max(m - n, 0)

    def agree(i: int, j: int) -> int:
        k = 0
        while k < LOOK and i + k < n and j + k < m and calls[i + k] == device[j + k]:
            k += 1
        return k

    owner = [-1] * m
    i = j = 0
    while i < n and j < m:
        if calls[i] != device[j]:
            here = agree(i, j)
            if skip_calls and agree(i + 1, j) > here:
                skip_calls, i = skip_calls - 1, i + 1
                continue
            if skip_records and agree(i, j + 1) > here:
                skip_records, j = skip_records - 1, j + 1
                continue
        owner[j] = i
        i, j = i + 1, j + 1
    return owner


def join_records(host: List[Tuple[int, int, str]], device: List[Tuple[int, int, str]]) -> Optional[Joined]:
    """The join of the host records (start, end, name) and the device
    records of one profile; None without a ``dyskew.`` range or a device
    record.  Every record of the profile counts, not only those that start
    inside the harness's ranges: the device's clock agrees with the host's
    only to within a few ms, so the last work may seem to start after the
    range that waited for it."""
    ranges: Dict[str, List[Tuple[int, int]]] = {}
    calls = []
    for s, e, n in host:
        if n.startswith(PREFIX):
            ranges.setdefault(n[len(PREFIX):], []).append((s, e))
        elif n.startswith(LAUNCHES):
            calls.append((s, kind(n)))
    if not ranges or not device:
        return None
    calls.sort()
    dev = sorted(device)
    owner = pair([k for _, k in calls], [kind(n) for _, _, n in dev])
    return Joined({k: merge(v) for k, v in ranges.items()}, [t for t, _ in calls], dev, owner)


@functools.lru_cache(maxsize=1)
def join(trace) -> Optional[Joined]:
    """``join_records`` over a ``lib.trace.Trace``'s profile."""
    return join_records(trace.host, trace.device)


def _inside(intervals: List[Tuple[int, int]], t: int) -> bool:
    i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
    return i >= 0 and t < intervals[i][1]


def _within(j: Joined, name: str, lo: Optional[int], hi: Optional[int]) -> List[Tuple[int, int]]:
    """Range ``name``'s intervals, clipped to [lo, hi) where given."""
    iv = j.ranges.get(name, [])
    if lo is None:
        return iv
    return [(max(s, lo), min(e, hi)) for s, e in iv if min(e, hi) > max(s, lo)]


def launches(j: Joined, name: str, lo: Optional[int] = None, hi: Optional[int] = None) -> int:
    """Launch calls made inside range ``name``."""
    iv = _within(j, name, lo, hi)
    return sum(1 for t in j.calls if _inside(iv, t))


def device_ns(j: Joined, name: str, lo: Optional[int] = None, hi: Optional[int] = None) -> int:
    """Summed time of the device records launched inside range ``name``."""
    iv = _within(j, name, lo, hi)
    return sum(e - s for (s, e, _), o in zip(j.device, j.owner) if o >= 0 and _inside(iv, j.calls[o]))


def idle_ns(j: Joined, name: str) -> Tuple[int, int]:
    """(time inside range ``name`` with no device record running, the
    range's whole time)."""
    iv = _within(j, name, None, None)
    whole = sum(e - s for s, e in iv)
    return whole - sum(j.busy_ns(s, e) for s, e in iv), whole


def by_span(j: Joined) -> Dict[str, Dict[str, float]]:
    """For each range, the launch calls made inside it, the device ms they
    launched and the ms inside it with the device idle; then the device
    records launched outside every range and those with no launch call."""
    out: Dict[str, Dict[str, float]] = {}
    for name in sorted(j.ranges):
        out[name] = {"launches": launches(j, name), "device_ms": device_ns(j, name) / 1e6,
                     "idle_ms": idle_ns(j, name)[0] / 1e6}
    every = merge([iv for ivs in j.ranges.values() for iv in ivs])
    out[OUTSIDE] = {"launches": sum(1 for t in j.calls if not _inside(every, t)),
                    "device_ms": sum(e - s for (s, e, _), o in zip(j.device, j.owner)
                                     if o >= 0 and not _inside(every, j.calls[o])) / 1e6}
    lost = [d for d, o in zip(j.device, j.owner) if o < 0]
    out[UNATTRIBUTED] = {"records": len(lost), "of_records": len(j.device),
                         "device_ms": sum(e - s for s, e, _ in lost) / 1e6,
                         "calls_without_record": len(j.calls) - (len(j.device) - len(lost))}
    return out


# ---------------------------------------------------------------------- #
# Readings of a run (``lib.cell.Run``) for the readers under ``metrics/``
# ---------------------------------------------------------------------- #


def _joined(run, span: Optional[str]) -> Tuple[Optional[Joined], Optional[int], Optional[int]]:
    """The run's join and the extent of its harness range ``bench.<span>``
    (None: no limit); a None join where either is missing."""
    j = None if run.traced is None else join(run.traced)
    if j is None or span is None:
        return j, None, None
    spans = run.traced.spans(span)
    return (j, spans[0][0], spans[-1][1]) if spans else (None, None, None)


def launches_per_step(run, name: str, span: Optional[str], steps_key: str) -> Optional[float]:
    j, lo, hi = _joined(run, span)
    return None if j is None else launches(j, name, lo, hi) / run.traced_info[steps_key]


def device_ms(run, name: str, span: Optional[str], steps_key: Optional[str] = None) -> Optional[float]:
    j, lo, hi = _joined(run, span)
    if j is None:
        return None
    ms = device_ns(j, name, lo, hi) / 1e6
    return ms / run.traced_info[steps_key] if steps_key else ms


def idle_pct(run, name: str) -> Optional[float]:
    j, _, _ = _joined(run, None)
    if j is None:
        return None
    idle, whole = idle_ns(j, name)
    return 100.0 * idle / whole if whole else None


"""The device layer: a ``torch.profiler`` trace of the window, read into
device-operation intervals on the host's ``time.perf_counter`` clock.

Two markers, recorded from this thread at known ``perf_counter`` times,
tie the trace's clock to the host's.  A device operation is every kernel,
memory copy and memset in the trace.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK_BEGIN, MARK_END = "bench.mark.begin", "bench.mark.end"


@dataclasses.dataclass
class DeviceSlice:
  """What ran on the device in [t0, t1] (host clock, seconds)."""
  t0: float
  t1: float
  ops: list  # (name, category, start_s, end_s), sorted by start

  @property
  def window_s(self) -> float:
    return self.t1 - self.t0

  def busy_intervals(self) -> list:
    """The union of the device operations' intervals, clipped to the
    slice."""
    merged = []
    for _, _, s, e in self.ops:
      s, e = max(s, self.t0), min(e, self.t1)
      if e <= s:
        continue
      if merged and s <= merged[-1][1]:
        merged[-1][1] = max(merged[-1][1], e)
      else:
        merged.append([s, e])
    return merged

  def busy_s(self) -> float:
    return sum(e - s for s, e in self.busy_intervals())

  def idle_pct(self):
    """Share of the window with no device operation, or None where the
    trace holds none (no device trace: the CPU)."""
    if self.window_s <= 0 or not self.ops:
      return None
    return 100.0 * (1.0 - self.busy_s() / self.window_s)

  def idle_gaps(self) -> list:
    """(start, end) of each stretch of the slice with no device operation."""
    gaps, at = [], self.t0
    for s, e in self.busy_intervals():
      if s > at:
        gaps.append((at, s))
      at = max(at, e)
    if self.t1 > at:
      gaps.append((at, self.t1))
    return gaps

  def kernel_seconds(self) -> dict:
    """Device seconds by operation name, within the slice."""
    out: dict = {}
    for name, _, s, e in self.ops:
      s, e = max(s, self.t0), min(e, self.t1)
      if e > s:
        out[name] = out.get(name, 0.0) + (e - s)
    return out


class Profiler:
  """Start and stop a profiled slice from the thread that owns the run."""

  def __init__(self, cuda: bool = True):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    self._prof = profile(activities=acts)
    self._cuda = cuda
    self._mark0 = self._mark1 = float("nan")

  @staticmethod
  def _mark(name: str) -> float:
    from torch.profiler import record_function
    t = time.perf_counter()
    with record_function(name):
      pass
    return t

  def start(self) -> None:
    """Start profiling; the first start in a process stalls the host for
    seconds, so it comes before the window opens."""
    self._prof.start()
    self._mark0 = self._mark(MARK_BEGIN)

  def stop(self) -> None:
    import torch
    self._mark1 = self._mark(MARK_END)
    if self._cuda:
      torch.cuda.synchronize()
    self._prof.stop()

  def read(self, t0: float, t1: float) -> DeviceSlice:
    """The device operations of [t0, t1] (after ``stop``; exporting the
    trace takes seconds of host time, so it waits until the window is
    over)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
      self._prof.export_chrome_trace(path)
      with open(path) as f:
        trace = json.load(f)
    finally:
      os.unlink(path)
    return read_trace(trace, (self._mark0, self._mark1), t0, t1)


def read_trace(trace: dict, marks_at: tuple, t0: float,
               t1: float) -> DeviceSlice:
  """Device operations of a Chrome trace in [t0, t1], moved onto the host
  clock by the two markers recorded at ``marks_at`` (trace microseconds ->
  perf_counter seconds)."""
  events = trace.get("traceEvents", trace) if isinstance(trace, dict) \
      else trace
  marks = {}
  for ev in events:
    if ev.get("name") in (MARK_BEGIN, MARK_END) and "ts" in ev:
      marks.setdefault(ev["name"], float(ev["ts"]))
  if len(marks) != 2:
    raise RuntimeError("the profiler's trace lacks the benchmark's markers")
  # one offset from the first marker; the second checks the scale
  offset = marks_at[0] - marks[MARK_BEGIN] * 1e-6
  drift = (marks[MARK_END] * 1e-6 + offset) - marks_at[1]
  if abs(drift) > 0.01:
    raise RuntimeError(f"the trace's clock and the host's drift {drift} s "
                       f"apart over the slice")
  ops = []
  for ev in events:
    if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATS:
      s = float(ev["ts"]) * 1e-6 + offset
      e = s + float(ev["dur"]) * 1e-6
      if e > t0 and s < t1:
        ops.append((ev["name"], ev["cat"], s, e))
  ops.sort(key=lambda o: o[2])
  return DeviceSlice(t0, t1, ops)

"""device: share of the profiled window in which no device operation
(kernel, copy or memset) runs."""


def read(run):
  sl = run.device_slice
  return None if sl is None else sl.idle_pct()

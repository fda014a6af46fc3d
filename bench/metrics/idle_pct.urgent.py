"""device: ``idle_pct`` in a cell whose end-to-end metric is the urgent
tail: idle time is where urgent work could have run."""


def read(run):
  sl = run.device_slice
  return None if sl is None else sl.idle_pct()

"""batching / staging: mean host time per batch padding and stacking the
requests (``stack_batch``), the engine's per-bucket ``stack`` histograms
over the window, every bucket together."""


def read(run):
  total = count = 0
  for (_, window), (s, n) in run.hist.items():
    if window == "stack":
      total, count = total + s, count + n
  if count <= 0:
    return None  # no stage stamps: a program without them, or trace off
  return 1e3 * total / count

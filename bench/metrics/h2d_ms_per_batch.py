"""batching / staging: mean host-to-device copy time per batch, timed on the
device by the engine's CUDA events (``h2d`` histograms over the window,
every bucket together)."""


def read(run):
  total = count = 0
  for (_, window), (s, n) in run.hist.items():
    if window == "h2d":
      total, count = total + s, count + n
  if count <= 0:
    return None  # no stage stamps: a program without them, or trace off
  return 1e3 * total / count

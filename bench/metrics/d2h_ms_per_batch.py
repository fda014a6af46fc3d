"""batching / staging: mean device-to-host copy time per batch, every output,
timed on the device by the engine's CUDA events (``d2h`` histograms over
the window, every bucket together)."""


def read(run):
  total = count = 0
  for (_, window), (s, n) in run.hist.items():
    if window == "d2h":
      total, count = total + s, count + n
  if count <= 0:
    return None  # no stage stamps: a program without them, or trace off
  return 1e3 * total / count

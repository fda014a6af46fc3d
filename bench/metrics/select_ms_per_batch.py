"""selection: mean device time per KNN batch of the top-k selection
(``smallest_k``: the sort and its index fill), timed by the engine's CUDA
events (``select`` histograms over the window, every bucket together)."""


def read(run):
  total = count = 0
  for (_, window), (s, n) in run.hist.items():
    if window == "select":
      total, count = total + s, count + n
  if count <= 0:
    return None  # no stage stamps: a program without them, or trace off
  return 1e3 * total / count

"""batching / staging: mean host time per batch of the NaN scan of the results
(``validate_finite``), the engine's ``nan_scan`` histograms over the
window, every bucket together."""


def read(run):
  total = count = 0
  for (_, window), (s, n) in run.hist.items():
    if window == "nan_scan":
      total, count = total + s, count + n
  if count <= 0:
    return None  # no stage stamps: a program without them, or trace off
  return 1e3 * total / count

"""batching / staging: mean host time per batch, the engine's per-bucket
``host`` observations (pad and stack, then split; host clock) over the
window, every bucket together."""


def read(run):
  total = count = 0
  for (_, window), (s, n) in run.hist.items():
    if window == "host":
      total, count = total + s, count + n
  if count <= 0:
    return None
  return 1e3 * total / count

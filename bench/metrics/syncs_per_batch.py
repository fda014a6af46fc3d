"""closure: host synchronisations per batch over the window, from the
engine's counters: each convergence check of a closure's fixpoint loop and
one per output copied to the host (``syncs``), over the batches."""


def read(run):
  syncs = run.counters.get("syncs")
  batches = run.counters.get("batches", 0)
  if not syncs or batches <= 0:
    return None  # no stage stamps: a program without them, or trace off
  return syncs / batches

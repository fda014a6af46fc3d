"""engine: requests per executed batch over ``max_batch``, from the
engine's counters (completed requests and batches) over the window."""


def read(run):
  batches = run.counters.get("batches", 0)
  if batches <= 0:
    return None
  return 100.0 * run.counters["completed"] / (batches * run.max_batch)

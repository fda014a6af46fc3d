"""engine (policy): 95th percentile (nearest rank) of the queue wait, submit
to batch pick, of the deadline-tagged open-loop requests due in the window
that were served, read from the engine's per-request records."""

from bench.lib import stats


def read(run):
  recs = {r.request_id: r for r in run.records}
  waits = [(recs[o.request_id].scheduled_s - recs[o.request_id].arrival_s)
           * 1e3 for o in run.obs
           if o.loop == "open" and o.deadline_s is not None
           and run.t0 <= o.due_s < run.t1 and o.request_id in recs]
  if not waits:
    return None
  return stats.nearest_rank(waits, 95)

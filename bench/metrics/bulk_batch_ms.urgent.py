"""engine (batch cap): mean service time, pick to results, of the
closed-loop (bulk) batches completed in the window while a deadline-tagged
open-loop stream runs beside them: what an urgent request waits behind."""


def read(run):
  if not any(st["loop"] == "open" and st.get("deadline_s") is not None
             for st in run.traffic["streams"]):
    return None
  bulk = {o.request_id for o in run.obs if o.loop == "closed"}
  times = [end - start for _, start, end, ids in run.batches()
           if run.t0 <= end <= run.t1 and bulk.intersection(ids)]
  if not times:
    return None
  return 1e3 * sum(times) / len(times)

"""closure: mean squarings per closure request answered in the window, as
the answers report them (``extras["iterations"]``)."""


def read(run):
  its = [int(o.extras["iterations"]) for o in run.obs
         if o.payload.kind == "closure" and o.state == "done"
         and run.in_window(o) and "iterations" in o.extras]
  if not its:
    return None
  return sum(its) / len(its)

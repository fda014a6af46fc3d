"""whole step: least time for the counted semiring work of every request
answered correctly in the window (each credited with the share of its time
in the system inside the window), over the window's seconds: the window's
share of the chip's peak for that work."""

from bench.lib import stats


def read(run):
  ops = nbytes = 0.0
  for o in run.obs:
    if not run.correct_done(o):
      continue
    parts = run.least_parts(o)
    if parts is None:
      continue
    credit = stats.window_credit(o.sent_s, o.done_s, run.t0, run.t1)
    ops, nbytes = ops + credit * parts[0], nbytes + credit * parts[1]
  if ops <= 0 and nbytes <= 0:
    return None
  return 100.0 * max(ops, nbytes) / run.seconds

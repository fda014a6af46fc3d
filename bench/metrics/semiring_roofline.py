"""kernels: least time for the counted semiring work of the batches that ran
whole inside the profiled slice, over their K1 and K2 device time there.
One metric across both arms (K1 per squaring, K2 fused), so it survives a
change of arm; a batch is matched to its kernels by time (its pick to its
results, from the engine's records)."""

# kernel names of K1 (kernels/csrc/semiring_mmo.cu) and K2
# (kernels/csrc/closure_megakernel.cu)
SEMIRING_KERNELS = ("semiring_mmo_kernel", "semiring_mma_split_kernel",
                    "semiring_mma_tc_kernel", "fixpoint_kernel")


def read(run):
  sl = run.device_slice
  if sl is None:
    return None
  kernels = [(s, e) for name, cat, s, e in sl.ops
             if cat == "kernel" and any(k in name for k in SEMIRING_KERNELS)]
  by_id = {o.request_id: o for o in run.obs}
  ops = nbytes = device = 0.0
  for _, start, end, ids in run.batches():
    if start < sl.t0 or end > sl.t1:
      continue
    parts = [run.least_parts(by_id[i]) for i in ids if i in by_id]
    if not parts or any(p is None for p in parts):
      continue
    t = sum(e - s for s, e in kernels if start <= s <= end)
    if t <= 0:
      continue
    ops += sum(p[0] for p in parts)
    nbytes += sum(p[1] for p in parts)
    device += t
  if device <= 0:
    return None
  return 100.0 * max(ops, nbytes) / device

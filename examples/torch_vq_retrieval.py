"""SIMD² inside the LM framework, on the PyTorch/CUDA port: the two places
the paper's ops appear natively in the assigned architectures (DESIGN.md
§4).

  1. chameleon-style VQ image tokenization — nearest-codebook search is the
     ``addnorm`` instruction (+argmin); runs on the matmul-rewrite arm and
     on the SIMD² unit kernel (K1), validated against brute force.
  2. embedding retrieval (KNN over model embeddings) — the ``knn`` app as a
     serving-side retrieval primitive, on K1.

    PYTHONPATH=src python examples/torch_vq_retrieval.py [--device cpu]

Counterpart of ``examples/vq_retrieval.py``, at its sizes by default (an
8192 × 256 codebook, 2 × 1024 patches, a 50k × 128 table); the size flags
cut them for a quick run.  Each check prints ``<label>: True`` or
``False``; the script exits 1 if any is False.
"""
import argparse
import sys

import numpy as np
import torch


def main(argv=None):
  ap = argparse.ArgumentParser()
  ap.add_argument("--device", default="cuda")
  ap.add_argument("--codes", type=int, default=8192)
  ap.add_argument("--patches", type=int, default=1024)
  ap.add_argument("--table", type=int, default=50000)
  args = ap.parse_args(argv)
  from repro_torch.apps.baselines import knn_np
  from repro_torch.apps.solvers import knn
  from repro_torch.device import resolve_device
  from repro_torch.models.vlm import fuse_streams, vq_tokenize

  dev = resolve_device(args.device)
  rng = np.random.default_rng(0)
  checks = []

  # --- 1. VQ tokenization (chameleon frontend stub) -------------------------
  codebook = rng.standard_normal((args.codes, 256)).astype(np.float32)
  patches = codebook[rng.integers(0, args.codes, (2, args.patches))] \
      + 0.05 * rng.standard_normal((2, args.patches, 256)).astype(np.float32)
  cb_t = torch.from_numpy(codebook).to(dev)
  pt_t = torch.from_numpy(patches).to(dev)
  ids_xla = vq_tokenize(pt_t, cb_t, backend="xla")
  ids_pl = vq_tokenize(pt_t, cb_t, backend="pallas")
  brute = np.stack([
      [np.argmin(((p - codebook) ** 2).sum(-1)) for p in row]
      for row in patches[:, :8]])
  ok = np.array_equal(ids_xla.cpu().numpy()[:, :8], brute) and \
      np.array_equal(ids_xla.cpu().numpy(), ids_pl.cpu().numpy())
  print(f"VQ tokenize: 2×{args.patches} patches → codebook ids; "
        f"xla==pallas==brute: {ok}")
  checks.append(bool(ok))

  text = torch.from_numpy(rng.integers(0, 32000, (2, 64)).astype(
      np.int32)).to(dev)
  fused = fuse_streams(text, ids_xla, image_token_offset=32768)
  print(f"early fusion: image({ids_xla.shape[1]}) + text({text.shape[1]}) "
        f"→ stream {tuple(fused.shape)}")

  # --- 2. embedding retrieval ------------------------------------------------
  table = rng.standard_normal((args.table, 128)).astype(np.float32)
  queries = rng.standard_normal((32, 128)).astype(np.float32)
  d, i = knn(table, queries, k=8, device=dev)
  d_ref, i_ref = knn_np(table, queries, 8)
  ok = bool(np.array_equal(i.cpu().numpy(), i_ref))
  print(f"kNN retrieval ({args.table // 1000}k×128): idx match {ok}")
  checks.append(ok)
  print(f"[checks] {sum(checks)} of {len(checks)} passed")
  return 0 if all(checks) else 1


if __name__ == "__main__":
  sys.exit(main())

"""The one general generator: every request the benchmark sends, made from
``--seed`` and the data files.

A configuration's ``request`` block fixes the problem (ring, dtype and
sizes); each stream of a traffic mix may override a size, or give it as an
inclusive range ``[low, high]`` that its requests draw uniformly.

  * A closed-loop stream draws a pool of ``pool`` distinct problems once, at
    set-up, and each client cycles through it in its own seeded order: a
    4096-vertex graph is 64 MiB, too dear to draw per request.  The pool
    repeats content, so a result cache keyed on content would be credited
    wrongly; the program has none.
  * An open-loop stream is made whole before the window: ``rate_per_s``
    times the window's length requests with Poisson gaps.  The set of gaps
    and of drawn sizes is the same for every seed (drawn from the stream's
    position alone) and only its order comes from the seed, so seeds change
    the content and order of the work, not its amount.

Graphs follow ``apps/graphs.weighted_digraph`` (weights uniform in
[low, high], the ring's missing-edge sentinel where a uniform draw is at or
above ``density``, the ring's self value on the diagonal) and KNN points
``launch/serve_mmo.synthesize_request`` (standard normal); both are drawn
on the device in a few large calls, then copied to the host as the
requests' numpy operands.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from bench.reference.closure import ring

GRAPH_DTYPES = {"float32": torch.float32, "bool": torch.bool}


@dataclasses.dataclass
class Payload:
  """One problem: the host operands of one request and what its answer is
  checked and counted by."""
  kind: str          # 'closure' or 'knn'
  op: str
  dtype: str
  arrays: dict       # numpy operands
  params: dict       # closure: algorithm; knn: k
  size: tuple        # closure: (n,); knn: (queries, corpus, dim)


def seed_sequence(seed: int, *key: int) -> np.random.SeedSequence:
  """The stream of ``key`` under ``seed`` (any whole number; a negative one
  is taken modulo 2**64)."""
  return np.random.SeedSequence(entropy=int(seed) % (1 << 64),
                                spawn_key=tuple(key))


def torch_seed(ss: np.random.SeedSequence) -> int:
  return int(ss.generate_state(1, np.uint64)[0])


def stream_request(config: dict, stream: dict) -> dict:
  """The config's request block with the stream's overrides applied (one
  level of nesting: ``graph`` merges key by key)."""
  req = copy.deepcopy(config["request"])
  for key, value in stream.get("request", {}).items():
    if isinstance(value, dict):
      req.setdefault(key, {}).update(value)
    else:
      req[key] = value
  return req


def _draw(value, rng: np.random.Generator, count: int, integer: bool):
  """``count`` draws of a fixed value or of an inclusive [low, high]."""
  if isinstance(value, (list, tuple)):
    lo, hi = value
    if integer:
      return rng.integers(int(lo), int(hi) + 1, count)
    return rng.uniform(float(lo), float(hi), count)
  return np.full(count, value)


def _graphs(req: dict, sizes, densities, gen: torch.Generator,
            device) -> list:
  """Prepared adjacencies, one per (size, density), from two large draws."""
  op, dtype = req["op"], req["dtype"]
  _, _, _, missing, self_value = ring(op)
  count, n_max = len(sizes), int(max(sizes))
  keep = torch.rand((count, n_max, n_max), generator=gen, device=device)
  if dtype == "bool":
    weights = None
  else:
    g = req["graph"]
    weights = torch.rand((count, n_max, n_max), generator=gen, device=device)
    weights = weights.mul_(float(g["high"]) - float(g["low"])).add_(
        float(g["low"])).to(GRAPH_DTYPES[dtype])
  out = []
  for i, (n, density) in enumerate(zip(sizes, densities)):
    n = int(n)
    edge = keep[i, :n, :n] < float(density)
    if weights is None:
      adj = edge.clone()
    else:
      adj = torch.where(edge, weights[i, :n, :n],
                        torch.tensor(missing, dtype=weights.dtype,
                                     device=device))
    adj.fill_diagonal_(self_value)
    out.append(adj.cpu().numpy())
  return out


def draw_sizes(req: dict, count: int, rng: np.random.Generator) -> list:
  """Per problem, the sizes a request block gives as ranges: closure
  (n, density) pairs; a KNN block's sizes are fixed."""
  if req["kind"] != "closure":
    return [None] * count
  sizes = _draw(req["n"], rng, count, integer=True)
  densities = _draw(req.get("graph", {}).get("density", 0.0), rng, count,
                    integer=False)
  return list(zip(sizes, densities))


def make_payloads(req: dict, sizes: list, gen: torch.Generator,
                  device) -> list:
  """One problem of the request block ``req`` per entry of ``sizes``
  (``draw_sizes``), its contents drawn from ``gen`` on ``device``."""
  kind, count = req["kind"], len(sizes)
  if kind == "closure":
    if req["dtype"] not in GRAPH_DTYPES:
      raise ValueError(f"closure graphs are drawn in {sorted(GRAPH_DTYPES)}")
    adjs = _graphs(req, [n for n, _ in sizes], [d for _, d in sizes], gen,
                   device)
    return [Payload(kind, req["op"], req["dtype"], {"adj": a},
                    {"algorithm": req["algorithm"]}, (int(a.shape[0]),))
            for a in adjs]
  if kind == "knn":
    if req["dtype"] != "float32":
      raise ValueError("KNN points are drawn in float32")
    q, r, d = int(req["queries"]), int(req["corpus"]), int(req["dim"])
    qry = torch.randn((count, q, d), generator=gen, device=device).cpu()
    ref = torch.randn((count, r, d), generator=gen, device=device).cpu()
    return [Payload(kind, "addnorm", "float32",
                    {"queries": qry[i].numpy(), "corpus": ref[i].numpy()},
                    {"k": int(req["k"])}, (q, r, d))
            for i in range(count)]
  raise ValueError(f"unknown request kind {kind!r}")


@dataclasses.dataclass
class OpenSchedule:
  """An open-loop stream made whole before the window: each request's due
  time (seconds after the window opens) and its problem."""
  due_s: np.ndarray
  payloads: list


def open_schedule(config: dict, stream: dict, index: int, seed: int,
                  seconds: float, device) -> OpenSchedule:
  rate = float(stream["rate_per_s"])
  count = max(1, int(round(rate * seconds)))
  fixed = np.random.default_rng(seed_sequence(0, index))
  gaps = fixed.exponential(1.0 / rate, count)
  # the whole set of gaps spans count/(count+1) of the window, whatever
  # the seed: the last request is due inside it
  gaps *= seconds * count / (count + 1) / gaps.sum()
  req = stream_request(config, stream)
  # the drawn sizes are fixed per stream position; the seed permutes them
  fixed_sizes = draw_sizes(req, count,
                           np.random.default_rng(seed_sequence(0, index, 1)))
  order = np.random.default_rng(seed_sequence(seed, index, 0)).permutation(
      count)
  gen = torch.Generator(device=device)
  gen.manual_seed(torch_seed(seed_sequence(seed, index, 1)))
  payloads = make_payloads(req, [fixed_sizes[i] for i in order], gen, device)
  gap_order = np.random.default_rng(
      seed_sequence(seed, index, 3)).permutation(count)
  return OpenSchedule(due_s=np.cumsum(gaps[gap_order]), payloads=payloads)


def closed_pool(config: dict, stream: dict, index: int, seed: int,
                device) -> list:
  req = stream_request(config, stream)
  gen = torch.Generator(device=device)
  gen.manual_seed(torch_seed(seed_sequence(seed, index, 1)))
  sizes = draw_sizes(req, int(stream["pool"]),
                     np.random.default_rng(seed_sequence(seed, index, 4)))
  return make_payloads(req, sizes, gen, device)


def client_rng(seed: int, index: int, client: int,
               purpose: int = 0) -> np.random.Generator:
  """Client ``client`` of stream ``index``: its order through the pool
  (purpose 0) and which of its answers are kept for the check (1)."""
  return np.random.default_rng(seed_sequence(seed, index, 2, client,
                                             purpose))


def pool_order(rng: np.random.Generator, pool: int):
  """A client's endless sequence of pool indices: seeded permutations of
  the pool, one after another, so every problem recurs evenly."""
  while True:
    yield from (int(i) for i in rng.permutation(pool))

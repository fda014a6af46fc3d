"""The client layer: closed-loop clients and open-loop senders that drive
``MMOEngine.submit`` -> ``MMOFuture.result`` from their own threads, and
time every request from the client's side on ``time.perf_counter`` (the
engine's clock too)."""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np

from bench.lib import inputs

# how long past the window's close a request may take before it counts as
# never answered
GRACE_S = 60.0


@dataclasses.dataclass
class Obs:
  """One request as the client saw it."""
  stream: str
  loop: str              # 'closed' or 'open'
  payload: inputs.Payload
  due_s: float           # when it was due to be sent (closed loop: sent_s)
  sent_s: float
  done_s: float = float("nan")
  state: str = "pending"  # done / failed / expired / rejected / pending
  error: str = ""
  request_id: int = -1
  deadline_s: Optional[float] = None
  keep: bool = False     # its answer is kept for the check
  value: Optional[np.ndarray] = None
  extras: dict = dataclasses.field(default_factory=dict)


def make_request(api, payload: inputs.Payload, stream: dict):
  qos = {"tenant": stream.get("tenant", stream["name"]),
         "priority": int(stream.get("priority", 0)),
         "deadline_s": stream.get("deadline_s")}
  if payload.kind == "closure":
    return api.closure_request(payload.arrays["adj"], op=payload.op,
                               algorithm=payload.params["algorithm"],
                               prepared=True, **qos)
  if payload.kind == "knn":
    return api.knn_request(payload.arrays["queries"],
                           payload.arrays["corpus"], k=payload.params["k"],
                           **qos)
  raise ValueError(f"unknown kind {payload.kind!r}")


def _finish(obs: Obs, fut, timeout: float) -> None:
  """Wait for ``fut``; stamp the client-side completion and keep the answer
  if the check samples it (copied, so the batch's array can be freed)."""
  try:
    res = fut.result(timeout=timeout)
  except Exception as e:  # noqa: BLE001 — any failure is the request's outcome
    # 'pending' when the wait timed out: the answer never came
    obs.done_s, obs.state = time.perf_counter(), fut.state
    obs.error = f"{type(e).__name__}: {e}"
    return
  obs.done_s = time.perf_counter()
  obs.state = "done"
  if obs.keep:
    obs.value = np.array(res.value)
    obs.extras = {k: np.array(v) for k, v in res.extras.items()}
  else:
    obs.extras = {k: v for k, v in res.extras.items()
                  if not isinstance(v, np.ndarray)}


class Load:
  """Every stream of one traffic mix against one engine."""

  def __init__(self, engine, api, streams: list, pools: dict,
               schedules: dict, seed: int, window_s: float):
    self.engine, self.api = engine, api
    self.streams, self.pools, self.schedules = streams, pools, schedules
    self.seed, self.window_s = seed, window_s
    self.obs: list = []
    self._lock = threading.Lock()
    self._stop = threading.Event()
    self._threads: list = []
    self.t0 = self.t1 = float("nan")
    self.max_late_s = 0.0

  def _record(self, obs: Obs) -> None:
    with self._lock:
      self.obs.append(obs)

  def _closed_client(self, index: int, stream: dict, client: int) -> None:
    pool = self.pools[stream["name"]]
    rng = inputs.client_rng(self.seed, index, client)
    share = float(stream.get("check_share", 1.0))
    keep_rng = inputs.client_rng(self.seed, index, client, 1)
    for i in inputs.pool_order(rng, len(pool)):
      keep = bool(keep_rng.random() < share)
      if self._stop.is_set():
        return
      payload = pool[i]
      req = make_request(self.api, payload, stream)
      t = time.perf_counter()
      obs = Obs(stream["name"], "closed", payload, t, t,
                deadline_s=stream.get("deadline_s"), keep=keep)
      fut = self.engine.submit(req)
      obs.request_id = req.request_id
      self._record(obs)
      _finish(obs, fut, self.window_s + GRACE_S)

  def _open_sender(self, stream: dict) -> None:
    sched = self.schedules[stream["name"]]
    share = float(stream.get("check_share", 1.0))
    waiters = []
    for due_off, payload in zip(sched.due_s, sched.payloads):
      due = self.t0 + float(due_off)
      delay = due - time.perf_counter()
      if delay > 0:
        self._stop.wait(delay)
      if self._stop.is_set():
        break
      req = make_request(self.api, payload, stream)
      t = time.perf_counter()
      self.max_late_s = max(self.max_late_s, t - due)
      obs = Obs(stream["name"], "open", payload, due, t,
                deadline_s=stream.get("deadline_s"), keep=share >= 1.0)
      fut = self.engine.submit(req)
      obs.request_id = req.request_id
      self._record(obs)
      w = threading.Thread(target=_finish,
                           args=(obs, fut, self.window_s + GRACE_S),
                           daemon=True)
      w.start()
      waiters.append(w)
    for w in waiters:
      w.join(self.window_s + GRACE_S + 5.0)

  def start(self) -> float:
    """Open the window: every client and sender starts now."""
    self.t0 = time.perf_counter()
    self.t1 = self.t0 + self.window_s
    for index, stream in enumerate(self.streams):
      if stream["loop"] == "closed":
        for c in range(int(stream["clients"])):
          self._threads.append(threading.Thread(
              target=self._closed_client, args=(index, stream, c),
              name=f"client-{stream['name']}-{c}", daemon=True))
      elif stream["loop"] == "open":
        self._threads.append(threading.Thread(
            target=self._open_sender, args=(stream,),
            name=f"sender-{stream['name']}", daemon=True))
      else:
        raise ValueError(f"unknown loop {stream['loop']!r}")
    for t in self._threads:
      t.start()
    return self.t0

  def close(self) -> None:
    """Stop sending at the window's close."""
    self._stop.set()

  def join(self) -> bool:
    """Wait for every request sent to end (at most ``GRACE_S`` past the
    close); True when every thread ended."""
    deadline = self.t1 + GRACE_S + 10.0
    for t in self._threads:
      t.join(max(0.0, deadline - time.perf_counter()))
    return not any(t.is_alive() for t in self._threads)

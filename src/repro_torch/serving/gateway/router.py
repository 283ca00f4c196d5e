"""Predictor-informed dispatch across real engine replicas.

Reuses the cluster-level placement policy from ``core/cluster.py``
(``pick_replica``): ``ewt`` places each request on the replica with the
minimum predicted completion time (speculative shortest-queue routing,
cluster-level Eq. 6-7); ``join_shortest_queue`` and ``round_robin`` are
the standard baselines.  ``prefix_ewt`` adds shared-prefix **affinity**:
route to the replica whose prefix-cache index already holds the longest
prefix of the prompt (its prefill shrinks to the uncached suffix),
tie-broken by EWT — with no hit anywhere it degrades to plain ``ewt``.

Drain: removing an engine releases its in-flight requests (KV freed on the
old replica) and re-routes them across the survivors.  The engine's
re-entrant ``submit()`` resumes each request from its existing
``output_tokens`` via the recompute path, so already-streamed tokens are
neither lost nor re-emitted — the client stream just keeps going.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.cluster import pick_replica
from repro_torch.core.engine import ServingEngine
from repro_torch.core.request import Request


@dataclass
class EngineDriver:
    """One engine replica as seen by the gateway."""
    engine: ServingEngine
    name: str = ""
    alive: bool = True
    device: str = ""      # placement label ("cpu:1") for attribution

    def queue_depth(self) -> int:
        return self.engine.queue_depth()

    def predicted_backlog(self, quantile: Optional[float] = None) -> float:
        return self.engine.predicted_backlog(quantile)


class GatewayRouter:
    def __init__(self, engines: List[ServingEngine], policy: str = "ewt"):
        self.policy = policy
        self.drivers: List[EngineDriver] = [
            EngineDriver(engine=e, name=f"engine{i}",
                         device=getattr(e, "device", ""))
            for i, e in enumerate(engines)]
        for d in self.drivers:
            d.engine.stream_events = True
        self.owner: Dict[int, EngineDriver] = {}   # req_id -> driver
        self._rr = 0
        self.bus = None       # observability EventBus (set by the gateway)
        # set by the gateway while the concurrent pump runs: dispatch goes
        # through the engine's submit mailbox instead of blocking on its
        # step lock behind an in-flight iteration
        self.nowait = False

    # ------------------------------------------------------------ topology
    def alive_drivers(self) -> List[EngineDriver]:
        return [d for d in self.drivers if d.alive]

    def add_engine(self, engine: ServingEngine) -> EngineDriver:
        engine.stream_events = True
        d = EngineDriver(engine=engine, name=f"engine{len(self.drivers)}",
                         device=getattr(engine, "device", ""))
        self.drivers.append(d)
        return d

    def remove_engine(self, idx: int, now: float = 0.0) -> List[Request]:
        """Drain-and-requeue: release every in-flight request from the
        removed engine and redistribute across the survivors."""
        d = self.drivers[idx]
        if not any(o.alive for o in self.drivers if o is not d):
            raise ValueError("cannot remove the last alive engine")
        d.alive = False
        moved = d.engine.drain()
        for r in moved:
            self.owner.pop(r.req_id, None)
            self.dispatch(r, now)
        return moved

    # ------------------------------------------------------------- routing
    def _pick(self, req: Optional[Request]) -> EngineDriver:
        """Resolve the configured policy to a driver (no side effects)."""
        alive = self.alive_drivers()
        if self.policy == "prefix_ewt" and req is not None:
            if any(d.engine.tier is not None for d in alive):
                # tier-aware affinity: with a shared cluster tier every
                # replica can *import* the prefix at upload-DMA cost, so
                # raw hit-length affinity over-rewards the original
                # replica.  Price the actual expected TTFT instead —
                # prefill_estimate already folds in local hits and tier
                # imports (DMA, not prefill compute) per replica.
                return min(alive,
                           key=lambda d: (d.predicted_backlog()
                                          + d.engine.prefill_estimate(
                                              req.prompt_len,
                                              req.prompt_tokens)))
            # prefix affinity: longest cached-prefix hit wins; predicted
            # backlog (EWT) breaks ties and decides when nobody has a hit
            return min(alive,
                       key=lambda d: (-d.engine.prefix_probe(
                                          req.prompt_tokens),
                                      d.predicted_backlog()))
        return pick_replica(self.policy if self.policy != "prefix_ewt"
                            else "ewt", alive, rr_counter=self._rr,
                            queue_len=lambda d: d.queue_depth(),
                            backlog=lambda d: d.predicted_backlog())

    def dispatch(self, req: Request, now: float) -> EngineDriver:
        d = self._pick(req)
        if self.policy == "round_robin":
            self._rr += 1
        if self.nowait:
            d.engine.submit_nowait(req, now)
        else:
            d.engine.submit(req, now)
        self.owner[req.req_id] = d
        if self.bus is not None:
            self.bus.emit("dispatch", t=now, req_id=req.req_id,
                          replica=d.name, policy=self.policy)
        return d

    # --------------------------------------------------------------- state
    def total_depth(self) -> int:
        return sum(d.queue_depth() for d in self.alive_drivers())

    def total_backlog(self) -> float:
        return sum(d.predicted_backlog() for d in self.alive_drivers())

    def peek_driver(self, req: Optional[Request] = None
                    ) -> Optional[EngineDriver]:
        """The replica the *configured policy* would dispatch the next
        request to, without committing (rr counter untouched).  Its
        predicted backlog is the queueing-delay term of the gateway's
        expected-TTFT estimate — gating on the replica actually about to
        receive the request, whatever the policy (None with no live
        replicas).  ``req`` lets prefix-affinity peek at the same replica
        dispatch would pick."""
        if not self.alive_drivers():
            return None
        return self._pick(req)

"""Cluster-scale ALISE (beyond-paper): speculative routing across replicas,
fault tolerance, and elastic scaling.

The paper evaluates a single GPU.  At pod scale each model replica runs its
own ALISE scheduler; a front-end router reuses the *same* length predictor to
place each request on the replica with the minimum predicted completion time
(cluster-level EWT), which is speculative shortest-queue routing.

Fault tolerance: every accepted request is journaled; replicas heartbeat; on
a replica failure its in-flight requests are re-enqueued (deterministic
replay — prompt + sampling seed fully determine the output, so a replayed
request returns identical tokens).  Elastic scaling adds/removes replicas;
draining moves queued work back to the router.

This module is simulation-backed (the same iteration-level model as
``simulator.py``); the per-replica scheduler/memory objects are the real ones.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.predictor import LengthPredictor
from repro_torch.core.request import KVLocation, Request, RequestState
from repro_torch.core.simulator import ServingSimulator, SimConfig
from repro_torch.core.trace import SyntheticTrace, TraceConfig


@dataclass
class ClusterConfig:
    n_replicas: int = 4
    model: str = "opt-13b"
    strategy: str = "alise"
    router: str = "ewt"               # ewt | round_robin | join_shortest_queue
    hbm_bytes: float = 8e9
    max_batch: int = 64
    heartbeat_interval: float = 1.0
    fail_at: Optional[float] = None   # inject a replica failure at this time
    fail_replica: int = 0
    recover_at: Optional[float] = None
    kv_tier: bool = False             # cluster-wide shared KV tier: one
                                      # SimKVTier every replica publishes
                                      # to and imports from (prefix pages
                                      # move at DMA cost, not re-prefill)
    tier_bytes: float = 1e9           # tier payload capacity
    prefix_cache: bool = False        # per-replica prefix cache (modeled)
    seed: int = 0


def pick_replica(policy: str, candidates: list, rr_counter: int = 0,
                 queue_len=None, backlog=None):
    """Front-end placement policy shared by the simulated ClusterRouter and
    the online serving gateway (``serving/gateway/router.py``).

    ``ewt`` is speculative shortest-queue routing: place on the replica with
    the minimum predicted completion time (cluster-level Eq. 6-7).
    """
    assert candidates, "no live replicas"
    if policy == "round_robin":
        return candidates[rr_counter % len(candidates)]
    if policy == "join_shortest_queue":
        return min(candidates, key=queue_len)
    return min(candidates, key=backlog)   # "ewt"


class Replica:
    """One model replica = one ServingSimulator advanced in lockstep."""

    def __init__(self, rid: int, cfg: ClusterConfig,
                 predictor: LengthPredictor, tier=None):
        self.rid = rid
        self.alive = True
        trace = SyntheticTrace(requests=[], cfg=TraceConfig(rate=1))
        sim_cfg = SimConfig(model=cfg.model, strategy=cfg.strategy,
                            hbm_bytes=cfg.hbm_bytes, max_batch=cfg.max_batch,
                            prefix_cache=cfg.prefix_cache,
                            seed=cfg.seed + rid)
        self.sim = ServingSimulator(sim_cfg, trace, predictor=predictor,
                                    replica=f"sim{rid}", tier=tier)
        self.clock = 0.0

    def enqueue(self, req: Request, now: float) -> None:
        if not self.sim.sched.live:
            # idle replica: its clock has no meaning before work exists
            self.clock = max(self.clock, now)
        self.sim.sched.submit(req, now)

    def predicted_backlog(self) -> float:
        """Sum of predicted remaining times of everything on this replica."""
        return self.sim.sched.predicted_backlog()

    def queue_len(self) -> int:
        return len(self.sim.sched.live)

    def advance_to(self, t: float) -> List[Request]:
        """Run iterations until the replica clock reaches t; returns
        finishes.  Each iteration plans and executes the same
        ``IterationPlan`` contract as the single-node simulator / the real
        engine (``ServingSimulator.execute_plan`` / ``account_tokens``)."""
        finished_before = len(self.sim.sched.finished)
        sched, sim = self.sim.sched, self.sim
        while self.clock < t and sched.live:
            plan = sched.plan(self.clock)
            t_iter, ran = sim.execute_plan(plan, self.clock)
            if not ran:
                nxt = [x for x in sched._swap_ready_at.values() if x > self.clock]
                self.clock = min(nxt) if nxt else t
                continue
            self.clock += t_iter
            sim.account_tokens(plan, self.clock)
            # apply queued predictor feedback between iterations (same
            # off-dispatch-path placement as engine.step / simulator.run)
            sim.predictor.drain_feedback()
        self.clock = max(self.clock, t)
        return self.sim.sched.finished[finished_before:]

    def fail(self) -> List[Request]:
        """Crash: lose all device state; return in-flight work for replay."""
        self.alive = False
        sched = self.sim.sched
        inflight = list(sched.live.values())
        for r in inflight:
            self.sim.mem.free(r)
            r.state = RequestState.QUEUED
            r.kv_location = KVLocation.NONE
            r.generated = 0            # deterministic replay from scratch
            r.output_tokens.clear()
        sched.live.clear()
        return inflight


@dataclass
class ClusterResult:
    completed: int
    total: int
    duration: float
    normalized_latency: float
    mean_latency: float
    p99_latency: float
    throughput: float
    replica_load: List[int]
    replayed: int


class ClusterRouter:
    """Front-end: speculative routing + journal + failure handling."""

    def __init__(self, cfg: ClusterConfig, predictor: LengthPredictor):
        self.cfg = cfg
        self.predictor = predictor
        # the shared host-RAM KV tier is a *cluster* asset: one instance,
        # every replica publishes/imports (it survives replica failures —
        # host RAM outlives a crashed device process)
        self.tier = None
        if cfg.kv_tier:
            from repro_torch.configs import get_config
            from repro_torch.core.quantization import kv_bytes_per_token
            from repro_torch.serving.kv_tier import SimKVTier
            arch = get_config(cfg.model)
            bpt = kv_bytes_per_token(arch.num_layers, arch.num_kv_heads,
                                     arch.hd)
            pg = SimConfig().prefix_page_size
            self.tier = SimKVTier(pg, max(1, int(cfg.tier_bytes // (pg * bpt))),
                                  SimConfig().swap_bw)
        self.replicas = [Replica(i, cfg, predictor, tier=self.tier)
                         for i in range(cfg.n_replicas)]
        self.journal: Dict[int, Request] = {}
        self._rr = 0
        self.replayed = 0

    # -------------------------------------------------------------- routing
    def route(self, req: Request, now: float) -> Replica:
        alive = [r for r in self.replicas if r.alive]
        rep = pick_replica(self.cfg.router, alive, rr_counter=self._rr,
                           queue_len=lambda r: r.queue_len(),
                           backlog=lambda r: r.predicted_backlog())
        if self.cfg.router == "round_robin":
            self._rr += 1
        self.journal[req.req_id] = req
        rep.enqueue(req, now)
        return rep

    # ------------------------------------------------------------- elastic
    def scale_up(self, n: int = 1) -> None:
        base = len(self.replicas)
        for i in range(n):
            self.replicas.append(Replica(base + i, self.cfg, self.predictor,
                                         tier=self.tier))

    def scale_down(self, rid: int, now: float) -> None:
        """Drain a replica: re-route queued work, let running work finish."""
        rep = self.replicas[rid]
        sched = rep.sim.sched
        queued = [r for r in sched.live.values()
                  if r.state == RequestState.QUEUED]
        for r in queued:
            sched.live.pop(r.req_id)
            self.route(r, now)
        rep.alive = False   # no new work; advance_to drains the rest

    # ----------------------------------------------------------------- run
    def run(self, trace: SyntheticTrace, tick: float = 0.5) -> ClusterResult:
        cfg = self.cfg
        from repro_torch.core.request import reset_runtime_state
        for r in trace.requests:
            reset_runtime_state(r)
        arrivals = sorted(trace.requests, key=lambda r: r.arrival_time)
        i = 0
        now = 0.0
        end = trace.duration + 600.0
        finished: List[Request] = []
        failed_done = recovered_done = False

        while (i < len(arrivals) or any(r.sim.sched.live for r in self.replicas)) \
                and now < end:
            now += tick
            # failure injection
            if (cfg.fail_at is not None and not failed_done and now >= cfg.fail_at):
                lost = self.replicas[cfg.fail_replica].fail()
                self.replayed += len(lost)
                for r in lost:
                    self.route(r, now)       # replay on surviving replicas
                failed_done = True
            if (cfg.recover_at is not None and not recovered_done
                    and now >= cfg.recover_at):
                self.replicas[cfg.fail_replica] = Replica(
                    cfg.fail_replica, cfg, self.predictor)
                recovered_done = True
            while i < len(arrivals) and arrivals[i].arrival_time <= now:
                self.route(arrivals[i], arrivals[i].arrival_time)
                i += 1
            for rep in self.replicas:
                if rep.alive or rep.sim.sched.live:
                    finished.extend(rep.advance_to(now))

        lat = np.array([r.e2e_latency for r in finished]) if finished else np.array([0.0])
        norm = np.array([r.normalized_latency for r in finished
                         if r.normalized_latency]) if finished else np.array([0.0])
        if norm.size == 0:
            norm = np.array([0.0])
        return ClusterResult(
            completed=len(finished), total=len(arrivals), duration=now,
            normalized_latency=float(norm.mean()),
            mean_latency=float(lat.mean()),
            p99_latency=float(np.percentile(lat, 99)),
            throughput=len(finished) / max(now, 1e-9),
            replica_load=[len(r.sim.sched.finished) for r in self.replicas],
            replayed=self.replayed)

"""Online gateway demo on the PyTorch port: stream tokens from a live
request while a Poisson trace of batch traffic replays in the background.

    PYTHONPATH=src python examples/gateway_streaming_torch.py              # card
    PYTHONPATH=src python examples/gateway_streaming_torch.py --device cpu

1. builds two engine replicas over the same small model (random weights
   from ``--seed``; granite-3-8b's smoke config);
2. replays a Poisson alpaca trace (batch class) through SLO-aware admission
   and EWT routing, on a virtual clock;
3. concurrently submits one interactive request and prints its tokens as
   they stream: interactive traffic enters the scheduler's top MLFQ band,
   so it jumps the batch queue;
4. prints per-class TTFT/TPOT/E2E percentiles.
"""
import argparse
import asyncio
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.core.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.core.predictor import OraclePredictor  # noqa: E402
from repro_torch.core.request import Request, SLOClass  # noqa: E402
from repro_torch.core.trace import (TraceConfig, clamp_requests,  # noqa: E402
                                    generate_trace)
from repro_torch.launch.serve import build_model  # noqa: E402
from repro_torch.serving.gateway import (AdmissionConfig, Gateway,  # noqa: E402
                                         GatewayConfig)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' on request)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    model, params = build_model("granite-3-8b", "smoke", args.device,
                                seed=args.seed)
    cfg = model.cfg

    def mk_engine():
        return ServingEngine(model, params, EngineConfig(
            max_slots=2, max_seq_len=64, max_new_tokens=24,
            strategy="alise", quantize_offload=False),
            predictor=OraclePredictor())

    trace = generate_trace(TraceConfig(dataset="alpaca", rate=8.0,
                                       duration=1e9, max_requests=16,
                                       seed=0))
    batch_reqs = clamp_requests(trace.requests, vocab=cfg.vocab_size,
                                max_prompt=12, max_new=16)

    gw = Gateway([mk_engine(), mk_engine()],
                 GatewayConfig(virtual_dt=0.05, router_policy="ewt"),
                 admission=AdmissionConfig(max_queue_depth=24,
                                           defer_high_watermark=10))

    rng = np.random.default_rng(1)
    vip = Request(prompt_len=8, arrival_time=0.3, true_out_len=8,
                  prompt_tokens=rng.integers(2, cfg.vocab_size, 8).tolist(),
                  slo_class=SLOClass.INTERACTIVE)
    seen = []

    async def run():
        replay = asyncio.ensure_future(gw.replay(batch_reqs))
        while gw.now() < 0.3:              # wait for the queue to build
            await asyncio.sleep(0.01)
        stream = gw.submit(vip)
        print(f"[vip] submitted at t={gw.now():.2f}s "
              f"(live depth {gw.router.total_depth()})")
        async for ev in stream:
            seen.append(ev)
            if ev.kind == "token":
                print(f"[vip] t={ev.t:.2f}s token[{ev.index}] = {ev.token}")
            else:
                print(f"[vip] t={ev.t:.2f}s {ev.kind} ({ev.reason})")
        return await replay

    streams = asyncio.run(run())
    print()
    print(gw.metrics.format())
    return gw, vip, seen, streams


if __name__ == "__main__":
    main()

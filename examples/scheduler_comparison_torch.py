"""Scheduler shootout on the PyTorch port: ORCA-FCFS vs vLLM-FCFS vs ALISE.

    PYTHONPATH=src python examples/scheduler_comparison_torch.py              # card
    PYTHONPATH=src python examples/scheduler_comparison_torch.py --device cpu

Uses a heterogeneous burst (2 long jobs arrive first, 6 short jobs right
behind them) on a 2-slot engine, the paper's HoL-blocking scenario (Fig. 2)
in miniature: ALISE preempts the long jobs and finishes the shorts first;
the FCFS baselines make the shorts wait.  The burst, the engine and the
virtual clock are ``examples/scheduler_comparison.py``'s; the model is
granite-3-8b's smoke config with random weights from ``--seed``.  On the
card its heads are 64 wide (the reference's 8 are narrower than the flash
and paged kernels take) and chunks run through the flash kernel; the
latencies are virtual-clock seconds, so they move with the tokens only
where a request meets its EOS token.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.core.predictor import OraclePredictor  # noqa: E402
from repro_torch.core.quantization import kv_bytes_per_token  # noqa: E402
from repro_torch.core.request import Request, reset_request_counter  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.utils import resolve_device  # noqa: E402

STRATEGIES = ("orca", "vllm", "alise")


def burst(cfg, seed=0):
    rng = np.random.default_rng(seed)
    reset_request_counter()
    reqs = []
    for out in (40, 40, 3, 3, 3, 3, 3, 3):
        plen = int(rng.integers(6, 12))
        reqs.append(Request(prompt_len=plen, arrival_time=0.0,
                            true_out_len=out,
                            prompt_tokens=rng.integers(
                                2, cfg.vocab_size, plen).tolist()))
    return reqs


def compare(model, params):
    """Each strategy's row over the burst: (strategy, mean latency,
    short-job latency, long-job latency, preemptions), latencies in
    virtual-clock seconds; prints the table as it goes."""
    cfg = model.cfg
    bpt = kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads, cfg.hd)
    print(f"{'system':10s} {'mean lat':>9s} {'short-job lat':>14s} "
          f"{'long-job lat':>13s} {'preempts':>9s}")
    rows = []
    for strategy in STRATEGIES:
        reqs = burst(cfg)
        eng = ServingEngine(model, params, EngineConfig(
            max_slots=2, max_seq_len=64, max_new_tokens=48,
            strategy=strategy, quantize_offload=True,
            hbm_bytes=2 * 55 * bpt), predictor=OraclePredictor())
        # stagger: longs first, then shorts (HoL setup)
        t = 0.0
        for r in reqs[:2]:
            eng.submit(r, t)
        for _ in range(4):
            eng.step(t)
            t += 0.05
        for r in reqs[2:]:
            eng.submit(r, t)
        for _ in range(1000):
            if not eng.sched.live:
                break
            eng.step(t)
            t += 0.05
        lat = np.array([r.e2e_latency for r in reqs])
        shorts = np.array([r.e2e_latency for r in reqs if r.true_out_len <= 3])
        longs = np.array([r.e2e_latency for r in reqs if r.true_out_len > 3])
        pre = sum(r.preempt_count for r in reqs)
        print(f"{strategy:10s} {lat.mean():8.2f}s {shorts.mean():13.2f}s "
              f"{longs.mean():12.2f}s {pre:9d}")
        rows.append((strategy, lat.mean(), shorts.mean(), longs.mean(), pre))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' on request)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_smoke_config("granite-3-8b")
    cuda = dev.type == "cuda"
    if cuda:
        cfg = cfg.scaled(head_dim=64)
    model = Model(cfg, attn_chunk=32, device=dev,
                  chunk_attn_impl="flash" if cuda else "masked")
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    print(f"[{dev}] {cfg.name} smoke ({cfg.num_layers}L d{cfg.d_model} "
          f"{cfg.num_heads}/{cfg.num_kv_heads}H hd{cfg.hd} "
          f"{cfg.param_dtype})")
    rows = compare(model, params)
    print("\nALISE should cut the short-job latency sharply (HoL fix) at a "
          "small cost to the long jobs.")
    return rows


if __name__ == "__main__":
    main()

"""Quickstart on the PyTorch port: train a tiny LM, then serve it end-to-end
with ALISE.

    PYTHONPATH=src python examples/quickstart_torch.py              # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

1. trains a reduced granite-3-8b config on the synthetic bigram stream
   (loss drops: the model learns);
2. serves a batch of heterogeneous requests through the full ALISE stack
   (retrieval predictor -> SRTF scheduler -> preemptive engine with INT8
   KV swapping) and prints per-request latencies;
3. fits the paper's Eq. 3-5 latency model from real measured step times.

The steps, batch, requests and seeds are ``examples/quickstart.py``'s.
On the card the heads are 64 wide (the smoke config's 8 are narrower than
the flash and paged kernels take), the training step's attention and
RMSNorm forwards and the serve's chunks run through the CUDA kernels.
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.core.predictor import RetrievalPredictor  # noqa: E402
from repro_torch.core.request import Request  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.utils import resolve_device  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' on request)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    head_dim = 64 if cuda else None

    print(f"=== 1) train a ~1M-param model for 60 steps ({dev}) ===")
    state, losses, _ = train("granite-3-8b", smoke=True, steps=60,
                             batch_size=8, seq_len=64, log_every=20,
                             head_dim=head_dim, device=dev)
    print(f"loss: {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({'LEARNING' if losses[-1] < losses[0] - 0.1 else 'flat?'})")

    print("\n=== 2) serve with ALISE (speculative scheduling + KV swap) ===")
    # the trained float32 weights, served with a float32 KV cache
    cfg = get_smoke_config("granite-3-8b").scaled(param_dtype="float32",
                                                  head_dim=head_dim)
    model = Model(cfg, attn_chunk=32, kv_dtype="float32", device=dev,
                  chunk_attn_impl="flash" if cuda else "masked")
    params = state["params"]

    predictor = RetrievalPredictor(seed=0)
    eng = ServingEngine(model, params, EngineConfig(
        max_slots=4, max_seq_len=96, max_new_tokens=32, strategy="alise",
        quantize_offload=True, respect_true_len=True), predictor=predictor)

    rng = np.random.default_rng(0)
    reqs = []
    for i, out_len in enumerate([30, 4, 4, 25, 3, 6, 3, 20]):
        plen = int(rng.integers(6, 20))
        reqs.append(Request(prompt_len=plen, arrival_time=0.0,
                            true_out_len=out_len,
                            prompt_tokens=rng.integers(
                                2, cfg.vocab_size, plen).tolist()))
    eng.serve(reqs)
    for r in reqs:
        print(f"  req{r.req_id}: prompt={r.prompt_len:3d} out={r.generated:3d} "
              f"latency={r.e2e_latency:7.3f}s preempted={r.preempt_count}x")

    print("\n=== 3) fitted Eq. 3-5 latency model from real step times ===")
    lm = eng.fit_latency_model()
    print(f"T_pre(s) ~ s * {lm.t0:.2e}s ; "
          f"T_dec(s,n) ~ n * ({lm.alpha:.2e}*s + {lm.beta:.2e})")
    return losses, reqs, lm


if __name__ == "__main__":
    main()

"""Training launcher of the PyTorch port: real steps on one device, with
checkpoint/restart built in.

    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 3 \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --full --steps 5 \
        --batch-size 4 --seq-len 1024 --num-layers 8

trains every family in float32 with AdamW on the synthetic bigram
stream, as ``repro.launch.train`` does: the attention family (a dense or
an MoE FFN, the MoE's aux loss in the objective; ``--arch
granite-moe-3b-a800m``), the Mamba-2 family
(``--arch mamba2-2.7b``), the hybrid family (``--arch
jamba-1.5-large-398b``, on the CPU at the smoke size) and the
encoder-decoder family (``--arch seamless-m4t-large-v2``, whose encoder
reads one-hot frames of the tokens, as an ``embeds`` decoder such as
internvl2-2b reads its input, the reference's stand-in for a frontend);
``--full`` takes the published width, and ``--num-layers`` cuts the
depth so that params, gradients and moments fit one card.  The card is
the default device; the CPU runs only when asked (``--device cpu``).  On
the card every RMSNorm, every attention layer's and every SSD chunk's
forward run the CUDA kernels, their backwards the plain versions.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs import ASSIGNED_ARCHS, get_config, get_smoke_config
from repro_torch.models.model import Model
from repro_torch.training.checkpoint import (latest_step, restore_checkpoint,
                                             save_checkpoint)
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import init_train_state, make_train_step
from repro_torch.utils import resolve_device


def model_batch(cfg, batch):
    """The model's batch of a stream batch, as the reference's launcher
    builds it: an ``embeds`` decoder reads ``one_hot(tokens % d_model)``
    in place of its tokens, an encoder-decoder's encoder reads the same
    one-hot frames beside the decoder's tokens; float32 one-hots, cast
    by the model."""
    if not (cfg.input_mode == "embeds" or cfg.is_encoder_decoder):
        return batch
    tokens = batch["tokens"]
    emb = (tokens.long() % cfg.d_model)[..., None] == torch.arange(
        cfg.d_model, device=tokens.device)
    if cfg.is_encoder_decoder:
        return {"enc_embeds": emb.float(), "tokens": tokens,
                "targets": batch["targets"]}
    return {"embeds": emb.float(), "targets": batch["targets"]}


def train(arch: str, *, smoke: bool = True, steps: int = 50,
          batch_size: int = 8, seq_len: int = 64, ckpt_dir: str = None,
          ckpt_every: int = 25, lr: float = 3e-4, log_every: int = 10,
          grad_compression: bool = False, param_dtype: str = "float32",
          num_layers: Optional[int] = None, head_dim: Optional[int] = None,
          device=None):
    """Train ``arch`` for ``steps`` steps (resuming from ``ckpt_dir``'s
    latest checkpoint, if any).  ``num_layers`` cuts the depth and
    ``head_dim`` sets the heads' width (the card's flash kernels take 64,
    80 and 128; the smoke configs' heads are narrower).  Returns ``(state,
    losses, step_seconds)``:
    the final state, each step's loss, and each step's host seconds (the
    step ends when its loss is read back, which waits for the device)."""
    dev = resolve_device(device)
    if arch not in ASSIGNED_ARCHS:      # the paper's models are priced only
        raise KeyError(f"the port runs {list(ASSIGNED_ARCHS)}, not {arch!r}")
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    over = {"param_dtype": param_dtype}
    if num_layers is not None:
        over["num_layers"] = num_layers
    if head_dim is not None:
        over["head_dim"] = head_dim
    cfg = cfg.scaled(**over)
    # no rematerialisation, as the reference's launcher
    model = Model(cfg, attn_chunk=max(seq_len // 2, 16),
                  ssd_chunk=min(64, seq_len), remat=False, device=dev)
    step_fn = make_train_step(model, AdamWConfig(lr=lr),
                              grad_compression=grad_compression)
    data = SyntheticLM(cfg, DataConfig(batch_size=batch_size,
                                       seq_len=seq_len))

    state = init_train_state(model,
                             torch.Generator(device=dev).manual_seed(0))
    start = 0
    if ckpt_dir and latest_step(ckpt_dir) is not None:
        state, start = restore_checkpoint(ckpt_dir, state)
        print(f"[train] restored checkpoint at step {start}")

    losses, step_s = [], []
    t0 = time.perf_counter()
    it = data.iterate(start_step=start, device=dev)
    for step in range(start, steps):
        t1 = time.perf_counter()
        state, metrics = step_fn(state, model_batch(cfg, next(it)))
        loss = float(metrics["loss"])
        step_s.append(time.perf_counter() - t1)
        losses.append(loss)
        if (step + 1) % log_every == 0:
            dt = (time.perf_counter() - t0) / max(step + 1 - start, 1)
            print(f"[train] step {step+1:5d} loss {loss:8.4f} "
                  f"grad_norm {float(metrics['grad_norm']):7.3f} "
                  f"({dt*1e3:.0f} ms/step)", flush=True)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, state, step + 1)
    if ckpt_dir:
        save_checkpoint(ckpt_dir, state, steps)
    return state, losses, step_s


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="cut the depth (default: the config's)")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' to run there)")
    args = ap.parse_args(argv)
    _, losses, _ = train(args.arch, smoke=args.smoke, steps=args.steps,
                         batch_size=args.batch_size, seq_len=args.seq_len,
                         ckpt_dir=args.ckpt,
                         grad_compression=args.grad_compression,
                         num_layers=args.num_layers, device=args.device)
    if losses:
        print(f"[train] first loss {losses[0]:.4f} -> last loss "
              f"{losses[-1]:.4f}")


if __name__ == "__main__":
    main()

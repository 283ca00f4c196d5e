"""The two dense configs that only the port's smoke tests reached
(command-r-35b and qwen1.5-32b) against the JAX package, through the
engine and the training loss.

command-r-35b is the only dense config with LayerNorm (a ``bias`` beside
each ``scale``) and a tied 256000-row head (``embed.T``, at the smoke
size 512 rows); qwen1.5-32b the only one with QKV biases (``bq``, ``bk``,
``bv``) and with as many KV heads as query heads (G 1).  Both serve
through the paged and the dense engine with chunked prefill, two tight
lanes and staged arrivals, so requests are preempted and swapped as INT8
(the kv_quant plain versions here), on one virtual clock: the port must
emit the JAX engine's greedy tokens with the same preemptions.  Then the
loss and every gradient leaf against ``jax.value_and_grad`` of the
reference's loss.  The smoke configs in float32, weights from the JAX
``Model.init`` through ``params_from_numpy``.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core import predictor as jax_predictor  # noqa: E402
from repro.core import request as jax_request  # noqa: E402
from repro.core.quantization import kv_bytes_per_token  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.training import data as jax_data  # noqa: E402
from repro_torch import configs as port_configs  # noqa: E402
from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.core import predictor as port_predictor  # noqa: E402
from repro_torch.core import request as port_request  # noqa: E402
from repro_torch.models.model import Model, params_from_numpy  # noqa: E402
from repro_torch.utils import tree_leaves  # noqa: E402

CONFIGS = ["command-r-35b", "qwen1.5-32b"]
PROMPTS = (7, 8, 9, 15, 16, 17)
OUTS = (24, 24, 3, 3, 3, 3)
PAGE = 8
PORT = (port_engine, port_predictor, port_request)
JAX = (jax_engine, jax_predictor, jax_request)

_MODELS = {}


def _models(name):
    """(cfg, JAX model, JAX params, port model, port params) of ``name``'s
    smoke config in float32, built once; the port's config copy must
    equal the reference's."""
    if name not in _MODELS:
        cfg = dataclasses.replace(port_configs.get_smoke_config(name),
                                  param_dtype="float32")
        ref = dataclasses.replace(get_smoke_config(name),
                                  param_dtype="float32")
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
        jm = JaxModel(cfg, kv_dtype="float32", remat=False)
        jp = jm.init(jax.random.PRNGKey(0))
        tp = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
        _MODELS[name] = (cfg, jm, jp,
                         Model(cfg, kv_dtype="float32", device="cpu"), tp)
    return _MODELS[name]


def _staged(mods, cfg, model, params, backend, kinds=None):
    """tests/test_torch_engine.py's staged trace on a virtual clock (two
    requests, five steps, then four more), two lanes and a KV budget of
    two short sequences, chunks of 5 under a budget of 16 tokens, INT8
    swaps, no early stop.  ``kinds``, when given, gets each offload
    blob's K and V kinds."""
    eng_mod, pred_mod, req_mod = mods
    bpt = kv_bytes_per_token(cfg.num_layers, cfg.num_kv_heads, cfg.hd)
    req_mod.reset_request_counter()
    rng = np.random.default_rng(3)
    reqs = [req_mod.Request(prompt_len=p, arrival_time=0.0, true_out_len=o,
                            prompt_tokens=rng.integers(2, cfg.vocab_size,
                                                       p).tolist())
            for p, o in zip(PROMPTS, OUTS)]
    eng = eng_mod.ServingEngine(model, params, eng_mod.EngineConfig(
        max_slots=2, max_seq_len=64, max_new_tokens=48, strategy="alise",
        quantize_offload=True, hbm_bytes=2 * 40 * bpt, kv_backend=backend,
        page_size=PAGE, prefill_chunk=5, iter_token_budget=16, eos_token=-1),
        predictor=pred_mod.OraclePredictor())
    if kinds is not None:
        offload = eng.kv.offload

        def recorded(rid):
            blob = offload(rid)
            kinds.append((blob["k"][0], blob["v"][0]))
            return blob
        eng.kv.offload = recorded
    t = 0.0
    for r in reqs[:2]:
        eng.submit(r, t)
    for _ in range(5):
        eng.step(t)
        t += 0.1
    for r in reqs[2:]:
        eng.submit(r, t)
    for _ in range(1000):
        if not eng.sched.live:
            break
        eng.step(t)
        t += 0.1
    assert not eng.sched.live and all(r.done for r in reqs)
    return reqs, eng


@pytest.mark.parametrize("backend", ["paged", "dense"])
@pytest.mark.parametrize("name", CONFIGS)
def test_greedy_tokens_match_jax_engine_with_int8_swaps(name, backend):
    """Acceptance: the port's engine emits the JAX engine's greedy tokens
    with the same preemptions, every request its full trace length."""
    cfg, jm, jp, tm, tp = _models(name)
    ref, _ = _staged(JAX, cfg, jm, jp, backend)
    kinds = []
    got, eng = _staged(PORT, cfg, tm, tp, backend, kinds)
    assert [list(r.output_tokens) for r in got] == \
        [list(r.output_tokens) for r in ref]
    assert [r.preempt_count for r in got] == [r.preempt_count for r in ref]
    assert sum(r.preempt_count for r in got) > 0
    assert kinds and set(kinds) == {("q8", "q8")}
    assert [len(r.output_tokens) for r in got] == list(OUTS)
    assert not eng.host_pool


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_every_gradient_leaf_match_jax(name):
    """The loss (with its z-loss) and every gradient leaf against
    ``jax.value_and_grad`` of the reference's loss: the tied ``embed``
    (command-r, through the embedding and the head), LayerNorm's
    ``bias`` (command-r), the QKV biases (qwen)."""
    cfg, jm, jp, tm, _ = _models(name)
    batch = jax_data.SyntheticLM(cfg, jax_data.DataConfig(
        batch_size=2, seq_len=16)).batch_at(0)
    (jloss, jparts), g = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b), has_aux=True))(jp, batch)
    want = {str(k): v for k, v in tree_leaves(params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, g), device="cpu"))}
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    leaves = list(tree_leaves(params))
    for _, p in leaves:
        p.requires_grad_(True)
    loss, parts = tm.loss(params, {k: torch.from_numpy(np.asarray(v))
                                   for k, v in batch.items()})
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    for k in ("ce", "zloss"):
        assert float(parts[k].detach()) == pytest.approx(float(jparts[k]),
                                                         rel=1e-5)
    got = torch.autograd.grad(loss, [p for _, p in leaves])
    assert sorted(want) == sorted(str(k) for k, _ in leaves)
    names = {k[-1] for k, _ in leaves}
    if name == "command-r-35b":
        assert cfg.tie_embeddings and "lm_head" not in params
        assert "bias" in names
    else:
        assert {"bq", "bk", "bv"} <= names
    for (path, _), gr in zip(leaves, got):
        assert float(gr.abs().max()) > 0, path
        np.testing.assert_allclose(gr.numpy(), want[str(path)].numpy(),
                                   atol=1e-4, err_msg=str(path))

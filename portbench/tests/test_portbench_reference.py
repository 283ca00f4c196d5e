"""The plain reference against the port's plain path on smoke configs
(float32, CPU): whole-prompt logits, the MoE layer at a dropless
capacity, the INT8 round trip the swap applies, and the weights the
benchmark hands the program drawn again bit for bit."""
import dataclasses

import pytest
import torch

from portbench import bench, spec, weights
from portbench.arch import from_config
from portbench.reference import dense, kvq, moe

from cpu_cell import SMOKE


def smoke(cell, **extra):
    conf = dict(spec.cell(cell).config, **SMOKE, torch_dtype="float32",
                **extra)
    return conf, from_config(conf)


def port_model(conf, a):
    from repro_torch.models.model import Model
    return Model(bench.port_arch(a, conf, "float32"), device="cpu",
                 kv_dtype="float32", chunk_attn_impl="masked")


@pytest.mark.parametrize("cell,extra", [
    ("granite-3-8b.sharegpt.r80", {}),
    ("granite-moe-3b-a800m.sharegpt.r80",
     {"num_local_experts": 4, "num_experts_per_tok": 2,
      "port": {"capacity_factor": 2.0}}),
])
def test_reference_equals_the_ports_plain_prefill(cell, extra):
    torch.manual_seed(0)
    conf, a = smoke(cell, **extra)
    m = port_model(conf, a)
    p = weights.program_params(a, 11, "cpu")
    toks = torch.randint(2, a.vocab, (1, 37))
    with torch.no_grad():
        want, _ = m.prefill(p, {"tokens": toks})
    mod = moe if a.experts else dense
    got = mod.run(a, 11, "cpu", [dense.Seq(toks[0].tolist(), 36, [])])[0]
    torch.testing.assert_close(got, want.float(), atol=2e-5, rtol=1e-4)


def test_redraw_equals_the_programs_weights():
    conf, a = smoke("granite-moe-3b-a800m.sharegpt.r80",
                    num_local_experts=4, num_experts_per_tok=2)
    p = weights.program_params(a, 2 ** 32 + 9, "cpu")
    again = weights.draw(a, 2 ** 32 + 9, "cpu")
    assert torch.equal(next(again)[1], p["embed"])
    for layer in p["layers"]:
        got = next(again)[1]
        for g in ("attn", "ffn"):
            for k, v in layer[g].items():
                assert torch.equal(got[g][k], v)
    assert p["layers"][0]["ffn"]["router"].dtype == torch.float32


def test_int8_round_trip_is_the_swaps():
    from repro_torch.kernels.kv_quant.ref import (kv_dequantize_ref,
                                                  kv_quantize_ref)
    x = torch.randn(300, 64) * torch.rand(300, 1) * 3
    q, lam, z = kv_quantize_ref(x)
    assert torch.equal(kvq.roundtrip(x), kv_dequantize_ref(q, lam, z))


def test_swap_rounds_the_keys_before_it_only():
    torch.manual_seed(1)
    q, k, v = torch.randn(20, 4, 16), torch.randn(20, 2, 16), \
        torch.randn(20, 2, 16)
    plain = dense.attention(q, k, v, [])
    swapped = dense.attention(q, k, v, [12])
    torch.testing.assert_close(plain[:12], swapped[:12], atol=1e-6, rtol=0)
    assert not torch.allclose(plain[12:], swapped[12:], atol=1e-6)
    # the same as attending a cache whose first 12 rows were rounded
    kr = torch.cat([kvq.roundtrip(k[:12]), k[12:]])
    vr = torch.cat([kvq.roundtrip(v[:12]), v[12:]])
    torch.testing.assert_close(swapped[12:], dense.attention(q, kr, vr,
                                                             [])[12:])


def test_fp8_control_rounds_every_product():
    w = torch.randn(64, 32)
    r = dense.fp8_round(w, -2)
    assert not torch.equal(r, w)
    assert ((r - w).abs() <= w.abs().amax(0) / 448 * 16 + 1e-6).all()
    conf, a = smoke("granite-3-8b.sharegpt.r80")
    a = dataclasses.replace(a)
    seqs = [dense.Seq(list(range(2, 30)), 10, [])]
    f32 = dense.run(a, 3, "cpu", seqs)[0]
    fp8 = dense.run(a, 3, "cpu", seqs, "fp8")[0]
    assert (f32 - fp8).abs().max() > 1e-2 * f32.abs().max()


@pytest.mark.parametrize("key", ["emb_mult", "attn_mult", "res_mult",
                                 "logits_scale"])
def test_each_published_multiplier_reaches_the_logits(key):
    """The program runs Granite's multipliers folded into its weights, and
    the reference applies them unfolded: the test above holds the two
    equal, and here a reference that dropped any one of them would
    differ."""
    conf, a = smoke("granite-3-8b.sharegpt.r80")
    assert getattr(a, key) not in (0.0, 1.0)
    seqs = [dense.Seq(list(range(2, 30)), 10, [])]
    want = dense.run(a, 5, "cpu", seqs)[0]
    # the same draw, read by a reference without this one multiplier
    off = dataclasses.replace(a, **{key: 0.0 if key == "attn_mult"
                                    else 1.0})
    folds = weights.fold(a)
    orig = weights.fold
    weights.fold = lambda _a: folds
    try:
        got = dense.run(off, 5, "cpu", seqs)[0]
    finally:
        weights.fold = orig
    assert (got - want).abs().max() > 1e-3 * want.abs().max()

"""The metric arithmetic on synthetic receipt records and events: a
censored TTFT counts, a tail is over all requests, tokens are over the
whole window; the per-layer readers; the device trace's reduction."""
import pytest

from portbench import bench, e2e, readers, spec
from portbench.arch import from_config
from portbench.profiling import DeviceTrace

SECONDS = 10.0


def rec(due, token_t, finish=None, out_len=None):
    r = e2e.Record(due=due, out_len=out_len or len(token_t), prompt=[2, 3])
    r.token_t = list(token_t)
    r.tokens = [5] * len(token_t)
    r.finish_t = finish
    return r


def recs():
    return {0: rec(0.0, [0.5, 0.6, 0.7], finish=0.7),
            1: rec(1.0, [4.0, 6.0]),               # still running
            2: rec(8.0, []),                        # no first token: censored
            3: rec(9.0, [9.5, 10.5], finish=10.5),  # finishes after the close
            4: rec(12.0, [])}                       # due after the close


def test_tokens_over_the_whole_window():
    # 3 + 2 + 1 tokens received by the close (10.5 is after it)
    assert e2e.tokens_per_s(recs(), SECONDS) == pytest.approx(6 / SECONDS)


def test_censored_ttft_counts_its_wait():
    t = sorted(e2e.ttfts(recs(), SECONDS))
    # 0.5, 3.0, the censored 2.0 (10 - 8), 0.5; request 4 is not due
    assert t == pytest.approx(sorted([0.5, 3.0, 2.0, 0.5]))
    assert e2e.ttft_p90_s(recs(), SECONDS) == pytest.approx(
        __import__("numpy").percentile([0.5, 3.0, 2.0, 0.5], 90))


def test_itl_tail_over_all_gaps_in_the_window():
    gaps = sorted(e2e.itls(recs(), SECONDS))
    assert gaps == pytest.approx([0.1, 0.1, 2.0])
    assert e2e.itl_p99_ms(recs(), SECONDS) == pytest.approx(
        __import__("numpy").percentile([0.1, 0.1, 2.0], 99) * 1e3)


def test_normalized_latency_over_requests_finished_in_the_window():
    # only request 0: (0.7 - 0) / 3 tokens
    assert e2e.norm_latency_ms_per_tok(recs(), SECONDS) == \
        pytest.approx(0.7 / 3 * 1e3)


def test_no_tokens_reads_nothing():
    assert e2e.itl_p99_ms({0: rec(0.0, [])}, SECONDS) is None
    assert e2e.norm_latency_ms_per_tok({0: rec(0.0, [])}, SECONDS) is None


class Ev:
    def __init__(self, kind, t, req_id=-1, dur=0.0, **data):
        self.kind, self.t, self.req_id, self.dur, self.data = \
            kind, t, req_id, dur, data


def ctx(**kw):
    a = from_config(spec.cell("granite-3-8b.sharegpt.r80").config)
    base = dict(arch=a, seconds=SECONDS, recs=recs(), events=[])
    base.update(kw)
    return readers.Ctx(**base)


def test_queue_wait_and_preemptions():
    events = [Ev("prefill_chunk", 0.2, 0, 0.01, start=0, end=2),
              Ev("prefill_chunk", 3.5, 1, 0.01, start=0, end=2),
              Ev("prefill_chunk", 3.6, 1, 0.01, start=2, end=4),
              Ev("preempt", 5.0, 1), Ev("preempt", 11.0, 3),
              Ev("predict", 0.0, 0, p50=5), Ev("predict", 1.0, 1, p50=1)]
    c = ctx(events=events)
    assert bench._reader("sched.queue_wait_p50_s")(c) == \
        pytest.approx((0.2 + 2.5) / 2)
    # one preemption in the window over the 4 requests due in it
    assert bench._reader("sched.preempts_per_req")(c) == pytest.approx(0.25)
    # |5 - 3| and |1 - 2|
    assert bench._reader("pred.len_mae_tok")(c) == pytest.approx(1.5)


def test_engine_readers_stop_where_the_profiler_starts():
    decode = [(1.0, 1000, 8, 0.020), (5.0, 3000, 16, 0.030),
              (8.9, 1000, 8, 0.500)]
    prefill = [(2.0, 256, 0.016, 1), (9.0, 256, 9.0, 1)]
    c = ctx(decode=decode, prefill=prefill, traced=(8.5, 10.0))
    assert bench._reader("engine.decode_step_ms")(c) == pytest.approx(25.0)
    assert bench._reader("engine.prefill_ms_per_ktok")(c) == \
        pytest.approx(0.016 / 256 * 1e6)
    from portbench.roofline import model_step, peaks
    want = (model_step.decode_flops(c.arch, 8, 1000)
            + model_step.decode_flops(c.arch, 16, 3000)) / 0.050 \
        / peaks.BF16_FLOPS * 100
    assert bench._reader("mfu.decode")(c) == pytest.approx(want)
    # requests due before the sub-window: 0, 1 and 2 (3 is due at 9.0)
    assert c.due() == [0, 1, 2]


def test_device_readers_and_trace():
    from portbench.roofline import flash_prefill_prefix, paged_attention
    ops = [("void paged_attention_kernel<bf16>(x)", 4_100_000_000, 2_000_000),
           ("paged_attention_merge_kernel", 4_102_000_000, 500_000),
           ("flash_attn_wgmma_kernel", 4_200_000_000, 1_000_000),
           ("gemm", 4_300_000_000, 100_000_000)]
    tr = DeviceTrace(4_000_000_000, 6_000_000_000, ops, [])
    decode = [(4.1, 5000, 16, 0.02), (7.0, 5000, 16, 0.02)]
    events = [Ev("prefill_chunk", 4.2, 0, 0.01, start=256, end=512)]
    c = ctx(decode=decode, events=events, trace=tr, traced=(4.0, 6.0))
    want = paged_attention.step_bound_s(c.arch, 16, 5000) / 0.0025 * 100
    assert bench._reader("paged_attention_roofline")(c) == pytest.approx(want)
    want = flash_prefill_prefix.chunk_bound_s(c.arch, 256, 512) / 0.001 * 100
    assert bench._reader("flash_prefill_prefix_roofline")(c) == \
        pytest.approx(want)
    busy = (2.5e6 + 1e6 + 1e8) / 1e9
    assert bench._reader("device.idle_share")(c) == \
        pytest.approx((1 - busy / 2.0) * 100)


def test_readers_find_nothing_without_a_trace():
    c = ctx()
    for name in ("paged_attention_roofline", "flash_prefill_prefix_roofline",
                 "device.idle_share", "swap.offload_ms_mean",
                 "engine.decode_step_ms"):
        assert bench._reader(name)(c) is None


def test_every_per_layer_metric_has_a_reader():
    for m in spec.benchmark()["per_layer"]:
        assert callable(bench._reader(m["name"]))


def test_idle_gaps_named_by_the_innermost_span():
    tr = DeviceTrace(0, 100, [("k", 10, 10), ("k", 15, 20), ("k", 60, 10)],
                     [("step", 5, 50), ("plan", 5, 12), ("poll", 50, 80)])
    assert tr.busy_s() == pytest.approx(35e-9)
    assert dict(tr.idle_gaps()) == pytest.approx(
        {"plan": 10e-9, "step": 25e-9, "outside spans": 30e-9})


def test_kernel_names_lose_namespaces_and_templates():
    from portbench.profiling import short_name
    assert short_name("void (anonymous namespace)::paged_attention_kernel"
                      "<__nv_bfloat16, 128>(int const*, float*)") == \
        "paged_attention_kernel"
    assert short_name("void at::native::(anonymous namespace)::k<int>(int)"
                      ) == "at::native::k"


def test_every_end_to_end_metric_is_computed():
    for m in spec.benchmark()["end_to_end"]:
        assert m["name"] == "setup_s" or m["name"] in e2e.HOST_CLOCK

"""The port's defaults against the JAX package's: ``EngineConfig`` field by
field and the serve launcher's ``--kv-backend``, ``--spec-decode``,
``--spec-k`` and ``--trace-out``, so that a run that names
no backend takes the same path in both frameworks (the dense KV backend),
and a granite engine built without one serves on it."""
import argparse
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.core import engine as ref_engine  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro_torch.core import engine as port_engine  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.serving.kv_cache import DenseKVBackend  # noqa: E402


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        elif f.default_factory is not dataclasses.MISSING:
            out[f.name] = f.default_factory()
    return out


def test_engine_config_defaults_match_the_reference():
    """Every field of the reference's ``EngineConfig`` is the port's, with
    the same default; the port adds only ``cuda_graphs``."""
    port, ref = _defaults(port_engine.EngineConfig), _defaults(
        ref_engine.EngineConfig)
    assert set(ref) <= set(port), sorted(set(ref) - set(port))
    assert set(port) - set(ref) == {"cuda_graphs"}
    shared = sorted(ref)
    assert "kv_backend" in shared and "realtime_swap" in shared
    differ = {n: (port[n], ref[n]) for n in shared if port[n] != ref[n]}
    assert differ == {}, differ
    assert port_engine.EngineConfig().kv_backend == "dense"
    assert {"spec_decode", "spec_k"} <= set(shared)
    assert port_engine.EngineConfig().spec_k == ref_engine.EngineConfig(
    ).spec_k == 3


class _Parsed(Exception):
    def __init__(self, ns):
        super().__init__()
        self.ns = ns


def _parsed_defaults(main, monkeypatch):
    """The namespace ``main`` parses from an empty command line (it stops
    right after parsing)."""
    parse = argparse.ArgumentParser.parse_args

    def stop(self, args=None, namespace=None):
        raise _Parsed(parse(self, [], namespace))
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(_Parsed) as got:
        main()
    return got.value.ns


def test_serve_launcher_defaults_to_the_dense_backend(monkeypatch):
    port = _parsed_defaults(port_serve.main, monkeypatch)
    ref = _parsed_defaults(ref_serve.main, monkeypatch)
    assert port.kv_backend == ref.kv_backend == "dense"
    import inspect
    for fn in (port_serve.serve, ref_serve.serve):
        assert inspect.signature(fn).parameters["kv_backend"].default == \
            "dense"


def test_granite_engine_without_a_backend_serves_dense():
    reqs, eng = port_serve.serve(arch_size="smoke", n_requests=3,
                                 max_slots=2, device="cpu", verbose=False)
    assert eng.cfg.kv_backend == "dense" and eng.kv_backend == "dense"
    assert isinstance(eng.kv, DenseKVBackend)
    assert all(r.done and r.generated >= 1 for r in reqs)
    model, params = port_serve.build_model("granite-3-8b", "smoke",
                                           torch.device("cpu"), None, 0)
    eng = port_engine.ServingEngine(model, params,
                                    port_engine.EngineConfig(max_slots=2))
    assert eng.kv_backend == "dense" and isinstance(eng.kv, DenseKVBackend)


def test_serve_launcher_spec_defaults_match_the_reference(monkeypatch):
    """``--spec-decode`` (off), ``--spec-k`` (3) and ``--trace-out`` (none)
    parse to the reference launcher's defaults, and ``serve()`` takes the
    same keyword defaults."""
    port = _parsed_defaults(port_serve.main, monkeypatch)
    ref = _parsed_defaults(ref_serve.main, monkeypatch)
    for name in ("spec_decode", "spec_k", "trace_out"):
        assert getattr(port, name) == getattr(ref, name), name
    assert (port.spec_decode, port.spec_k, port.trace_out) == (False, 3,
                                                               None)
    import inspect
    for name in ("spec_decode", "spec_k", "trace_out"):
        assert (inspect.signature(port_serve.serve).parameters[name].default
                == inspect.signature(ref_serve.serve).parameters[name]
                .default), name


def test_gateway_config_defaults_match_the_reference():
    """``GatewayConfig`` and ``AdmissionConfig`` of the port's gateway have
    the reference's fields with the reference's defaults."""
    from repro.serving import gateway as ref_gw
    from repro_torch.serving import gateway as port_gw
    for name in ("GatewayConfig", "AdmissionConfig"):
        port = _defaults(getattr(port_gw, name))
        ref = _defaults(getattr(ref_gw, name))
        assert list(port) == list(ref), name
        assert {k: (v.value if hasattr(v, "value") else v)
                for k, v in port.items()} == {
            k: (v.value if hasattr(v, "value") else v)
            for k, v in ref.items()}, name
    assert port_gw.GatewayConfig().concurrent_pump is True
    assert port_gw.__all__ == ref_gw.__all__


_GATEWAY_FLAGS = ("gateway", "dataset", "rate", "n_engines", "router",
                  "interactive_frac", "wall", "pump",
                  "ttft_target_interactive", "ttft_target_batch",
                  "ttft_miss_policy", "ttft_quantile", "metrics_interval",
                  "kv_tier", "tier_bytes", "tier_quantize", "devices")


def test_serve_launcher_gateway_flags_match_the_reference(monkeypatch):
    """The gateway mode's flags parse from an empty command line to the
    reference launcher's values, and ``serve_gateway`` takes the
    reference's keyword defaults for every parameter they share, apart
    from ``chunk_attn``, whose default is the device's (``flash`` on a
    GPU, as in the port's batch mode)."""
    import inspect
    port = _parsed_defaults(port_serve.main, monkeypatch)
    ref = _parsed_defaults(ref_serve.main, monkeypatch)
    for name in _GATEWAY_FLAGS:
        assert getattr(port, name) == getattr(ref, name), name
    pp = inspect.signature(port_serve.serve_gateway).parameters
    rp = inspect.signature(ref_serve.serve_gateway).parameters
    assert set(rp) <= set(pp), sorted(set(rp) - set(pp))
    differ = {n: (pp[n].default, rp[n].default) for n in rp
              if pp[n].default != rp[n].default}
    assert differ == {"chunk_attn": (None, "masked")}, differ

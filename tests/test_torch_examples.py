"""The port's examples (``examples/*_torch.py``) on the CPU, held to the
reference's examples where they print the same table.

- ``cluster_simulation_torch``: the analytic simulator and cluster models
  are copies, so its whole output equals ``examples/cluster_simulation.py``'s
  to the printed digits (the reference runs in a subprocess beside it).
- ``scheduler_comparison_torch``: its table over the burst equals the
  reference example's rows (mean, short-job and long-job latency in
  virtual-clock seconds, preemptions).  A latency moves with the tokens
  only where a request meets its EOS token, so both run the smoke config
  in float32 on the same weights (the reference example's own
  ``Model.init(PRNGKey(0))``, carried over by ``params_from_numpy``).
- ``quickstart_torch``: the loss falls, all 8 requests finish, and the
  fitted latency model's terms are finite.
"""
import contextlib
import dataclasses
import importlib.util
import io
import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke_config  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro_torch.models.model import Model, params_from_numpy  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load(name):
    """``examples/<name>.py`` as a module (its ``main`` not run)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _printed(fn, *args):
    """(fn's result, what it printed)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args)
    return res, out.getvalue()


def test_cluster_simulation_example_prints_the_references_table():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / "cluster_simulation.py")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _, got = _printed(_load("cluster_simulation_torch").main)
        want, err = ref.communicate(timeout=300)
    finally:
        ref.kill()
    assert ref.returncode == 0, err
    assert "ALISE" in got and "nothing lost" in got
    assert got == want


def _table(text):
    """The header and the three strategies' rows of a printed table."""
    lines = text.splitlines()
    at = next(i for i, ln in enumerate(lines) if ln.startswith("system"))
    return lines[at:at + 4]


def test_scheduler_comparison_example_rows_equal_the_references():
    ref = _load("scheduler_comparison")
    port = _load("scheduler_comparison_torch")
    cfg = dataclasses.replace(get_smoke_config("granite-3-8b"),
                              param_dtype="float32")
    ref.get_smoke_config = lambda name: cfg
    _, want = _printed(ref.main)
    jp = JaxModel(cfg, attn_chunk=32, remat=False).init(jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    rows, got = _printed(port.compare, Model(cfg, attn_chunk=32,
                                             device="cpu"), params)
    assert _table(got) == _table(want)
    by = {r[0]: r for r in rows}
    assert by["alise"][2] < by["orca"][2] and by["alise"][4] > 0


def test_scheduler_comparison_example_main_on_the_cpu():
    rows, out = _printed(_load("scheduler_comparison_torch").main,
                         ["--device", "cpu"])
    assert [r[0] for r in rows] == ["orca", "vllm", "alise"]
    assert len(_table(out)) == 4 and "[cpu]" in out


def test_quickstart_example_learns_serves_and_fits():
    (losses, reqs, lm), out = _printed(_load("quickstart_torch").main,
                                       ["--device", "cpu"])
    assert len(losses) == 60 and losses[-1] < losses[0] - 0.1
    assert "LEARNING" in out
    assert len(reqs) == 8 and all(r.done for r in reqs)
    assert [r.generated for r in reqs] == [r.true_out_len for r in reqs]
    assert all(np.isfinite(v) for v in (lm.t0, lm.alpha, lm.beta))

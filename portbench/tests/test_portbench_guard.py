"""The import guard compares top-level module names whole."""
import sys
import types

from portbench import bench


def test_the_port_is_not_the_jax_package():
    import repro_torch  # noqa: F401
    assert "repro" not in bench.forbidden_modules()
    assert bench.forbidden_modules() == []


def test_jax_and_the_jax_package_are_caught(monkeypatch):
    for name in ("repro.core.engine", "jax", "jaxlib.xla_client", "flax"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert bench.forbidden_modules() == ["flax", "jax", "jaxlib", "repro"]


def test_the_harness_imports_neither():
    import portbench.reference.moe  # noqa: F401
    import portbench.check  # noqa: F401
    assert bench.forbidden_modules() == []

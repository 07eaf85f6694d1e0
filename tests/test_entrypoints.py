"""Entry points that measure or smoke-test the GPU refuse any other device,
and the compilation cache lives where the deployment says."""
import importlib.util
import os

import jax
import pytest

from metricsfm_tpu.utils import cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_entry_{name}", os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.enable_compilation_cache() == str(tmp_path)
    # JAX reads the variable itself; no other directory is set in code
    assert jax.config.jax_compilation_cache_dir is None


def test_cache_default_is_fixed_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cache.enable_compilation_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert cache.enable_compilation_cache() == path


@pytest.fixture
def restore_platforms():
    old = jax.config.jax_platforms
    yield
    jax.config.update("jax_platforms", old)


@pytest.mark.parametrize("entry", ["chip_smoke", "bench"])
def test_entry_refuses_cpu(entry, capsys, restore_platforms):
    """Run on the CPU, each script stops at its device check and prints no
    result line."""
    main = _load(entry).main
    assert jax.default_backend() == "cpu"
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        main([]) if entry == "chip_smoke" else main()
    assert '"ok"' not in capsys.readouterr().out

"""Process set-up rules (hygeia_tpu/runtime.py): where the persistent
compile cache lives, and how much device memory the INFER planners may
size their unit batches against."""

from types import SimpleNamespace

import jax
import pytest

from hygeia_tpu import runtime
from hygeia_tpu.two_group.runner import (
    HISTORY_BYTES_PER_SITE_PARTICLE,
    shared_unit_width,
)


@pytest.mark.parametrize("env_dir", [True, False], ids=["env", "default"])
def test_compile_cache_dir(env_dir, tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins (JAX reads it; nothing is set);
    otherwise the cache sits at the fixed <checkout>/.jax_cache."""
    before = jax.config.jax_compilation_cache_dir
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = runtime.setup_compile_cache()
        if env_dir:
            assert got == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == before
        else:
            assert got == str(runtime.DEFAULT_CACHE_DIR)
            assert runtime.DEFAULT_CACHE_DIR.parent.joinpath("hygeia_tpu").is_dir()
            assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _device(platform, stats):
    return SimpleNamespace(
        platform=platform, device_kind=f"fake {platform}",
        memory_stats=lambda: stats,
    )


@pytest.mark.parametrize(
    "platform, stats, env, want",
    [
        ("gpu", {"bytes_limit": 60 * 2**30}, None,
         60 * 2**30 * runtime.DEVICE_MEMORY_SHARE),
        ("gpu", {"bytes_limit": 60 * 2**30}, "2.5", 2.5 * 2**30),
        ("gpu", None, "3", 3 * 2**30),
        ("cpu", None, None, runtime.CPU_MEMORY_BUDGET_BYTES),
        ("gpu", None, None, RuntimeError),
        ("gpu", {}, None, RuntimeError),
    ],
    ids=["from-stats", "env-override", "env-without-stats", "cpu-constant",
         "gpu-no-stats", "gpu-empty-stats"],
)
def test_device_memory_budget(platform, stats, env, want, monkeypatch):
    if env is None:
        monkeypatch.delenv("HYGEIA_HBM_BUDGET_GB", raising=False)
    else:
        monkeypatch.setenv("HYGEIA_HBM_BUDGET_GB", env)
    dev = _device(platform, stats)
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="no memory statistics"):
            runtime.device_memory_budget(dev)
    else:
        assert runtime.device_memory_budget(dev) == pytest.approx(want)


def test_memory_budget_of_the_test_device():
    """The CPU backend the suite runs on takes the stated constant."""
    assert runtime.device_memory_budget() > 0


@pytest.mark.parametrize(
    "groups, max_units, want",
    [
        # Long windows cap at 2 units each; the short tail group alone
        # would allow 8, but the shared width must fit every group.
        ({110_000: 4, 5_000: 4}, None, 2),
        ({110_000: 1, 105_000: 1}, None, 2),  # 2 seeds x 1 batch
        ({5_000: 4}, None, 8),
        ({5_000: 4}, 3, 3),  # retry back-off
    ],
)
def test_shared_unit_width_respects_every_group_cap(groups, max_units, want):
    W, N, seeds = 16384, 2400, 2
    budget = 2.5 * W * N * HISTORY_BYTES_PER_SITE_PARTICLE  # 2 long units
    got = shared_unit_width(groups, W, N, seeds, max_units=max_units,
                            budget=budget)
    assert got == want
    for t_w in groups:
        per_unit = min(t_w, W) * N * HISTORY_BYTES_PER_SITE_PARTICLE
        assert got == 1 or got * per_unit <= budget

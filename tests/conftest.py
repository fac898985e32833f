"""Test configuration: the suite runs on the CPU, on a virtual 8-device mesh.

Test policy: every test runs on the CPU backend (JAX_PLATFORMS=cpu), so the
suite needs no accelerator and gives the same answers on every machine.
Mirrors the stub-run idea of the reference's Nextflow pipeline (SURVEY.md
section 4): multi-device sharding logic is exercised on host CPU devices via
XLA's forced host platform device count. `python chip_smoke.py` is the
on-GPU check.
"""

import os

# Must be set before jax is imported anywhere.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

# No persistent compile cache: the suite stays hermetic and writes nothing
# into the checkout (hygeia_tpu.runtime.setup_compile_cache only names the
# directory).
jax.config.update("jax_enable_compilation_cache", False)

# Enable x64 so CPU parity tests can compare against the reference's
# double-precision C++ engine; production runs use f32 (dtype arguments are
# explicit throughout the package).
jax.config.update("jax_enable_x64", True)

"""Test env: force CPU backend with 8 virtual devices so sharding tests run
anywhere (the TPU-native analog of the reference's GPU-only e2e tests —
SURVEY.md §4 mandates a CPU-runnable pyramid the reference lacks).

NOTE: in this image the `JAX_PLATFORMS` env var is ignored by the TPU plugin;
`jax.config.update("jax_platforms", ...)` is authoritative.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# fp64 for tiny-model greedy exact-match tests (see ModelConfig.tiny).
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips with a reason where there is none"
    )

"""Test config: run everything on a virtual 8-device CPU mesh.

Multi-device sharding is validated without accelerators via
xla_force_host_platform_device_count.  Tests marked `gpu` need an NVIDIA
GPU: they skip here, and chip_smoke.py runs them on the card with
FTRL_FFM_TEST_PLATFORM=gpu, which leaves JAX's platform alone.
"""

import os

import pytest

if os.environ.get("FTRL_FFM_TEST_PLATFORM") != "gpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """`gpu`-marked tests skip unless JAX's backend is a GPU (decided here,
    at run time, so every worker collects the same tests)."""
    if request.node.get_closest_marker("gpu") is not None:
        import jax

        if jax.default_backend() != "gpu":
            pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs it there)")

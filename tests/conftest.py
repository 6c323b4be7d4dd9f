"""Test harness config: force an 8-device virtual CPU mesh.

SURVEY.md §4: multi-device correctness is tested on a single host via
``--xla_force_host_platform_device_count=8`` — the same mesh/shard_map code
paths as a real multi-GPU host, no accelerator required. Every op takes its
CPU route (ops/route.py); Pallas interpret mode runs only where a test asks
for it. Tests that need a GPU carry the ``gpu`` marker and skip here.

On the card, ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`` keeps
the GPU and runs the ``gpu``-marked tests there.

Must run before any ``import jax`` anywhere in the test session.
"""

import os

_ON_GPU = os.environ.get("JAX_PLATFORMS", "") in ("cuda", "gpu")
if not _ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# also pin the platform through the config API (must happen pre-backend-init)
import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")

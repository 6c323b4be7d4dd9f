"""Which implementation each device op takes, by platform.

The program runs on two platforms: ``"gpu"`` (CUDA, the serving target)
and ``"cpu"`` (tests and the CPU command line). Every op in ``ops/`` asks
:func:`impl` for its route at trace time, so an unknown backend fails
loudly instead of silently taking a slow path. Pallas interpret mode is
never a route: only a test that passes ``interpret=True`` gets it.
"""

from __future__ import annotations

import jax

# op -> {platform: implementation}. "xla" is plain jax.numpy/lax compiled
# by XLA (cuBLAS / XLA's own kernels on the GPU); "triton" is a Pallas
# kernel compiled through the Triton route (ops/matvec.py, ops/topk.py);
# "cudnn" is cuDNN's fused attention via jax.nn.dot_product_attention.
ROUTES: dict[str, dict[str, str]] = {
    "flat_search": {"gpu": "xla", "cpu": "xla"},
    "block_topk": {"gpu": "triton", "cpu": "xla"},
    "int8_flat_search": {"gpu": "xla", "cpu": "xla"},
    "int4_flat_search": {"gpu": "xla", "cpu": "xla"},
    "ivf_probe_search": {"gpu": "xla", "cpu": "xla"},
    "quant_matvec": {"gpu": "triton", "cpu": "xla"},
    "quant_matvec_int4": {"gpu": "xla", "cpu": "xla"},
    "attention_prefill": {"gpu": "cudnn", "cpu": "xla"},
    "attention_cached": {"gpu": "xla", "cpu": "xla"},
}

PLATFORMS = ("gpu", "cpu")


def platform() -> str:
    """The default backend, checked against the platforms with a route."""
    p = jax.default_backend()
    if p not in PLATFORMS:
        raise RuntimeError(
            f"no route for JAX backend {p!r}: ops are routed for "
            f"{PLATFORMS} only")
    return p


def impl(op: str, platform_name: str | None = None) -> str:
    """Implementation ``op`` takes on ``platform_name`` (default: the
    current backend)."""
    return ROUTES[op][platform_name or platform()]


def table(platform_name: str | None = None) -> dict[str, str]:
    """Every op's implementation on one platform (for run reports)."""
    p = platform_name or platform()
    return {op: routes[p] for op, routes in ROUTES.items()}

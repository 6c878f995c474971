"""Per-platform execution choices and the persistent compile cache.

Every choice that depends on the JAX platform is made here, once, outside
any ``jit``: callers resolve a :class:`BackendConfig` and pass its values
down as static arguments, so a compiled program is keyed on the concrete
choice and never reads the platform while tracing.

Only platforms with an entry in the table are supported; any other raises
instead of silently inheriting a neighbour's settings.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

__all__ = [
    "BackendConfig",
    "backend_config",
    "compile_cache_dir",
    "enable_compile_cache",
]


@dataclass(frozen=True)
class BackendConfig:
    """Execution choices for one JAX platform.

    Attributes:
        encoder: ``"device"`` -- whole-stream encode runs plan + emit + pack
            on the device (codec/device_encoder); ``"host"`` -- the
            vectorized host emitter (codec/fast_encoder).
        planner: host-emitter block planner for narrow samples: ``"native"``
            (the C++ integer search, ops/native_planner) or ``"xla"`` (the
            jitted planner, ops/device_codec, on the default device).
        chunk_frames: frames per device decode dispatch
            (codec/device_decoder).
    """

    encoder: str
    planner: str
    chunk_frames: int


_TABLE = {
    "cpu": BackendConfig(encoder="host", planner="native", chunk_frames=2048),
    # NVIDIA GPUs (H100).  chunk_frames is a working value, not tuned on
    # the card.
    "gpu": BackendConfig(encoder="device", planner="xla", chunk_frames=4096),
}


def backend_config(platform: str | None = None) -> BackendConfig:
    """The execution choices for ``platform`` (default: JAX's default
    backend).  Raises ValueError for a platform without a table entry."""
    if platform is None:
        import jax

        platform = jax.default_backend()
    try:
        return _TABLE[platform]
    except KeyError:
        raise ValueError(
            f"no execution settings for JAX platform {platform!r} "
            f"(supported: {', '.join(sorted(_TABLE))})"
        ) from None


_CHECKOUT_ROOT = Path(__file__).resolve().parent.parent


def compile_cache_dir() -> str | None:
    """Directory this program should point JAX's persistent compile cache
    at, or None when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then reads
    the variable itself).  The default is a fixed ``.jax_cache/`` at the
    checkout root: the cache key includes the path, so it must not move."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR") is not None:
        return None
    return str(_CHECKOUT_ROOT / ".jax_cache")


def enable_compile_cache() -> str | None:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`.

    Returns the directory set, or None when the environment variable
    governs.  Call before the first compilation.
    """
    path = compile_cache_dir()
    if path is not None:
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path

"""Where the persistent XLA compilation cache lives.

The rule, shared by chip_smoke.py, bench.py, the CLI (sphsim.app),
__graft_entry__.py and the CPU tests:

- JAX_COMPILATION_CACHE_DIR set: jax reads it itself and nothing here
  sets another cache.
- unset: a fixed `<checkout>/.jax_cache` (the path is part of the cache's
  key, so it must not move between runs). The CPU tests alone add a
  host-fingerprint subdirectory: XLA:CPU AOT results embed the compiling
  host's CPU feature set, which jax's cache key does not include, so an
  entry compiled on another host could reload with mismatched machine
  features.
"""

from __future__ import annotations

import hashlib
import os

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def host_fingerprint() -> str:
    """Hash of the first logical CPU's identity block in /proc/cpuinfo."""
    ident = []
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                key = line.split(":")[0].strip()
                if key in ("vendor_id", "cpu family", "model",
                           "model name", "stepping", "microcode", "flags"):
                    ident.append(line.strip())
                if line.strip() == "" and ident:
                    break   # first logical CPU block is enough
    except OSError:
        import platform

        ident = [platform.processor()]
    return hashlib.sha1("\n".join(ident).encode()).hexdigest()[:12]


def setup_persistent_cache(base: str | None = None, per_host: bool = False,
                           min_compile_secs: float = 1.0) -> str:
    """Apply the rule above and return the cache directory in use.

    base: directory used when the variable is unset (default
    `<checkout>/.jax_cache`); per_host adds the host-fingerprint
    subdirectory (CPU tests only). Must run after `import jax`."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    d = base or os.path.join(CHECKOUT, ".jax_cache")
    if per_host:
        d = os.path.join(d, host_fingerprint())
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", min_compile_secs
    )
    return d

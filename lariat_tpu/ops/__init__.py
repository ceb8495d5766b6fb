"""Device (JAX/XLA) compute kernels.

Importing this package enables jax x64 mode: FM-index row indices over a
whole-genome FMD text (hg38 doubled = 6.2e9 rows) exceed int32. The SW
kernels pin int32 explicitly and are unaffected. A per-shard int32
coordinate scheme (chromosome-group index sharding) would lift this.

Compiled kernels persist across processes in JAX's compilation cache: the
directory JAX_COMPILATION_CACHE_DIR names when it is set (JAX reads it
itself), and otherwise ``.jax_cache/`` at the root of the checkout.
"""

import os as _os

import jax

jax.config.update("jax_enable_x64", True)

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__)))), ".jax_cache"))
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

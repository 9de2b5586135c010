import os

# Request a virtual 8-device CPU mesh before any backend initializes, so the
# sharding tests exercise multi-device paths without accelerators.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# The unit suite runs on the CPU in float64 (golden parity with the
# reference's double-precision results); the GPU paths are checked by
# chip_smoke.py on the card.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

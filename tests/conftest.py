"""Test configuration: force an 8-device virtual CPU mesh (SURVEY.md §4.4).

Tests never touch an accelerator; sharding/distributed behaviour is
validated on 8 virtual CPU devices.  Everything that can only run on
the GPU is a phase of chip_smoke.py instead.  The platform is forced
through jax.config here, before any backend is initialised, so it
holds even when jax was imported earlier in the process.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

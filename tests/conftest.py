"""Test configuration: force an 8-device virtual CPU mesh.

The tests run on the CPU (``JAX_PLATFORMS=cpu`` and ``jax.config``, set
before any backend initializes) so they are fast, local and deterministic
on the virtual mesh.  What runs only on a GPU is checked by
``python chip_smoke.py`` on the card; tests of it carry the ``gpu`` marker.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
assert jax.devices()[0].platform == "cpu", jax.devices()
assert len(jax.devices()) == 8, jax.devices()

"""Test bootstrap: an 8-device virtual CPU mesh before any backend init.

Tests run on the CPU (SURVEY.md test strategy: sharding correctness is
validated on host devices); what needs the card is a phase of
``chip_smoke.py``, not a test.
"""

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)

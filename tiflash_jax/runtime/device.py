"""The card the engine runs on, and the persistent compile cache.

Scripts that run on the GPU (``chip_smoke.py``, ``bench.py``'s child mode,
the CLI) call ``enable_compile_cache()`` first: when the environment names
no cache (``JAX_COMPILATION_CACHE_DIR``, which JAX reads itself), compiled
programs are kept in ``.jax_cache`` at the root of the checkout, a fixed
path, so that the next process on the same checkout finds them.  The
tests never call it.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import Mapping, Optional

REPO_ROOT = Path(__file__).resolve().parents[2]
DEFAULT_CACHE_DIR = REPO_ROOT / ".jax_cache"


def compile_cache_dir(environ: Mapping[str, str] = os.environ) -> Optional[str]:
    """The directory the program must point JAX's compile cache at, or
    None when ``JAX_COMPILATION_CACHE_DIR`` is set and JAX uses it as is."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return str(DEFAULT_CACHE_DIR)


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on; returns the directory in use."""
    import jax

    path = compile_cache_dir()
    if path is None:
        return os.environ["JAX_COMPILATION_CACHE_DIR"]
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def card_line() -> str:
    """Name and power limit of each card, as ``nvidia-smi`` reports them
    (a card set below its maximum power runs slower under load, so every
    measurement is printed beside this line)."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit",
           "--format=csv,noheader"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=60, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {type(e).__name__}: {e}"
    return "; ".join(line.strip() for line in out.stdout.splitlines()
                     if line.strip())


__all__ = ["compile_cache_dir", "enable_compile_cache", "card_line",
           "DEFAULT_CACHE_DIR"]

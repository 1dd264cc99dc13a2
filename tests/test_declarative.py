"""Declarative .test-style cases (fullstack-test analog)."""

import os

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from tiflash_jax.testing.declarative import discover_cases, load_case, run_case

CASES_DIR = os.path.join(os.path.dirname(__file__), "cases")
CASES = list(discover_cases(CASES_DIR))


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:8]), ("d",))


@pytest.mark.parametrize("path", CASES, ids=[os.path.basename(p) for p in CASES])
def test_case(path, mesh):
    run_case(load_case(path), mesh=mesh)

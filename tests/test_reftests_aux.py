"""The reference's fault-inject/ and system-table/ fullstack corpora
(the last two directories beyond expr/, mpp/ and issues/): failpoint
fault injection with PAUSE/hang semantics through the engine's cancel
machinery, and the information_schema.tiflash_* views."""

import os

import pytest

CASES = [
    ("fault-inject/exception_after_read_from_storage.test", 3),
    ("fault-inject/mpp_hang.test", 2),
    ("system-table/read_system_table.test", 6),
]


@pytest.fixture(autouse=True)
def _clear_failpoints():
    yield
    from tiflash_jax.runtime.failpoint import FailPoint

    FailPoint.disable_all()


@pytest.mark.parametrize("rel,floor", CASES,
                         ids=[c[0] for c in CASES])
def test_aux_corpus_file(rel, floor):
    path = f"/root/reference/tests/fullstack-test/{rel}"
    if not os.path.exists(path):
        pytest.skip("reference corpus not present")
    from tiflash_jax.testing.reftest import run_test_file

    checked = run_test_file(path)
    assert checked >= floor, (rel, checked, floor)

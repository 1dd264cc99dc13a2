"""Run the reference's fullstack-test MPP corpus against the engine
(VERDICT r4 item 2 / SURVEY M7).

These are the distributed-operator composition tests — right/semi/
cartesian joins, rollup, window/window_agg/window_range_frame, runtime
filters, fault injection — executed by ``tiflash_jax.testing.reftest``
with expected outputs from the files themselves (TiDB's recorded
answers).  ``reftest_mpp_manifest.json`` mirrors the expr manifest:

- ``pass``: zero mismatches; the per-file ``checked`` floor can only
  grow (a regression fails CI)
- ``fail``: known gap — the file IS executed; a still-present mismatch
  xfails, a FIX fails loudly ("promote it"), and a new crash kind fails
  as a real regression
"""

import glob
import json
import os
import pathlib

import pytest

HERE = pathlib.Path(__file__).parent
CORPUS = "/root/reference/tests/fullstack-test/mpp"
MANIFEST = json.loads((HERE / "reftest_mpp_manifest.json").read_text())

FILES = sorted(os.path.basename(p) for p in glob.glob(f"{CORPUS}/*.test"))


@pytest.fixture(autouse=True)
def _clear_failpoints():
    yield
    from tiflash_jax.runtime.failpoint import FailPoint

    FailPoint.disable_all()  # fault-inject files arm by name


@pytest.mark.skipif(not os.path.isdir(CORPUS),
                    reason="reference corpus not present")
@pytest.mark.parametrize("fname", FILES)
def test_reference_mpp_file(fname):
    from tiflash_jax.testing.reftest import Unsupported, run_test_file

    entry = MANIFEST.get(fname, {"status": "pass"})
    status = entry["status"]
    if status == "fail":
        mode = entry.get("mode", "mismatch")
        try:
            checked = run_test_file(f"{CORPUS}/{fname}")
        except AssertionError:
            if mode != "mismatch":
                pytest.fail(f"{fname} failure changed {mode} -> mismatch:"
                            " update its recorded mode")
            pytest.xfail(f"known gap: {entry.get('reason', '')}")
        except Exception as e:
            got = f"crash:{type(e).__name__}"
            if mode != got:
                raise  # NEW crash kind — a real regression, surface it
            pytest.xfail(f"known gap ({got}): {entry.get('reason', '')}")
        pytest.fail(f"{fname} now passes ({checked} checked) — promote "
                    "it to pass in reftest_mpp_manifest.json")
    try:
        checked = run_test_file(f"{CORPUS}/{fname}")
    except Unsupported as e:
        assert status == "unsupported", f"{fname} newly unsupported: {e}"
        return
    floor = entry.get("checked", 1)
    assert checked >= floor, (
        f"{fname} verified {checked} queries, below its recorded floor "
        f"{floor} — coverage regressed")


def test_mpp_manifest_counts():
    """The MPP scoreboard can only improve."""
    from collections import Counter

    c = Counter(v["status"] for v in MANIFEST.values())
    assert c["pass"] >= 33, c
    assert c["fail"] <= 0, c
    total = sum(v.get("checked", 0) for v in MANIFEST.values()
                if v["status"] == "pass")
    assert total >= 358, total

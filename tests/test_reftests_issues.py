"""Run the reference's fullstack-test issues corpus (VERDICT r4 item 10)
— regression distillates (int/decimal edges, semi-join NULLs, collation
probes) with TiDB's recorded answers as the oracle.  Manifest mirrors
the expr/mpp ones: pass floors only grow; known fails xfail and must be
promoted when fixed.
"""

import glob
import json
import os
import pathlib

import pytest

HERE = pathlib.Path(__file__).parent
CORPUS = "/root/reference/tests/fullstack-test/issues"
MANIFEST = json.loads((HERE / "reftest_issues_manifest.json").read_text())

FILES = sorted(os.path.basename(p) for p in glob.glob(f"{CORPUS}/*.test"))


@pytest.fixture(autouse=True)
def _clear_failpoints():
    yield
    from tiflash_jax.runtime.failpoint import FailPoint

    FailPoint.disable_all()


@pytest.mark.skipif(not os.path.isdir(CORPUS),
                    reason="reference corpus not present")
@pytest.mark.parametrize("fname", FILES)
def test_reference_issue_file(fname):
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
                raise
            pytest.xfail(f"known gap ({got}): {entry.get('reason', '')}")
        pytest.fail(f"{fname} now passes ({checked} checked) — promote "
                    "it in reftest_issues_manifest.json")
    try:
        checked = run_test_file(f"{CORPUS}/{fname}")
    except Unsupported as e:
        assert status == "unsupported", f"{fname} newly unsupported: {e}"
        return
    floor = entry.get("checked", 1)
    assert checked >= floor, (
        f"{fname} verified {checked} queries, below its recorded floor "
        f"{floor} — coverage regressed")


def test_issues_manifest_counts():
    from collections import Counter

    c = Counter(v["status"] for v in MANIFEST.values())
    assert c["pass"] >= 18, c
    assert c["fail"] <= 3, c

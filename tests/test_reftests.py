"""Run the reference's fullstack-test expression corpus against the
engine (VERDICT r2 item 4 / SURVEY M7).

Each ``/root/reference/tests/fullstack-test/expr/*.test`` file is parsed
and executed by ``tiflash_jax.testing.reftest``; expected outputs come
from the files themselves (TiDB's recorded answers — the strongest
parity oracle available).  ``reftest_manifest.json`` records each file's
expected status:

- ``pass``: zero mismatches; the per-file ``checked`` floor (number of
  queries actually compared) can only grow (a regression fails CI)
- ``zero``: parses and runs, but every query exercises documented-
  unsupported surface (reasons recorded per statement)
- ``unsupported``: file-level gap (JSON column type, generated columns,
  ...) with the reason in the manifest
- ``fail``: known semantic gap — the file IS executed: a still-present
  mismatch xfails, a FIX fails loudly ("promote it"), and a CRASH
  (anything but a comparison mismatch) fails as a real regression
  (VERDICT r3: imperative pytest.xfail skipped execution entirely, so
  crashes in these files were invisible and fixes never surfaced)
"""

import glob
import json
import os
import pathlib

import pytest

HERE = pathlib.Path(__file__).parent
CORPUS = "/root/reference/tests/fullstack-test/expr"
MANIFEST = json.loads((HERE / "reftest_manifest.json").read_text())

FILES = sorted(os.path.basename(p) for p in glob.glob(f"{CORPUS}/*.test"))


@pytest.mark.skipif(not os.path.isdir(CORPUS),
                    reason="reference corpus not present")
@pytest.mark.parametrize("fname", FILES)
def test_reference_corpus_file(fname):
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
                    "it to pass in reftest_manifest.json")
    try:
        checked = run_test_file(f"{CORPUS}/{fname}")
    except Unsupported as e:
        assert status == "unsupported", (
            f"{fname} newly unsupported: {e}")
        return
    if status == "pass":
        floor = entry.get("checked", 1)
        assert checked >= floor, (
            f"{fname} verified {checked} queries, below its recorded "
            f"floor {floor} — coverage regressed")
    elif status == "zero":
        # all statements documented-unsupported — stays mismatch-free
        assert checked >= 0
    elif status == "unsupported":
        # previously file-level unsupported now runs: tighten manifest
        pytest.fail(f"{fname} now runs ({checked} checked) — promote it")


def test_manifest_counts():
    """The corpus scoreboard can only improve: fails/unsupported counts
    are ceilings, pass count is a floor."""
    from collections import Counter

    c = Counter(v["status"] for v in MANIFEST.values())
    assert c["pass"] >= 117, c
    assert c["zero"] <= 0, c
    assert c["fail"] <= 0, c
    assert c["unsupported"] <= 0, c

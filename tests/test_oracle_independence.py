"""Oracle independence lint (VERDICT r2 item 8).

The python oracle must share no computation code with the engine —
otherwise a semantics bug in a shared helper is invisible to every
parity test that exercises it.  The only allowed imports from the
engine package are AST *node type* modules (expr.nodes), which carry
no semantics.  Reference analog: the reference keeps its expected-
output machinery in TestUtils, fully separate from the Functions/
Interpreters implementation (dbms/src/TestUtils/ExecutorTestUtils.h:62).
"""

import ast
import pathlib

ORACLE_FILES = [
    pathlib.Path(__file__).resolve().parents[1]
    / "tiflash_jax" / "testing" / "oracle.py",
    pathlib.Path(__file__).resolve().parents[1]
    / "tiflash_jax" / "testing" / "plan_oracle.py",
]

# modules the oracle may import from the engine package: AST node type
# definitions only (no evaluation logic lives there)
ALLOWED_ENGINE_MODULES = {
    "expr.nodes", "plan.nodes", "core.dtypes", "ops.sort", "core.block",
    "plan",
}
# Modules where only specific names may be pulled: SortKey is a plan
# vocabulary dataclass; Block/Column/column_from_numpy are the data
# containers the oracle must consume/emit (marshalling, not semantics);
# from the plan package only the node-type module itself is allowed.
ALLOWED_NAMES_PER_MODULE = {
    "ops.sort": {"SortKey"},
    "core.block": {"Block", "Column", "column_from_numpy"},
    "plan": {"nodes"},
}

FORBIDDEN_PREFIXES = ("expr", "ops", "plan", "runtime", "exchange",
                      "storage", "mpp", "core", "bench")


def _engine_imports(path):
    tree = ast.parse(path.read_text())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            mod = node.module
            # relative imports: level=2 means ..expr.nodes etc.
            if node.level >= 2 or mod.startswith("tiflash_jax."):
                mod = mod.removeprefix("tiflash_jax.")
                out.append((mod, [a.name for a in node.names], node.lineno))
            elif node.level == 1 and mod.split(".")[0] in FORBIDDEN_PREFIXES:
                out.append((mod, [a.name for a in node.names], node.lineno))
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith("tiflash_jax."):
                    mod = a.name.removeprefix("tiflash_jax.")
                    out.append((mod, ["*"], node.lineno))
    return out


def test_oracle_imports_only_node_types():
    for path in ORACLE_FILES:
        for mod, names, lineno in _engine_imports(path):
            assert mod in ALLOWED_ENGINE_MODULES, (
                f"{path.name}:{lineno} imports engine module '{mod}' — "
                "the oracle must not share computation code with the engine"
            )
            allowed_names = ALLOWED_NAMES_PER_MODULE.get(mod)
            if allowed_names is not None:
                bad = set(names) - allowed_names
                assert not bad, (
                    f"{path.name}:{lineno} imports {sorted(bad)} from "
                    f"'{mod}' — only {sorted(allowed_names)} allowed"
                )


def test_oracle_substring_matches_mysql_semantics():
    from tiflash_jax.testing.oracle import _oracle_substring

    # MySQL manual examples + edge cases
    assert _oracle_substring("Quadratically", 5) == "ratically"
    assert _oracle_substring("foobarbar", 4) == "barbar"
    assert _oracle_substring("Quadratically", 5, 6) == "ratica"
    assert _oracle_substring("Sakila", -3) == "ila"
    assert _oracle_substring("Sakila", -5, 3) == "aki"
    assert _oracle_substring("Sakila", 0) == ""
    assert _oracle_substring("Sakila", 2, 0) == ""
    assert _oracle_substring("Sakila", 2, -1) == ""
    assert _oracle_substring("abc", -99) == ""
    assert _oracle_substring("abc", 99) == ""

"""Logical/physical plan IR.

Role analog: the ``tipb::ExecType`` executor-tree node set consumed by
``PhysicalPlan::build`` (``Flash/Planner/PhysicalPlan.cpp:103-250``) and the
``PhysicalXxx`` plan nodes in ``Flash/Planner/Plans/``.  One dataclass per
executor kind; the same tree drives the engine compiler
(plan/compiler.py), the Python oracle (testing), and fragment splitting at
exchange boundaries (mpp/).

Unlike the reference there is no stream/pipeline duality: a fragment
compiles to ONE jitted function (XLA is the scheduler), so the whole
PhysicalPlanNode::buildBlockInputStream/buildPipeline split collapses into
``compile_fragment``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from ..expr.nodes import Expr
from ..ops.aggregate import AggDesc
from ..ops.sort import SortKey
from ..ops.window import WindowDesc


class PlanNode:
    children: Tuple["PlanNode", ...] = ()

    def pretty(self, indent: int = 0) -> str:
        pad = "  " * indent
        head = f"{pad}{self.describe()}"
        note = getattr(self, "note", None)
        if note:
            head += f"  [{note}]"
        return "\n".join([head] + [c.pretty(indent + 1) for c in self.children])

    def describe(self) -> str:
        return type(self).__name__


@dataclasses.dataclass
class TableScan(PlanNode):
    """Leaf: reads a table shard from the catalog (the MockStorage /
    DeltaTree read analog; storage itself is a host-side table provider)."""

    table: str
    columns: Optional[Sequence[str]] = None
    children: Tuple[PlanNode, ...] = ()

    def describe(self):
        cols = "*" if self.columns is None else ",".join(self.columns)
        return f"TableScan({self.table}: {cols})"


@dataclasses.dataclass
class Selection(PlanNode):
    """Filter — stays lazy as a selection mask (tipb::Selection)."""

    cond: Expr
    child: PlanNode = None  # type: ignore[assignment]

    def __post_init__(self):
        self.children = (self.child,)

    def describe(self):
        return f"Selection({self.cond})"


@dataclasses.dataclass
class Projection(PlanNode):
    """Column computation / renaming (tipb::Projection)."""

    exprs: Dict[str, Expr]
    child: PlanNode = None  # type: ignore[assignment]

    def __post_init__(self):
        self.children = (self.child,)

    def describe(self):
        return f"Projection({', '.join(self.exprs)})"


@dataclasses.dataclass
class Aggregation(PlanNode):
    """Hash aggregation (tipb::Aggregation).  ``num_slots`` caps group
    capacity for the sort method (bounded-output contract)."""

    keys: Sequence[str]
    aggs: Sequence[AggDesc]
    child: PlanNode = None  # type: ignore[assignment]
    num_slots: Optional[int] = None
    # distributed mode tag filled by the planner: None | 'partial' | 'final'
    mode: Optional[str] = None

    def __post_init__(self):
        self.children = (self.child,)

    def describe(self):
        a = ", ".join(f"{x.func}({x.arg or '*'})->{x.name}" for x in self.aggs)
        m = f" [{self.mode}]" if self.mode else ""
        return f"Aggregation(keys={list(self.keys)}; {a}){m}"


@dataclasses.dataclass
class Join(PlanNode):
    """Hash join (tipb::Join).  children = (probe, build) — the reference
    splits PhysicalJoinBuild/Probe; here the compiler emits build+probe
    into one traced fn.  ``unique_build`` selects the 1:N fast path;
    ``output_capacity`` sizes the N:M expansion.

    ``rf_id``: when set, the build side executes first and publishes a
    min/max runtime filter under this id; a ``RuntimeFilterApply`` node
    with the same id inside the probe subtree narrows rows before they
    reach an exchange (reference ``DataStreams/RuntimeFilter.h:32``,
    ``Flash/Coprocessor/RuntimeFilterMgr.h:30``)."""

    kind: str
    probe_keys: Sequence[str]
    build_keys: Sequence[str]
    probe: PlanNode = None  # type: ignore[assignment]
    build: PlanNode = None  # type: ignore[assignment]
    unique_build: bool = False
    output_capacity: Optional[int] = None
    rf_id: Optional[str] = None
    # payload columns the join must emit from the build side; None =
    # all of them.  Set by the prune pass so unused build columns (e.g.
    # the duplicate join key) never pay the probe-time payload gather.
    build_payload: Optional[Sequence[str]] = None

    def __post_init__(self):
        self.children = (self.probe, self.build)

    def describe(self):
        return (
            f"Join({self.kind}; probe={list(self.probe_keys)} "
            f"build={list(self.build_keys)}"
            + (" unique" if self.unique_build else "")
            + ")"
        )


@dataclasses.dataclass
class TopN(PlanNode):
    sort_keys: Sequence[SortKey]
    limit: int
    child: PlanNode = None  # type: ignore[assignment]

    def __post_init__(self):
        self.children = (self.child,)

    def describe(self):
        ks = ", ".join(f"{k.name}{' desc' if k.desc else ''}" for k in self.sort_keys)
        return f"TopN({ks}; limit={self.limit})"


@dataclasses.dataclass
class Sort(PlanNode):
    sort_keys: Sequence[SortKey]
    child: PlanNode = None  # type: ignore[assignment]

    def __post_init__(self):
        self.children = (self.child,)

    def describe(self):
        ks = ", ".join(f"{k.name}{' desc' if k.desc else ''}" for k in self.sort_keys)
        return f"Sort({ks})"


@dataclasses.dataclass
class Limit(PlanNode):
    limit: int
    child: PlanNode = None  # type: ignore[assignment]

    def __post_init__(self):
        self.children = (self.child,)

    def describe(self):
        return f"Limit({self.limit})"


@dataclasses.dataclass
class Union(PlanNode):
    """Row concatenation of same-schema children (UNION ALL; also the
    PartitionTableScan analog — tipb::PartitionTableScan unions the
    partition scans, ``Flash/Planner/Plans/PhysicalTableScan.cpp``)."""

    inputs: Sequence[PlanNode] = ()

    def __post_init__(self):
        self.children = tuple(self.inputs)

    def describe(self):
        return f"Union({len(self.children)})"


def partition_table_scan(tables, columns=None) -> Union:
    """Scan a partitioned table: one TableScan per partition, unioned."""
    return Union([TableScan(t, columns) for t in tables])


@dataclasses.dataclass
class SkewShuffleJoin(PlanNode):
    """Skew-aware distributed join (SPMD only): sampled heavy hitters take
    a local-probe/broadcast-build path, the rest hash-shuffles
    (exchange/skew.py).  Children are raw (pre-exchange) subtrees."""

    kind: str
    probe_keys: Sequence[str]
    build_keys: Sequence[str]
    probe: PlanNode = None  # type: ignore[assignment]
    build: PlanNode = None  # type: ignore[assignment]
    output_capacity: Optional[int] = None
    hot_k: int = 128
    sample_per_device: int = 2048

    def __post_init__(self):
        self.children = (self.probe, self.build)

    def describe(self):
        return (
            f"SkewShuffleJoin({self.kind}; probe={list(self.probe_keys)} "
            f"build={list(self.build_keys)})"
        )


@dataclasses.dataclass
class RuntimeFilterApply(PlanNode):
    """Probe-side narrowing by a join-build runtime filter (min/max over
    the build join keys).  A no-op when the filter is not (yet)
    available — exactly the reference's timeout-wait degradation."""

    rf_id: str
    key_names: Sequence[str]
    child: PlanNode = None  # type: ignore[assignment]

    def __post_init__(self):
        self.children = (self.child,)

    def describe(self):
        return f"RuntimeFilterApply({self.rf_id}: {list(self.key_names)})"


@dataclasses.dataclass
class WithCTE(PlanNode):
    """CTE definitions materialized once and shared by every reference
    (reference: ``Operators/CTESinkOp/CTESourceOp`` + ``Flash/Mpp/CTEManager``
    with a shared partitioned buffer — here the 'buffer' is just the traced
    Block reused at every CTERef, so XLA sees one producer)."""

    defs: Dict[str, PlanNode]
    child: PlanNode = None  # type: ignore[assignment]

    def __post_init__(self):
        self.children = tuple(self.defs.values()) + (self.child,)

    def describe(self):
        return f"WithCTE({list(self.defs)})"


@dataclasses.dataclass
class CTERef(PlanNode):
    """Consumer of a named CTE (leaf)."""

    name: str
    children: Tuple[PlanNode, ...] = ()

    def describe(self):
        return f"CTERef({self.name})"


@dataclasses.dataclass
class AddColumns(PlanNode):
    """Append computed columns, keeping every existing column (a
    Projection that doesn't drop — used by the planner to materialize
    derived exchange keys like the window lane id)."""

    exprs: Dict[str, Expr]
    child: PlanNode = None  # type: ignore[assignment]

    def __post_init__(self):
        self.children = (self.child,)

    def describe(self):
        return f"AddColumns({', '.join(self.exprs)})"


@dataclasses.dataclass
class LanedWindow(PlanNode):
    """Window whose partitions are SPLIT into order-key-range lanes so
    low-cardinality (or empty) PARTITION BY still uses every device —
    the fine-grained-shuffle analog
    (``Flash/Mpp/FineGrainedShuffleWriter.cpp``,
    ``docs/design/2022-06-14-fine-grained-shuffle.md``).  The child is
    hash-exchanged on (partition keys + lane id column); each device
    computes lane-local windows, then a tiny psum'd carry table stitches
    lane boundaries (running aggs add carry-in; ranks offset by earlier-
    lane counts).  ``part_cap`` is the exact static partition-slot
    domain (dictionary size / int range span); ``n_lanes`` the lane
    count; ``lane_col`` the AddColumns-computed lane id."""

    partition_by: Sequence[str]
    order_by: Sequence[SortKey]
    funcs: Sequence["WindowDesc"]
    n_lanes: int = 8
    part_cap: int = 1
    lane_col: str = "__lane__"
    # per-lane head/tail boundary-table depth: covers lead/lag offsets,
    # nth_value n, and bounded ROWS frame widths (mpp/runner)
    boundary_depth: int = 1
    # per partition key: ("dict", span) or ("int", lo, span) — the exact
    # static slot domain the carry tables are sized to
    part_specs: Tuple = ()
    child: PlanNode = None  # type: ignore[assignment]

    def __post_init__(self):
        self.children = (self.child,)

    def describe(self):
        fs = ", ".join(f"{f.func}->{f.name}" for f in self.funcs)
        return (f"LanedWindow({fs}; lanes={self.n_lanes}"
                f" part_cap={self.part_cap})")


@dataclasses.dataclass
class Expand(PlanNode):
    """Grouping-sets replication (tipb::Expand/Expand2,
    ``Interpreters/Expand.h``): one copy of the input per grouping set with
    off-set keys NULLed and a groupingID column appended."""

    grouping_sets: Sequence[Sequence[str]]
    child: PlanNode = None  # type: ignore[assignment]
    gid_name: str = "groupingID"

    def __post_init__(self):
        self.children = (self.child,)

    def describe(self):
        return f"Expand({[list(s) for s in self.grouping_sets]})"


@dataclasses.dataclass
class CrossJoin(PlanNode):
    """Cartesian product (reference cross join, ``Join.cpp:1430``)."""

    probe: PlanNode = None  # type: ignore[assignment]
    build: PlanNode = None  # type: ignore[assignment]
    output_capacity: Optional[int] = None

    def __post_init__(self):
        self.children = (self.probe, self.build)

    def describe(self):
        return "CrossJoin"


@dataclasses.dataclass
class Window(PlanNode):
    """Window functions over (partition, order) (tipb::Window).  The
    reference always runs these behind a fine-grained shuffle; our
    distributed form is a hash exchange on partition keys first."""

    partition_by: Sequence[str]
    order_by: Sequence[SortKey]
    funcs: Sequence["WindowDesc"]  # ops.window.WindowDesc
    child: PlanNode = None  # type: ignore[assignment]

    def __post_init__(self):
        self.children = (self.child,)

    def describe(self):
        fs = ", ".join(f"{f.func}->{f.name}" for f in self.funcs)
        return f"Window(partition={list(self.partition_by)}; {fs})"


@dataclasses.dataclass
class ExchangeSender(PlanNode):
    """Fragment boundary, sender side (tipb::ExchangeSender).

    exchange_type: 'hash' (repartition by key — HashPartitionWriter),
    'broadcast' (BroadcastOrPassThroughWriter), 'passthrough' (gather to
    one consumer).  On a mesh this lowers to collectives under shard_map, not
    gRPC tunnels (SURVEY.md §5 mapping)."""

    exchange_type: str
    keys: Sequence[str] = ()
    child: PlanNode = None  # type: ignore[assignment]

    def __post_init__(self):
        self.children = (self.child,)

    def describe(self):
        k = f" keys={list(self.keys)}" if self.keys else ""
        return f"ExchangeSender({self.exchange_type}{k})"


@dataclasses.dataclass
class ExchangeReceiver(PlanNode):
    """Fragment boundary, receiver side (tipb::ExchangeReceiver)."""

    source: PlanNode = None  # type: ignore[assignment]  # the sender subtree

    def __post_init__(self):
        self.children = (self.source,)

    def describe(self):
        return "ExchangeReceiver"


__all__ = [
    "PlanNode",
    "TableScan",
    "Selection",
    "Projection",
    "Aggregation",
    "Join",
    "TopN",
    "Sort",
    "Limit",
    "Window",
    "Expand",
    "CrossJoin",
    "WithCTE",
    "CTERef",
    "RuntimeFilterApply",
    "SkewShuffleJoin",
    "Union",
    "partition_table_scan",
    "ExchangeSender",
    "ExchangeReceiver",
]

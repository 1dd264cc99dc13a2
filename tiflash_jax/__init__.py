"""tiflash-jax: a vectorized query-execution engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of TiFlash's
ClickHouse-derived execution layer (see SURVEY.md at the repo root):
columnar blocks as fixed-width device arrays, fused XLA expression
evaluation, direct/sort based hash aggregation, partitioned hash join,
radix sort / top-N, and an MPP-style distributed shuffle built on
``shard_map`` collectives instead of gRPC exchange.

Importing this package enables 64-bit JAX types: query engines need exact
int64/decimal semantics (TiDB keys and decimals are 64-bit), so x64 is a
hard requirement, not an option.
"""

import jax

jax.config.update("jax_enable_x64", True)

from .core.dtypes import (  # noqa: E402,F401
    DataType,
    Decimal,
    TypeKind,
    BOOL,
    DATE,
    DATETIME,
    FLOAT32,
    FLOAT64,
    INT8,
    INT16,
    INT32,
    INT64,
    STRING,
    UINT8,
    UINT32,
    UINT64,
)
from .core.block import Block, Column, column_from_numpy  # noqa: E402,F401

__version__ = "0.1.0"

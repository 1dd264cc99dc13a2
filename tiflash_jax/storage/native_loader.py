"""ctypes bindings for the native C++ columnar loader.

Role analog: the host-side table-read path (DMFileReader + IO parse
helpers) — see ``tiflash_jax/native/loader.cpp``.  Builds the shared
library on first use (g++ -O3, no external deps); falls back with a clear
error if no toolchain is present.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core import dtypes as dt
from ..core.block import Column
from .catalog import Catalog, column_from_arrays

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_SRC = os.path.join(_NATIVE_DIR, "loader.cpp")
_SO = os.path.join(_NATIVE_DIR, "libtflloader.so")

_lock = threading.Lock()
_lib = None

# type codes shared with loader.cpp
_T_INT64, _T_DECIMAL, _T_DATE, _T_FLOAT64, _T_STRING, _T_SKIP = range(6)


def _build() -> None:
    subprocess.run(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-std=c++17",
         "-pthread", _SRC, "-o", _SO],
        check=True, capture_output=True,
    )


def get_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            _build()
        lib = ctypes.CDLL(_SO)
        lib.tfl_parse_file.restype = ctypes.c_void_p
        lib.tfl_parse_file.argtypes = [
            ctypes.c_char_p, ctypes.c_char,
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int,
        ]
        lib.tfl_num_rows.restype = ctypes.c_int64
        lib.tfl_num_rows.argtypes = [ctypes.c_void_p]
        lib.tfl_copy_column.restype = ctypes.c_int64
        lib.tfl_copy_column.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.tfl_dict_size.restype = ctypes.c_int64
        lib.tfl_dict_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.tfl_copy_dict.restype = None
        lib.tfl_copy_dict.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p]
        lib.tfl_free.argtypes = [ctypes.c_void_p]
        lib.tfl_save_cache.restype = ctypes.c_int
        lib.tfl_save_cache.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.tfl_load_cache.restype = ctypes.c_void_p
        lib.tfl_load_cache.argtypes = [ctypes.c_char_p]
        _lib = lib
        return lib


def _type_code(t: dt.DataType) -> Tuple[int, int]:
    if t.is_decimal:
        return _T_DECIMAL, t.scale
    if t.kind is dt.TypeKind.DATE:
        return _T_DATE, 0
    if t.is_float:
        return _T_FLOAT64, 0
    if t.is_string:
        return _T_STRING, 0
    if t.is_integer:
        return _T_INT64, 0
    raise TypeError(f"native loader: unsupported type {t}")


def _extract_columns(lib, h, schema: Sequence[Tuple[str, dt.DataType]], n: int) -> Dict[str, Column]:
    cols: Dict[str, Column] = {}
    for i, (name, t) in enumerate(schema):
        if t is None:
            continue
        code, _ = _type_code(t)
        if code in (_T_INT64, _T_DECIMAL):
            buf = np.empty(n, dtype=np.int64)
        elif code == _T_DATE:
            buf = np.empty(n, dtype=np.int32)
        elif code == _T_FLOAT64:
            buf = np.empty(n, dtype=np.float64)
        else:
            buf = np.empty(n, dtype=np.int32)
        got = lib.tfl_copy_column(h, i, buf.ctypes.data_as(ctypes.c_void_p))
        assert got == n, (name, got, n)
        if code == _T_STRING:
            db = lib.tfl_dict_size(h, i)
            raw = ctypes.create_string_buffer(db)
            lib.tfl_copy_dict(h, i, raw)
            blob = raw.raw.decode("utf-8")
            dictionary = tuple(blob.split("\n")[:-1]) if blob else ()
            cols[name] = column_from_arrays(buf, t, dictionary=dictionary or ("",))
        else:
            if t.is_integer and t.physical != np.dtype(np.int64):
                buf = buf.astype(t.physical)
            cols[name] = column_from_arrays(buf, t)
    return cols


def load_table(
    path: str,
    schema: Sequence[Tuple[str, Optional[dt.DataType]]],
    delim: str = "|",
    nthreads: int = 0,
    cache: Optional[str] = None,
) -> Dict[str, Column]:
    """Parse a delimited file (or its binary cache) into device columns.

    ``schema``: ordered (name, dtype) per file field; dtype None skips the
    field.  ``cache``: path of the TFC1 binary cache — loaded if present,
    written after parse otherwise."""
    lib = get_lib()
    h = None
    if cache and os.path.exists(cache):
        h = lib.tfl_load_cache(cache.encode())
    if not h:
        types = (ctypes.c_int * len(schema))(
            *[(_type_code(t)[0] if t is not None else _T_SKIP) for _, t in schema]
        )
        scales = (ctypes.c_int * len(schema))(
            *[(_type_code(t)[1] if t is not None else 0) for _, t in schema]
        )
        h = lib.tfl_parse_file(path.encode(), delim.encode(), types, scales,
                               len(schema), nthreads)
        if not h:
            raise IOError(f"native loader failed to parse {path}")
        if cache:
            lib.tfl_save_cache(h, cache.encode())
    try:
        n = lib.tfl_num_rows(h)
        return _extract_columns(lib, h, schema, n)
    finally:
        lib.tfl_free(h)


def save_table(path: str, columns: Dict[str, "Column"]) -> List[str]:
    """Persist engine columns (host-synced) to a TFC1 file.

    Returns the column-name order written (TFC stores no names; pair with
    a schema when reloading via ``load_cached_table``).  The
    checkpoint-file analog: query results / staged tables round-trip
    through the native format."""
    lib = get_lib()
    lib.tfl_table_create.restype = ctypes.c_void_p
    lib.tfl_table_create.argtypes = [ctypes.c_int64]
    lib.tfl_table_add_column.restype = ctypes.c_int
    lib.tfl_table_add_column.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_char_p, ctypes.c_int64,
    ]
    first = next(iter(columns.values()))
    rows = int(first.data.shape[0])
    h = lib.tfl_table_create(rows)
    names = []
    try:
        for name, col in columns.items():
            code, scale = _type_code(col.dtype)
            if code == _T_STRING:
                data = np.ascontiguousarray(np.asarray(col.data), dtype=np.int32)
                blob = ("\n".join(col.dictionary or ()) + "\n").encode() if col.dictionary else b""
                rc = lib.tfl_table_add_column(
                    h, code, scale, data.ctypes.data_as(ctypes.c_void_p),
                    blob, len(blob),
                )
            else:
                phys = {_T_INT64: np.int64, _T_DECIMAL: np.int64,
                        _T_DATE: np.int32, _T_FLOAT64: np.float64}[code]
                data = np.ascontiguousarray(np.asarray(col.data), dtype=phys)
                rc = lib.tfl_table_add_column(
                    h, code, scale, data.ctypes.data_as(ctypes.c_void_p), b"", 0
                )
            assert rc == 0, name
            names.append(name)
        rc = lib.tfl_save_cache(h, path.encode())
        assert rc == 0, path
    finally:
        lib.tfl_free(h)
    return names


def load_cached_table(
    path: str, schema: Sequence[Tuple[str, dt.DataType]]
) -> Dict[str, "Column"]:
    """Load a TFC1 file produced by save_table (schema supplies names)."""
    lib = get_lib()
    h = lib.tfl_load_cache(path.encode())
    if not h:
        raise IOError(f"cannot load TFC cache {path}")
    try:
        n = lib.tfl_num_rows(h)
        return _extract_columns(lib, h, list(schema), n)
    finally:
        lib.tfl_free(h)


TPCH_SCHEMAS: Dict[str, List[Tuple[str, Optional[dt.DataType]]]] = {
    "lineitem": [
        ("l_orderkey", dt.INT64), ("l_partkey", dt.INT64),
        ("l_suppkey", dt.INT64), ("l_linenumber", dt.INT64),
        ("l_quantity", dt.Decimal(15, 2)), ("l_extendedprice", dt.Decimal(15, 2)),
        ("l_discount", dt.Decimal(15, 2)), ("l_tax", dt.Decimal(15, 2)),
        ("l_returnflag", dt.STRING), ("l_linestatus", dt.STRING),
        ("l_shipdate", dt.DATE), ("l_commitdate", dt.DATE),
        ("l_receiptdate", dt.DATE), ("l_shipinstruct", dt.STRING),
        ("l_shipmode", dt.STRING), ("l_comment", None),
    ],
    "orders": [
        ("o_orderkey", dt.INT64), ("o_custkey", dt.INT64),
        ("o_orderstatus", dt.STRING), ("o_totalprice", dt.Decimal(15, 2)),
        ("o_orderdate", dt.DATE), ("o_orderpriority", dt.STRING),
        ("o_clerk", None), ("o_shippriority", dt.INT64), ("o_comment", None),
    ],
    "customer": [
        ("c_custkey", dt.INT64), ("c_name", None), ("c_address", None),
        ("c_nationkey", dt.INT64), ("c_phone", None),
        ("c_acctbal", dt.Decimal(15, 2)), ("c_mktsegment", dt.STRING),
        ("c_comment", None),
    ],
}


def load_tpch_dir(dirpath: str, tables: Sequence[str], use_cache: bool = True,
                  nthreads: int = 0) -> Catalog:
    """Load dbgen .tbl files from a directory into a Catalog.

    ``nthreads``: parser thread count (0 = hardware concurrency) — the
    ``max_threads`` setting (Settings.h:64) routes here."""
    cat = Catalog()
    for t in tables:
        path = os.path.join(dirpath, t + ".tbl")
        cache = path + ".tfc" if use_cache else None
        cols = load_table(path, TPCH_SCHEMAS[t], cache=cache,
                          nthreads=nthreads)
        cat.register(t, cols)
    return cat


__all__ = ["load_table", "load_tpch_dir", "get_lib", "TPCH_SCHEMAS"]

"""csv_simd_tpu: a CSV structural-indexing framework on an accelerator.

Built from scratch in JAX with the capabilities of the Rust reference
(EdmundsEcho/csv-simd, a simdjson-stage1-derived CSV indexer; see SURVEY.md).
The pipeline: raw CSV bytes -> byte classification -> quote-state masking via
prefix-XOR parity -> structural-offset tape -> O(1) record/field serving,
scaled over device meshes with collective-stitched shard boundary state.

Public API (idiomatic re-exposure of the reference surface, lib.rs:21-45):

    create(path)            -> Tape       (reference: lib.rs:61 `create`)
    Tape                                  (reference: tape.rs:74)
    Header                                (reference: tape.rs:217)
    RecordSource mixin / seek_record / seek_field
                                          (reference: record_source.rs:68)
    StructureIndex                        (reference: stage1.rs:61)
    boundaries / Boundary / Chunk         (reference: tape.rs:281-428)
    StructureError hierarchy              (reference: error.rs:9)
"""

from .config import Dialect, build_nibble_luts, CODE_NEWLINE, CODE_DELIM
from .config import CODE_SPACE, CODE_ESCAPE, CODE_QUOTE, CODE_STRUCTURAL
from .errors import (
    StructureError,
    IoError,
    MissingValue,
    InvalidState,
    InvalidCsvFormat,
)
from .tape import Header, Tape, NewLine, Boundary, Chunk, boundaries
from .api import create, create_from_bytes, create_packed
from .decode import DecodedView, decode_field, decode_str
from .device_tape import DeviceTape
from .streaming import (
    StreamingIndexBuilder,
    build_index_streaming,
    create_streaming,
)
from .artifact import load_tape, save_tape
from .corpus_api import CorpusTape, CsvCorpus
from .offsetfree import PackedDeviceTape
from .frame import Col, Frame, infer_schema, read_typed, write_csv
from .join import join_records, join_typed
from .sql import SqlError, SqlResult, sql
from .sql import explain as explain_sql
from .query import (
    Stats,
    column_quantiles,
    column_stats,
    describe,
    distinct,
    group_aggregate,
    groupby_typed,
    order_records,
    select_records,
    value_counts,
)

__all__ = [
    "PackedDeviceTape",
    "Dialect",
    "build_nibble_luts",
    "CODE_NEWLINE",
    "CODE_DELIM",
    "CODE_SPACE",
    "CODE_ESCAPE",
    "CODE_QUOTE",
    "CODE_STRUCTURAL",
    "StructureError",
    "IoError",
    "MissingValue",
    "InvalidState",
    "InvalidCsvFormat",
    "Header",
    "Tape",
    "NewLine",
    "Boundary",
    "Chunk",
    "boundaries",
    "create",
    "create_from_bytes",
    "create_packed",
    "DecodedView",
    "decode_field",
    "decode_str",
    "DeviceTape",
    "StreamingIndexBuilder",
    "build_index_streaming",
    "create_streaming",
    "load_tape",
    "save_tape",
    "CsvCorpus",
    "CorpusTape",
    "Col",
    "Frame",
    "infer_schema",
    "read_typed",
    "write_csv",
    "Stats",
    "column_quantiles",
    "column_stats",
    "describe",
    "distinct",
    "group_aggregate",
    "groupby_typed",
    "join_records",
    "join_typed",
    "order_records",
    "select_records",
    "value_counts",
    "sql",
    "explain_sql",
    "SqlResult",
    "SqlError",
]

__version__ = "0.1.0"

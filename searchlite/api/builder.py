"""IndexBuilder: fluent index creation (parity: `api/builder.rs`)."""

from __future__ import annotations

from typing import Optional

from searchlite.api.types import IndexOptions
from searchlite.index import Index
from searchlite.index.manifest import Schema


class IndexBuilder:
    def __init__(self, options: IndexOptions):
        self.options = options
        self._schema: Optional[Schema] = None

    def with_schema(self, schema) -> "IndexBuilder":
        if isinstance(schema, dict):
            schema = Schema.from_json(schema)
        self._schema = schema
        return self

    def create(self) -> Index:
        return Index.create(self.options, self._schema)

    def open_or_create(self) -> Index:
        opts = self.options
        opts.create_if_missing = True
        return Index.open(opts, self._schema)

    def open(self) -> Index:
        return Index.open(self.options, self._schema)

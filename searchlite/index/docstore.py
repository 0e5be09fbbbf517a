"""Document store: stored JSON per document.

Parity with searchlite-core `index/docstore.rs`: per-doc record is a
u32 LE length + JSON bytes, with optional per-segment compression and a
32 MiB per-document cap in both directions. Codecs: ``zstd`` (the
reference's codec, via the bundled ``zstandard`` module) and ``zlib``
(stdlib fallback, and the codec of segments written by earlier builds
whose meta says ``compress: true``). The codec is recorded in the
segment meta; opening a segment whose codec isn't available fails
loudly rather than decoding garbage (reference behavior for non-zstd
builds, `index/segment.rs:1242-1247`).
"""

from __future__ import annotations

import json
import zlib
from typing import Any, BinaryIO, Optional

from searchlite.errors import StorageError

MAX_DOCSTORE_BYTES = 32 * 1024 * 1024

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover - zstandard is bundled
    _zstd = None


def resolve_codec(compress) -> Optional[str]:
    """Normalize a compress flag (False/True/"zlib"/"zstd") to a codec
    name or None. True prefers zstd (reference parity) and falls back
    to zlib when the module is missing."""
    if not compress:
        return None
    if compress is True:
        return "zstd" if _zstd is not None else "zlib"
    if compress in ("zlib", "zstd"):
        if compress == "zstd" and _zstd is None:
            raise StorageError(
                "docstore codec `zstd` requested but the zstandard "
                "module is unavailable")
        return compress
    raise StorageError(f"unknown docstore codec `{compress}`")


def _compress(codec: Optional[str], data: bytes) -> bytes:
    if codec is None:
        return data
    if codec == "zstd":
        return _zstd.ZstdCompressor().compress(data)
    return zlib.compress(data)


def _decompress(codec: Optional[str], data: bytes) -> bytes:
    if codec is None:
        return data
    try:
        if codec == "zstd":
            if _zstd is None:
                raise StorageError(
                    "segment uses the zstd docstore codec but the "
                    "zstandard module is unavailable")
            return _zstd.ZstdDecompressor().decompress(
                data, max_output_size=MAX_DOCSTORE_BYTES)
        return zlib.decompress(data)
    except StorageError:
        raise
    except Exception as e:  # zlib.error / zstd.ZstdError
        raise StorageError(f"corrupt docstore: {e}") from e


class DocStoreWriter:
    _BUF_FLUSH = 1 << 20

    def __init__(self, fileobj: BinaryIO, compress=False):
        self._file = fileobj
        self.codec = resolve_codec(compress)
        self._offsets: list[int] = []
        self._pos = 0
        self._buf = bytearray()  # records buffered per ~1 MiB write

    _EMPTY = b"{}"

    def add_document(self, doc: dict) -> None:
        # schemas with no stored fields write one constant record per
        # doc — skip the per-doc json/compress work (hot at ingest)
        if not doc:
            data = self._empty_record()
        else:
            data = json.dumps(doc, separators=(",", ":"),
                              ensure_ascii=False).encode()
            data = _compress(self.codec, data)
        if len(data) > MAX_DOCSTORE_BYTES:
            raise StorageError(
                f"document of {len(data)} bytes exceeds docstore cap")
        self._offsets.append(self._pos)
        buf = self._buf
        buf += len(data).to_bytes(4, "little")
        buf += data
        self._pos += 4 + len(data)
        if len(buf) >= self._BUF_FLUSH:
            self.flush()

    def add_empty_documents(self, n: int) -> None:
        """Bulk form for schemas with no stored fields: n constant
        empty records, offsets computed arithmetically, one buffered
        write path (the columnar ingest fast path)."""
        if n <= 0:
            return
        record = self._empty_record()
        blob = len(record).to_bytes(4, "little") + record
        step = len(blob)
        start = self._pos
        self._offsets.extend(range(start, start + n * step, step))
        self._pos += n * step
        self.flush()  # keep byte order with any per-doc records
        per = max(1, self._BUF_FLUSH // step)
        full, rem = divmod(n, per)
        chunk = blob * per
        for _ in range(full):
            self._file.write(chunk)
        if rem:
            self._file.write(blob * rem)

    def flush(self) -> None:
        """Write buffered records; MUST be called before the backing
        file is closed."""
        if self._buf:
            self._file.write(bytes(self._buf))
            self._buf.clear()

    def _empty_record(self) -> bytes:
        cached = getattr(self, "_empty_cache", None)
        if cached is None:
            cached = _compress(self.codec, self._EMPTY)
            self._empty_cache = cached
        return cached

    @property
    def offsets(self) -> list[int]:
        return self._offsets


class DocStoreReader:
    def __init__(self, data: bytes, offsets: list[int], compress=False):
        self._data = data
        self._offsets = offsets
        # old segments wrote a bare boolean meaning zlib
        self._codec = "zlib" if compress is True else \
            resolve_codec(compress)

    def get(self, ordinal: int) -> dict[str, Any]:
        if ordinal < 0 or ordinal >= len(self._offsets):
            raise StorageError(f"doc ordinal {ordinal} out of range")
        off = self._offsets[ordinal]
        if off + 4 > len(self._data):
            raise StorageError("corrupt docstore: truncated header")
        length = int.from_bytes(self._data[off:off + 4], "little")
        if length > MAX_DOCSTORE_BYTES:
            raise StorageError("corrupt docstore: record exceeds cap")
        end = off + 4 + length
        if end > len(self._data):
            raise StorageError("corrupt docstore: truncated record")
        payload = _decompress(self._codec, self._data[off + 4:end])
        try:
            return json.loads(payload)
        except json.JSONDecodeError as e:
            raise StorageError(f"corrupt docstore: {e}") from e

    def __len__(self) -> int:
        return len(self._offsets)

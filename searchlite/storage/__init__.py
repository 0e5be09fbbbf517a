"""Storage abstraction: all file I/O for an index goes through a Storage.

Behavioral parity with the reference's ``trait Storage`` (searchlite-core
`storage/mod.rs:28-147`): open/read/write/append/atomic_write/remove over
relative paths inside one index directory, with an in-memory variant for
ephemeral indexes and tests. ``atomic_write`` is the durability anchor —
write temp file, fsync, rename, fsync parent dir — used for manifest
commits.
"""

from __future__ import annotations

import io
import os
import threading
from abc import ABC, abstractmethod
from typing import BinaryIO

from searchlite.errors import StorageError


class Storage(ABC):
    """File-system-like interface over an index directory."""

    @abstractmethod
    def open_read(self, path: str) -> BinaryIO: ...

    @abstractmethod
    def open_write(self, path: str) -> BinaryIO: ...

    @abstractmethod
    def open_append(self, path: str) -> BinaryIO: ...

    @abstractmethod
    def read_to_end(self, path: str) -> bytes: ...

    @abstractmethod
    def write_all(self, path: str, data: bytes) -> None: ...

    @abstractmethod
    def atomic_write(self, path: str, data: bytes) -> None: ...

    @abstractmethod
    def remove(self, path: str) -> None: ...

    @abstractmethod
    def exists(self, path: str) -> bool: ...

    @abstractmethod
    def list_files(self) -> list[str]: ...

    def append_all(self, path: str, data: bytes) -> None:
        """Append + flush in one call (amortized for memory storage)."""
        with self.open_append(path) as f:
            f.write(data)
            f.flush()

    def remove_if_exists(self, path: str) -> None:
        if self.exists(path):
            self.remove(path)


class FsStorage(Storage):
    """Filesystem-backed storage rooted at an index directory."""

    def __init__(self, root: str, create: bool = False):
        self.root = os.path.abspath(root)
        if create:
            os.makedirs(self.root, exist_ok=True)
        if not os.path.isdir(self.root):
            raise StorageError(f"index directory does not exist: {self.root}")

    def _full(self, path: str) -> str:
        full = os.path.join(self.root, path)
        parent = os.path.dirname(full)
        if parent and not os.path.isdir(parent):
            os.makedirs(parent, exist_ok=True)
        return full

    def open_read(self, path: str) -> BinaryIO:
        try:
            return open(self._full(path), "rb")
        except FileNotFoundError as e:
            raise StorageError(f"file not found: {path}") from e

    def open_write(self, path: str) -> BinaryIO:
        return open(self._full(path), "wb")

    def open_append(self, path: str) -> BinaryIO:
        return open(self._full(path), "ab")

    def read_to_end(self, path: str) -> bytes:
        with self.open_read(path) as f:
            return f.read()

    def write_all(self, path: str, data: bytes) -> None:
        with self.open_write(path) as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())

    def atomic_write(self, path: str, data: bytes) -> None:
        # temp file + fsync + rename + fsync(dir), mirroring the
        # reference's atomic manifest store (`storage/mod.rs:104-117`).
        full = self._full(path)
        tmp = full + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, full)
        dir_fd = os.open(os.path.dirname(full) or ".", os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)

    def remove(self, path: str) -> None:
        full = os.path.join(self.root, path)
        try:
            os.remove(full)
        except FileNotFoundError as e:
            raise StorageError(f"file not found: {path}") from e

    def exists(self, path: str) -> bool:
        return os.path.exists(os.path.join(self.root, path))

    def list_files(self) -> list[str]:
        out = []
        for dirpath, _dirnames, filenames in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            for name in filenames:
                out.append(name if rel == "." else os.path.join(rel, name))
        return sorted(out)


class _MemFile(io.BytesIO):
    """BytesIO that flushes its contents back to the owning store on close."""

    def __init__(self, store: "InMemoryStorage", path: str, initial: bytes = b"",
                 append: bool = False):
        super().__init__()
        self._store = store
        self._path = path
        if initial:
            self.write(initial)
            if not append:
                self.seek(0)

    def close(self) -> None:
        self._store._files[self._path] = self.getvalue()
        super().close()

    def __exit__(self, *exc) -> None:
        self.close()


class InMemoryStorage(Storage):
    """RAM-backed storage for ephemeral indexes and tests
    (parity with `storage/mod.rs:149-310`)."""

    def __init__(self):
        self._files: dict[str, bytes] = {}
        self._lock = threading.Lock()

    def open_read(self, path: str) -> BinaryIO:
        with self._lock:
            if path not in self._files:
                raise StorageError(f"file not found: {path}")
            return io.BytesIO(self._files[path])

    def open_write(self, path: str) -> BinaryIO:
        return _MemFile(self, path)

    def open_append(self, path: str) -> BinaryIO:
        with self._lock:
            existing = self._files.get(path, b"")
        return _MemFile(self, path, existing, append=True)

    def write_all(self, path: str, data: bytes) -> None:
        with self._lock:
            self._files[path] = bytes(data)

    def atomic_write(self, path: str, data: bytes) -> None:
        self.write_all(path, data)

    def remove(self, path: str) -> None:
        with self._lock:
            if path not in self._files:
                raise StorageError(f"file not found: {path}")
            del self._files[path]

    def exists(self, path: str) -> bool:
        with self._lock:
            return path in self._files

    def append_all(self, path: str, data: bytes) -> None:
        with self._lock:
            existing = self._files.get(path)
            if existing is None:
                self._files[path] = bytes(data)
            else:
                # bytearray-backed accumulation keeps appends amortized O(1)
                if not isinstance(existing, bytearray):
                    existing = bytearray(existing)
                existing += data
                self._files[path] = existing

    def read_to_end(self, path: str) -> bytes:
        with self._lock:
            if path not in self._files:
                raise StorageError(f"file not found: {path}")
            return bytes(self._files[path])

    def list_files(self) -> list[str]:
        with self._lock:
            return sorted(self._files)

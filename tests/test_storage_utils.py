"""Storage + varint/checksum utility tests."""

import pytest

from searchlite.errors import StorageError
from searchlite.storage import FsStorage, InMemoryStorage
from searchlite.utils import varint
from searchlite.utils.checksum import crc32


class TestVarint:
    @pytest.mark.parametrize("value", [0, 1, 127, 128, 300, 2**32 - 1, 2**63])
    def test_roundtrip(self, value):
        encoded = varint.encode_u64(value)
        decoded, offset = varint.decode_u64(encoded)
        assert decoded == value
        assert offset == len(encoded)

    def test_truncated_raises(self):
        encoded = varint.encode_u64(300)
        with pytest.raises(ValueError):
            varint.decode_u64(encoded[:1])

    def test_known_encodings(self):
        assert varint.encode_u64(0) == b"\x00"
        assert varint.encode_u64(127) == b"\x7f"
        assert varint.encode_u64(128) == b"\x80\x01"


def test_crc32_known_value():
    # Standard IEEE CRC32 test vector.
    assert crc32(b"123456789") == 0xCBF43926


@pytest.fixture(params=["fs", "mem"])
def storage(request, tmp_path):
    if request.param == "fs":
        return FsStorage(str(tmp_path / "idx"), create=True)
    return InMemoryStorage()


class TestStorage:
    def test_write_read_roundtrip(self, storage):
        storage.write_all("a.bin", b"hello")
        assert storage.read_to_end("a.bin") == b"hello"
        assert storage.exists("a.bin")

    def test_atomic_write(self, storage):
        storage.atomic_write("MANIFEST.json", b"{}")
        assert storage.read_to_end("MANIFEST.json") == b"{}"
        storage.atomic_write("MANIFEST.json", b'{"v":2}')
        assert storage.read_to_end("MANIFEST.json") == b'{"v":2}'

    def test_append(self, storage):
        with storage.open_append("wal.log") as f:
            f.write(b"one")
        with storage.open_append("wal.log") as f:
            f.write(b"two")
        assert storage.read_to_end("wal.log") == b"onetwo"

    def test_remove(self, storage):
        storage.write_all("x", b"1")
        storage.remove("x")
        assert not storage.exists("x")
        with pytest.raises(StorageError):
            storage.remove("x")

    def test_missing_read_raises(self, storage):
        with pytest.raises(StorageError):
            storage.read_to_end("nope")

    def test_list_files(self, storage):
        storage.write_all("b", b"")
        storage.write_all("a", b"")
        assert storage.list_files() == ["a", "b"]

    def test_nested_paths(self, storage):
        storage.write_all("seg_1_vectors/embedding.bin", b"v")
        assert storage.read_to_end("seg_1_vectors/embedding.bin") == b"v"

"""The port's container and CMM against the reference's.

Bytes written by one package parse in the other (v1 and v2), the same
content serialises to the same bytes, and the corruption cases of
``test_conformance.py`` raise the port's ``ContainerError``.  Tolerance: none
— every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import api as japi
from repro.core import container as jcont
from repro.core import context as jctx
from repro_torch.core import container as tcont
from repro_torch.core import context as tctx

torch.set_num_threads(2)


def _sample_arrays() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(3)
    return {
        "payload": rng.integers(0, 2**32, size=(7, 5), dtype=np.uint32),
        "emax": rng.integers(-200, 200, size=(7,), dtype=np.int32),
        "values": rng.normal(size=(3, 4)).astype(np.float32),
        "scalar": np.asarray(np.int64(9)),
    }


def _sample_meta() -> dict:
    return {"shape": (3, 4), "dtype": "float32", "rate": np.int64(12),
            "scale": np.float64(0.5), "stages": [{"stage": "s", "kind": "device"}]}


def _huffman_container(version: int = 2) -> bytes:
    """The corruption tier's sample stream, written by the reference."""
    rng = np.random.default_rng(7)
    keys = np.minimum(np.abs(rng.normal(0, 9, 4096)).astype(np.int32), 50)
    return japi.compress(jnp.asarray(keys), "huffman").to_bytes(version=version)


def _same(a, b) -> None:
    assert a.method == b.method
    assert a.meta == b.meta
    assert sorted(a.arrays) == sorted(b.arrays)
    for k in a.arrays:
        assert a.arrays[k].dtype == b.arrays[k].dtype
        np.testing.assert_array_equal(a.arrays[k], b.arrays[k])


@pytest.mark.parametrize("version", [1, 2])
def test_same_content_same_bytes(version):
    j = jcont.Compressed("zfp", _sample_meta(), _sample_arrays())
    t = tcont.Compressed("zfp", _sample_meta(), _sample_arrays())
    assert t.to_bytes(version=version) == j.to_bytes(version=version)
    assert t.nbytes() == j.nbytes()


@pytest.mark.parametrize("version", [1, 2])
@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_cross_parse(version, writer):
    src, dst = (jcont, tcont) if writer == "repro" else (tcont, jcont)
    blob = src.Compressed("zfp", _sample_meta(), _sample_arrays()).to_bytes(version=version)
    _same(dst.Compressed.from_bytes(blob), src.Compressed.from_bytes(blob))


@pytest.mark.parametrize("version", [1, 2])
def test_reference_codec_stream_parses_in_port(version):
    blob = _huffman_container(version)
    _same(tcont.Compressed.from_bytes(blob), jcont.Compressed.from_bytes(blob))
    assert tcont.Compressed.from_bytes(blob).to_bytes(version=version) == blob


@pytest.mark.parametrize("version", [1, 2])
def test_truncated_streams_raise(version):
    blob = _huffman_container(version)
    for cut in (2, 10, 30, len(blob) // 2, len(blob) - 1):
        with pytest.raises(tcont.ContainerError):
            tcont.Compressed.from_bytes(blob[:cut])


@pytest.mark.parametrize("kind", ["bytes", "view of bytes", "bytearray", "view of bytearray"])
def test_parsed_arrays_never_change_with_the_buffer(kind):
    """``from_bytes`` parses ``bytes`` (or a view of them) in place and any
    other buffer from a copy, so a buffer written after the parse (a reused
    receive buffer) never changes the arrays; either way they are read-only,
    as the reference's ``np.frombuffer`` arrays are, and equal its parse."""
    raw = tcont.Compressed("zfp", _sample_meta(), _sample_arrays()).to_bytes()
    buf = bytearray(b"\xff" * 8 + raw)
    src = {"bytes": bytes(buf), "bytearray": buf}[kind.split()[-1]]
    got = tcont.Compressed.from_bytes(memoryview(src)[8:] if kind.startswith("view") else
                                      src[8:] if kind == "bytes" else buf[8:])
    buf[:] = bytes(len(buf))
    _same(got, jcont.Compressed.from_bytes(raw))
    assert not any(a.flags.writeable for a in got.arrays.values())


def test_unknown_version_raises():
    blob = _huffman_container()
    bad = blob[:4] + np.uint32(9).tobytes() + blob[8:]
    with pytest.raises(tcont.ContainerError, match="version"):
        tcont.Compressed.from_bytes(bad)
    with pytest.raises(tcont.ContainerError):
        tcont.Compressed.from_bytes(b"NOPE" + blob[4:])


def test_payload_bitflip_fails_crc():
    flipped = bytearray(_huffman_container())
    flipped[-20] ^= 0x40
    with pytest.raises(tcont.ContainerError, match="crc32"):
        tcont.Compressed.from_bytes(bytes(flipped))


def test_header_bitflip_raises_cleanly():
    flipped = bytearray(_huffman_container())
    flipped[20] ^= 0xFF
    with pytest.raises(tcont.ContainerError):
        tcont.Compressed.from_bytes(bytes(flipped))


def test_container_error_is_value_error():
    assert issubclass(tcont.ContainerError, ValueError)


def test_partial_reads_match_reference():
    blob = tcont.Compressed("zfp", _sample_meta(), _sample_arrays()).to_bytes()
    assert tcont.peek_header(blob) == jcont.peek_header(blob)
    for name in _sample_arrays():
        assert tcont.read_section_bytes(blob, name) == jcont.read_section_bytes(blob, name)
        np.testing.assert_array_equal(
            tcont.read_section(blob, name), jcont.read_section(blob, name)
        )
    flipped = bytearray(blob)
    flipped[-3] ^= 0x01  # inside the last section ("values")
    with pytest.raises(tcont.ContainerError, match="values"):
        tcont.read_section_bytes(bytes(flipped), "values")
    with pytest.raises(tcont.ContainerError, match="no section"):
        tcont.read_section(blob, "missing")
    with pytest.raises(tcont.ContainerError, match="partial reads need v2"):
        tcont.peek_header(tcont.Compressed("zfp", {}, _sample_arrays()).to_bytes(version=1))


def test_crc32_helpers_match_reference():
    data = bytes(range(256)) * 3
    assert tcont.crc32_of(data) == jcont.crc32_of(data)
    tcont.check_crc32(data, jcont.crc32_of(data), "probe")
    with pytest.raises(tcont.ContainerError, match="probe"):
        tcont.check_crc32(data, jcont.crc32_of(data) ^ 1, "probe")


def test_context_key_matches_reference():
    args = ("zfp", (3, 4), np.dtype("float32"))
    kw = {"rate": 16, "backend": "cuda"}
    assert tctx.context_key(*args, **kw) == jctx.context_key(*args, **kw)


def test_context_cache_hits_and_lru():
    cache = tctx.ContextCache(capacity=2)
    built = []

    def builder(tag):
        def make():
            built.append(tag)
            return tctx.ReductionContext(key=None, plan=tag,
                                         buffers={"t": torch.zeros(4)})
        return make

    assert cache.get_or_create("a", builder("a")).plan == "a"
    assert cache.get_or_create("a", builder("a2")).plan == "a"  # hit
    cache.get_or_create("b", builder("b"))
    cache.get_or_create("c", builder("c"))                     # evicts "a"
    assert built == ["a", "b", "c"]
    assert "a" not in cache and "c" in cache
    stats = cache.stats()
    assert (stats["hits"], stats["misses"], stats["evictions"]) == (1, 3, 1)
    assert stats["bytes"] == 2 * 16  # torch tensors' nbytes are counted


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "uint16", "int8", "bool"])
def test_ratio_matches_reference_for_every_dtype(dtype):
    """The original size counts the recorded dtype's width; numpy knows
    bfloat16 only through ml_dtypes, which the port does not import."""
    meta = dict(_sample_meta(), dtype=dtype)
    j = jcont.Compressed("zfp", meta, _sample_arrays())
    t = tcont.Compressed.from_bytes(j.to_bytes())
    assert t.ratio() == j.ratio()

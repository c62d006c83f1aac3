"""The parse's shared Huffman tables (``tables.dht_huffman_table``): each
distinct DHT table is derived once and shared, read-only, by later parses;
every field equals the JAX package's derivation, for the Annex K tables and
others; a corrupt DHT raises on every parse and leaves nothing behind; more
distinct tables than the cache keeps still parse to equal tables; and
streams of different tables, decoded in turn, give the JAX decoder's
pixels."""
import dataclasses
import itertools
import sys
import threading

import numpy as np
import pytest

from conftest import make_test_rgb

import gpujpeg_tpu as ref
import gpujpeg_tpu_torch as port
import gpujpeg_tpu_torch.models.decoder as dmod
import gpujpeg_tpu_torch.models.encoder as encoder_mod
from gpujpeg_tpu.tables import build_huffman_table as ref_build
from gpujpeg_tpu_torch import tables
from gpujpeg_tpu_torch.ops.entropy import envelope_huffman_spec
from gpujpeg_tpu_torch.stream import reader
from gpujpeg_tpu_torch.stream.reader import JpegParseError, read_image
from gpujpeg_tpu_torch.types import ComponentType, HuffmanType

H, W = 48, 64
FIELDS = [f.name for f in dataclasses.fields(tables.HuffmanTable)]
ANNEX_K = [(ct, ht) for ct in (ComponentType.LUMINANCE,
                               ComponentType.CHROMINANCE)
           for ht in (HuffmanType.DC, HuffmanType.AC)]


@pytest.fixture(autouse=True)
def empty_cache():
    tables.clear_dht_tables()
    yield
    tables.clear_dht_tables()


def _stream(huff_spec=None, sub: int = 420) -> bytes:
    """A golden-coded stream, with the Annex K tables or ``huff_spec``'s
    (bits, values) per (component type, Huffman type)."""
    params = port.Parameters(quality=75, restart_interval=2)
    params = params.with_chroma_subsampling(sub) if sub != 444 else params
    with pytest.MonkeyPatch.context() as mp:
        if huff_spec is not None:
            mp.setattr(encoder_mod, "encode_tables", lambda q: (
                tables.encode_tables(q)[0], {
                    key: tables.build_huffman_table(*bv)
                    for key, bv in huff_spec.items()}))
        return port.Encoder(backend="golden").encode(
            make_test_rgb(H, W).reshape(-1), params,
            port.ImageParameters(width=W, height=H))


def _dht(tc_th: int, bits, values) -> bytes:
    return bytes([tc_th, *bits, *values])


def _assert_equals_reference(table, bits, values):
    want = ref_build(bits, values)
    for name in FIELDS:
        got, exp = getattr(table, name), getattr(want, name)
        assert got.dtype == exp.dtype, name
        np.testing.assert_array_equal(got, exp, err_msg=name)


def test_two_parses_share_the_tables():
    data = _stream()
    first, second = read_image(data), read_image(data)
    assert (first.tables_fresh, second.tables_fresh) == (4, 0)
    assert sorted(first.huffman_tables) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for key, table in first.huffman_tables.items():
        assert second.huffman_tables[key] is table


#: (bits, values) of the Annex K tables, the envelope's two AC tables with
#: the ZRL on a 16-bit code, and two more: every code 8 bits long, and one
#: code of each length 1..15 with two of length 16 (the longest codes)
TABLES = [
    *[(tables.DEFAULT_HUFFMAN_BITS[k], tables.DEFAULT_HUFFMAN_VALUES[k])
      for k in ANNEX_K],
    *[envelope_huffman_spec(True)[ct, HuffmanType.AC]
      for ct in (ComponentType.LUMINANCE, ComponentType.CHROMINANCE)],
    ([0] * 7 + [255] + [0] * 8, list(range(255))),
    ([1] * 15 + [2], list(range(100, 117))),
]


@pytest.mark.parametrize("case", range(len(TABLES)))
def test_parsed_table_equals_the_reference(case):
    bits, values = TABLES[case]
    info = reader.JpegInfo()
    reader._parse_dht(info, _dht(0x13, bits, values))
    assert info.tables_fresh == 1
    _assert_equals_reference(info.huffman_tables[(1, 3)], bits, values)


def test_shared_tables_are_read_only():
    info = read_image(_stream())
    for table in info.huffman_tables.values():
        for name in FIELDS:
            arr = getattr(table, name)
            assert not arr.flags.writeable, name
            with pytest.raises(ValueError):
                arr[0] = 1


#: corrupt DHT payloads: a bad Tc, a bad Th, a bits array cut short, 257
#: values declared, and fewer values than declared
CORRUPT = [
    bytes([0x20]) + bytes(16),
    bytes([0x04]) + bytes(16),
    bytes([0x00, 1, 2, 3]),
    bytes([0x10]) + bytes([0] * 7 + [200, 57] + [0] * 7) + bytes(257),
    bytes([0x10]) + bytes([0, 2] + [0] * 14) + bytes([1]),
]


@pytest.mark.parametrize("case", range(len(CORRUPT)))
def test_corrupt_dht_raises_on_every_parse(case):
    for _ in range(2):
        with pytest.raises(JpegParseError):
            reader._parse_dht(reader.JpegInfo(), CORRUPT[case])
    assert not tables._dht_tables


def test_corrupt_dht_in_a_stream_raises_on_every_parse():
    data = bytearray(_stream())
    at = data.find(b"\xff\xc4") + 4        # the first DHT's Tc/Th
    data[at + 1:at + 17] = bytes([0] * 7 + [200, 57] + [0] * 7)
    for _ in range(2):
        with pytest.raises(JpegParseError, match="corrupt DHT"):
            read_image(bytes(data))


def test_more_tables_than_the_cache_keeps():
    """Distinct DC tables (one Annex K bits array, its values permuted),
    more than the cache keeps, parsed twice over in turn: each parse
    equals the reference, the cache stays at its bound, and the ones it
    dropped are derived again."""
    bits = tables.DEFAULT_HUFFMAN_BITS[ComponentType.LUMINANCE,
                                       HuffmanType.DC]
    perms = list(itertools.islice(itertools.permutations(range(12)),
                                  tables.DHT_TABLES + 8))
    for turn in range(2):
        for values in perms:
            info = reader.JpegInfo()
            reader._parse_dht(info, _dht(0x01, bits, values))
            assert info.tables_fresh == 1, turn
            _assert_equals_reference(info.huffman_tables[(0, 1)], bits,
                                     values)
        assert len(tables._dht_tables) == tables.DHT_TABLES


def test_threads_share_the_cache():
    """Threads parse more distinct tables than the cache keeps, at once,
    switching often: every parse gives the reference's table and the cache
    stays at its bound."""
    bits = tables.DEFAULT_HUFFMAN_BITS[ComponentType.CHROMINANCE,
                                       HuffmanType.DC]
    perms = list(itertools.islice(itertools.permutations(range(12)),
                                  tables.DHT_TABLES + 8))
    want = {values: ref_build(bits, values).lut16 for values in perms}
    bad = []

    def work(k):
        for values in perms[k:] + perms[:k]:
            info = reader.JpegInfo()
            reader._parse_dht(info, _dht(0x00, bits, values))
            if not np.array_equal(info.huffman_tables[0, 0].lut16,
                                  want[values]):
                bad.append(values)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(5 * k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert bad == []
    assert len(tables._dht_tables) == tables.DHT_TABLES


#: every Annex K table's values reversed: the commonest symbols take the
#: longest codes
REVERSED = {k: (tables.DEFAULT_HUFFMAN_BITS[k],
                tables.DEFAULT_HUFFMAN_VALUES[k][::-1]) for k in ANNEX_K}


@pytest.mark.parametrize("route", ["golden", "device"])
def test_streams_of_other_tables_decode_in_turn(monkeypatch, route):
    """Streams of the Annex K tables, of the envelope's (the ZRL on a
    16-bit code) and of :data:`REVERSED`, decoded in turn twice over on
    the host decoder or on the device route's plain versions, give the
    JAX host decoder's pixels."""
    monkeypatch.setattr(dmod, "CPU_SEGMENT_THRESHOLD",
                        10 ** 9 if route == "golden" else 0)
    streams = [_stream(), _stream(envelope_huffman_spec(True)),
               _stream(REVERSED), _stream(REVERSED, sub=444)]
    # the envelope shares Annex K's DC tables; the 4:4:4 stream shares all
    assert [read_image(d).tables_fresh for d in streams] == [4, 2, 4, 0]
    want = [np.asarray(ref.Decoder(backend="golden").decode(d)[0])
            for d in streams]
    dec = port.Decoder(backend="torch", device="cpu")
    for _ in range(2):
        for data, expect in zip(streams, want):
            assert read_image(data).tables_fresh == 0
            np.testing.assert_array_equal(dec.decode(data)[0], expect)

"""D1's first-level table and its corrupt-stream envelope.

``decode.wide_quick_tables`` gives the kernel its lookahead table. Over
every 16-bit peek, a hit there followed by the reference's maxcode
compares on a miss (the kernel's lookup) must give the reference
lookup's (symbol, length): K2's ``lookup_sym`` on the JAX package's own
``build_dec_tables_v2``, and for the codes that exist the T.81 F.16
serial decode of the JAX package's Huffman table. Then the plain D1 on
``decode.envelope_rows`` (random words, all ones, all zeros, blocks that
end where k + run passes 63, long codes, rows cut short) against the JAX
package's K4 ``run_raw`` in interpret mode."""
import numpy as np
import pytest
import torch

from gpujpeg_tpu.ops.pallas_decode import DecTables as RefDecTables
from gpujpeg_tpu.ops.pallas_decode import build_dec_tables_v2 as ref_dec
from gpujpeg_tpu.tables import build_huffman_table as ref_huffman_table
from gpujpeg_tpu_torch.ops import decode, entropy
from gpujpeg_tpu_torch.types import ComponentType, HuffmanType

PEEKS = np.arange(1 << 16)


def _specs(case: str) -> list:
    """(bits, values) of the case's tables, DC ones first."""
    if case == "partial":
        # 1 + 2 + 4 codes of lengths 2, 9 and 16 leave most of the code
        # space invalid
        bits = [0, 1, 0, 0, 0, 0, 0, 0, 2, 0, 0, 0, 0, 0, 0, 4]
        return [(bits, [0x00, 0x01, 0xF0, 0x11, 0x22, 0x33, 0xFA])]
    spec = entropy.envelope_huffman_spec(case == "zrl16")
    return [spec[ct, ht] for ht in (HuffmanType.DC, HuffmanType.AC)
            for ct in (ComponentType.LUMINANCE, ComponentType.CHROMINANCE)]


def _k2_lookup(t: RefDecTables, peek: np.ndarray):
    """K2's ``lookup_sym`` (pallas_decode_v3.py:267) on the reference's
    tables, one slot and peek at a time."""
    quick, maxcode, delta, huffval = (np.asarray(a).tolist() for a in (
        t.quick, t.maxcode, t.delta, t.huffval))
    sym = np.empty((len(quick), peek.size), np.int64)
    ln = np.empty_like(sym)
    for s in range(len(quick)):
        mc = maxcode[s][9:17]
        for i, p in enumerate(peek.tolist()):
            q = quick[s][p >> 8]
            if q & 31:
                sym[s, i], ln[s, i] = q >> 5, q & 31
                continue
            n = 9 + sum(p >= m for m in mc)
            if n == 17:
                sym[s, i], ln[s, i] = 0, 1
                continue
            v = min(max((p >> (16 - n)) + delta[s][n], 0), 255)
            sym[s, i], ln[s, i] = huffval[s][v], n
    return sym, ln


def _serial_decode(bits, values, peek: int):
    """T.81 F.16 on the JAX package's Huffman table: (symbol, length) of
    the code at the top of ``peek``, or None for an invalid code."""
    tab = ref_huffman_table(bits, values)
    for n in range(1, 17):
        code = peek >> (16 - n)
        if tab.maxcode[n] >= 0 and code <= tab.maxcode[n]:
            return int(tab.values[tab.valptr[n] + code - tab.mincode[n]]), n
    return None


def _kernel_lookup(dec, wide, bits, peek):
    """D1's lookup: the ``bits``-bit table, else the maxcode compares."""
    q = wide[:, peek >> (16 - bits)].astype(np.int64)
    ref_sym, ref_ln = decode.reference_lookup(dec, peek)
    hit = (q & 31) > 0
    # the slow path is the reference's compare formula without its quick
    # table; a miss in ``wide`` is a miss in ``quick`` (checked below)
    assert not ((dec.quick[:, peek >> 8] & 31) > 0)[~hit].any()
    return np.where(hit, q >> 5, ref_sym), np.where(hit, q & 31, ref_ln)


@pytest.mark.parametrize("bits", (8, 10, decode.WIDE_BITS))
@pytest.mark.parametrize("case", ("annex_k", "zrl16", "partial"))
def test_wide_table_is_the_reference_lookup(case, bits):
    specs = _specs(case)
    ref = ref_dec([ref_huffman_table(*s) for s in specs])
    dec = decode.build_dec_tables_v2(
        [ref_huffman_table(*s) for s in specs])
    wide = decode.wide_quick_tables(dec, bits)
    assert wide.shape == (len(specs), 1 << bits) and wide.dtype == np.int32
    got_sym, got_ln = _kernel_lookup(dec, wide, bits, PEEKS)
    # K2's formula, every peek (the quick table's and the long codes' all
    # at the prefixes' edges, a sample of the rest)
    sample = np.unique(np.concatenate([
        np.arange(0, 1 << 16, 97), np.arange(0xFF00, 1 << 16),
        np.arange(0, 1 << 16, 1 << (16 - bits))]))
    want_sym, want_ln = _k2_lookup(ref, sample)
    np.testing.assert_array_equal(got_sym[:, sample], want_sym)
    np.testing.assert_array_equal(got_ln[:, sample], want_ln)
    # every peek: the port's vectorised reference lookup, and the serial
    # decode where the code exists
    ref_sym, ref_ln = decode.reference_lookup(dec, PEEKS)
    np.testing.assert_array_equal(got_sym, ref_sym)
    np.testing.assert_array_equal(got_ln, ref_ln)
    for s, spec in enumerate(specs):
        for p in sample:
            code = _serial_decode(*spec, int(p))
            assert (int(got_sym[s, p]), int(got_ln[s, p])) == \
                (code if code is not None else (0, 1))
    if case == "partial":
        assert (got_ln[0] == 1).sum() > (1 << 14)   # invalid codes hit


@pytest.mark.parametrize("case", ("annex_k", "zrl16", "partial"))
def test_wide_table_is_k2_on_every_peek(case):
    """Over all 65,536 peeks, D1's lookup (the wide table, else the maxcode
    compares) is K2's ``lookup_sym`` on the JAX package's own tables."""
    specs = _specs(case)
    ref = ref_dec([ref_huffman_table(*s) for s in specs])
    dec = decode.build_dec_tables_v2(
        [ref_huffman_table(*s) for s in specs])
    got_sym, got_ln = _kernel_lookup(dec, decode.wide_quick_tables(dec),
                                     decode.WIDE_BITS, PEEKS)
    want_sym, want_ln = _k2_lookup(ref, PEEKS)
    np.testing.assert_array_equal(got_sym, want_sym)
    np.testing.assert_array_equal(got_ln, want_ln)


def test_wide_table_entries_are_whole_codes():
    """An entry is the (symbol, length) of a code of at most ``bits``
    bits, equal for all peeks of its prefix; 0 where no such code is."""
    dec = decode.build_dec_tables_v2(
        [ref_huffman_table(*s) for s in _specs("zrl16")])
    wide = decode.wide_quick_tables(dec)
    sym, ln = decode.reference_lookup(dec, PEEKS)
    bits = decode.WIDE_BITS
    for s in range(wide.shape[0]):
        for prefix in range(0, 1 << bits, 7):
            e = int(wide[s, prefix])
            lo = prefix << (16 - bits)
            span = slice(lo, lo + (1 << (16 - bits)))
            if e:
                assert (e & 31) <= bits
                assert (sym[s, span] == e >> 5).all()
                assert (ln[s, span] == e & 31).all()
            else:
                assert (ln[s, span] > bits).any() or \
                    len(set(zip(sym[s, span], ln[s, span]))) > 1


@pytest.fixture
def interpret(monkeypatch):
    """The JAX package's Pallas kernels in interpret mode."""
    monkeypatch.setenv("GPUJPEG_TPU_PALLAS_INTERPRET", "1")


def test_plain_d1_on_the_envelope_matches_pallas_k4(interpret):
    import jax.numpy as jnp
    from gpujpeg_tpu.ops.pallas_decode_v3 import make_decode_kernel_v3
    blocks, wcap, S = 2, 8, 128
    rows, start, count, comp, dec, dcs, acs = decode.envelope_rows(
        np.random.default_rng(29), True, n_seg=S, blocks=blocks, wcap=wcap)
    T = torch.from_numpy
    got = decode.huffman_decode_plain(
        T(rows), T(start), T(count), T(comp), *(T(a) for a in (
            decode.wide_quick_tables(dec), dec.maxcode, dec.delta,
            dec.huffval, dcs, acs)))

    spec = entropy.envelope_huffman_spec(True)
    ref = ref_dec([ref_huffman_table(*spec[ct, ht])
                   for ht in (HuffmanType.DC, HuffmanType.AC)
                   for ct in (ComponentType.LUMINANCE,
                              ComponentType.CHROMINANCE)])
    for name in ("quick", "maxcode", "delta", "huffval"):
        np.testing.assert_array_equal(getattr(ref, name), getattr(dec, name))
    run = make_decode_kernel_v3(S, blocks, wcap, 4,
                                np.full(blocks, -1, np.int32))
    seg_comp = (np.arange(S, dtype=np.int32) % 2).reshape(S // 128, 128)
    seg_nblk = np.full((S // 128, 128), blocks, np.int32)
    want = np.asarray(run(jnp.asarray(np.ascontiguousarray(rows.T)),
                          jnp.asarray(seg_comp), jnp.asarray(seg_nblk), ref,
                          dcs, acs))
    np.testing.assert_array_equal(got.numpy(), want)
    # the envelope reaches what it is for: invalid codes, the k + run > 63
    # ends, codes longer than the first-level table, and reads past wcap
    assert (got.numpy() != 0).any()
    assert (rows[1::5] == -1).all() and (rows[2::5] == 0).all()


def test_d1_rejects_segments_that_do_not_cover_the_blocks():
    """The kernel writes only its segments' blocks (no memset), so a
    segment map must cover every block exactly once: ``check_cover``
    raises otherwise, and the decode context checks its plan's map on the
    host before it uploads it."""
    from types import SimpleNamespace
    from gpujpeg_tpu_torch.ops.pipeline import DecContext
    _, start, count, comp, _, _, _ = decode.envelope_rows(
        np.random.default_rng(3), n_seg=16)
    decode.check_cover(start, count, comp.size)
    decode.check_cover(start[::-1], count[::-1], comp.size)   # any order
    decode.check_cover(np.r_[start, 999], np.r_[count, 0], comp.size)
    decode.check_cover([], [], 0)
    one = np.arange(16) == 5
    for s, c in ((start, count - one),                  # a gap
                 (start, count + one),                  # an overlap
                 (start + 1, count),                    # past the end
                 (start - (np.arange(16) == 0), count), # before 0
                 (start, np.where(one, -4, count))):    # a negative count
        with pytest.raises(ValueError, match="cover"):
            decode.check_cover(s, c, comp.size)
        plan = SimpleNamespace(seg_block_start=s, seg_block_count=c,
                               block_comp=comp)
        with pytest.raises(ValueError, match="cover"):
            DecContext(plan, None, None, torch.device("cpu"))

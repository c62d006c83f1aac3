"""Plain E3 (``entropy.merge_stuff_plain``) against the JAX package's golden
bit writer (``golden.BitWriter``) on the envelope that the warp-per-segment
kernel (``csrc/merge_stuff.cu``) must cover (``entropy.envelope_segments``):
segments of 1 to 100 blocks, across warp rounds of 32; blocks of 1 to
1,792 bits; all-ones strings that stuff every byte and fill a row to its
worst case; bit totals with and without padding; markers cycling
0xD0..0xD7 and a last segment without one."""
import numpy as np
import pytest
import torch

from gpujpeg_tpu.ops.golden import BitWriter
from gpujpeg_tpu_torch.ops import entropy
from gpujpeg_tpu_torch.ops.entropy import (
    BLOCK_CAP_BYTES, ENVELOPE_BLOCK_BITS, ENVELOPE_SEG_BLOCKS,
    envelope_segments)


def _strings(words: np.ndarray, bits: np.ndarray):
    """Each block's string as (value, length), from its row's first
    ceil(bits / 32) words."""
    out = []
    for w, n in zip(words.astype(np.uint32), bits.tolist()):
        nw = -(-n // 32)
        acc = 0
        for x in w[:nw]:
            acc = (acc << 32) | int(x)
        out.append((acc >> (32 * nw - n), n))
    return out


def _golden_segments(env):
    """Per segment: the golden writer's bytes (every block's string put,
    flushed, then the marker), raw bits and stuffed 0xFF count."""
    words, bits, start, count, rst, has_rst, _ = env
    strings = _strings(words, bits)
    out = []
    for s in range(start.size):
        bw = BitWriter()
        for val, n in strings[start[s]:start[s] + count[s]]:
            bw.put(val, n)
        body = bw.flush()
        n_ff = body.count(b"\xff\x00")
        if has_rst[s]:
            body += bytes([0xFF, int(rst[s])])
        out.append((body, int(bits[start[s]:start[s] + count[s]].sum()),
                    n_ff))
    return out


@pytest.mark.parametrize("seed", [8, 9])
def test_plain_e3_matches_golden_bit_writer(seed):
    env = envelope_segments(np.random.default_rng(seed))
    words, bits, start, count, rst, has_rst, cap_out = env
    out, out_len, seg_bits, n_ff = entropy.merge_stuff(
        *(torch.from_numpy(a) for a in env[:6]), cap_out)
    expect = _golden_segments(env)
    got = [(bytes(out[s, :out_len[s]].numpy()), int(seg_bits[s]),
            int(n_ff[s])) for s in range(start.size)]
    assert got == expect

    # the envelope's own claims
    assert set(count.tolist()) >= set(ENVELOPE_SEG_BLOCKS)
    assert set(bits.tolist()) == set(ENVELOPE_BLOCK_BITS)
    assert count.max() > 32 and (count > 64).any()
    totals = [e[1] for e in expect]
    assert any(t % 8 == 0 for t in totals) and any(t % 8 for t in totals)
    assert rst.tolist() == [0xD0 + s % 8 for s in range(start.size)]
    assert has_rst[:-1].all() and not has_rst[-1]
    # two adjacent segments stuff every byte and fill their rows to the
    # worst case the row capacity is sized for
    worst = 2 * int(count.max()) * BLOCK_CAP_BYTES + 2
    full = [s for s in range(start.size) if int(out_len[s]) == worst]
    assert len(full) == 2 and full[1] == full[0] + 1
    assert all(int(n_ff[s]) == int(count.max()) * BLOCK_CAP_BYTES
               for s in full)
    assert cap_out == entropy.segment_out_capacity(int(count.max()))
    assert worst <= cap_out < worst + 16

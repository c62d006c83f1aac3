"""Plain E2 (``entropy.huffman_blocks_plain``) against the JAX package's
golden block coder (``golden.encode_block``) on the envelope that the
warp-per-block kernel (``csrc/huffman_blocks.cu``) must cover: zero runs
of 15, 16, 17, 31, 32, 48 and 62 before a nonzero coefficient, a lone
nonzero coefficient 63 (no EOB), all-zero AC (DC and EOB only), |v| up
to 1023 and 2047, DC differences of +-2047; with the Annex K tables and
with tables whose ZRL and longest AC codes are 16 bits."""
import numpy as np
import pytest
import torch

from gpujpeg_tpu.ops import golden as ref_golden
from gpujpeg_tpu.tables import build_huffman_table as ref_build_huffman_table
from gpujpeg_tpu_torch.ops import entropy
from gpujpeg_tpu_torch.ops.entropy import (
    ENVELOPE_RUNS, envelope_blocks, envelope_huffman_spec)
from gpujpeg_tpu_torch.tables import build_huffman_table
from gpujpeg_tpu_torch.types import ComponentType, HuffmanType


class BitRecorder:
    """``golden.encode_block``'s bit writer without byte stuffing: the
    block's string as one integer and its length."""

    def __init__(self):
        self.acc = 0
        self.n = 0

    def put(self, code: int, length: int) -> None:
        if length:
            self.acc = (self.acc << length) | (code & ((1 << length) - 1))
            self.n += length


def _golden_strings(blocks, dc_table, ac_table):
    pred, out = 0, []
    for b in blocks:
        rec = BitRecorder()
        pred = ref_golden.encode_block(rec, b, pred, dc_table, ac_table)
        out.append((rec.acc, rec.n))
    return out


def _plain_strings(words: torch.Tensor, bits: torch.Tensor):
    out = []
    for w, n in zip(words.numpy().astype(np.uint32), bits.tolist()):
        nw = -(-n // 32)
        acc = 0
        for x in w[:nw]:
            acc = (acc << 32) | int(x)
        out.append((acc >> (32 * nw - n), n))
    return out


@pytest.mark.parametrize("zrl16", [False, True])
@pytest.mark.parametrize("ct", [ComponentType.LUMINANCE,
                                ComponentType.CHROMINANCE])
def test_plain_e2_matches_golden_block_coder(zrl16, ct):
    spec = envelope_huffman_spec(zrl16)
    huff = {k: build_huffman_table(*v) for k, v in spec.items()}
    ac = huff[(ct, HuffmanType.AC)]
    if zrl16:
        assert ac.ehufsi[0xF0] == 16 and ac.ehufsi.max() == 16
    blocks = envelope_blocks(np.random.default_rng(6))
    n = blocks.shape[0]
    packed = entropy.build_packed_tables(huff)
    words, bits = entropy.huffman_blocks_plain(
        torch.from_numpy(blocks),
        torch.arange(-1, n - 1, dtype=torch.int32),     # one DC chain
        torch.full((n,), int(ct), dtype=torch.int32),
        torch.from_numpy(packed.ac512), torch.from_numpy(packed.dc64))
    ref = {k: ref_build_huffman_table(*v) for k, v in spec.items()}
    expect = _golden_strings(blocks, ref[(ct, HuffmanType.DC)],
                             ref[(ct, HuffmanType.AC)])
    assert _plain_strings(words, bits) == expect
    # the envelope's own claims: runs over 15 cost ZRLs, 63 ends without
    # an EOB, an all-zero AC block is its DC chunk and the EOB
    eob = int(ac.ehufsi[0x00])
    dc = huff[(ct, HuffmanType.DC)]
    all_zero = 3 * len(ENVELOPE_RUNS) + 1
    assert expect[all_zero][1] == int(dc.ehufsi[11]) + 11 + eob

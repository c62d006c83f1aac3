"""The plain reference against the program's CPU route and its golden
coder, at small sizes: the same tables and geometry, streams that the
program decodes to the reference's pixels, and the program's streams
judged within the limits."""
import numpy as np
import pytest
import torch

from portbench import frames, judge, spec
from portbench.program import Program
from portbench.reference import codec, geometry, tables

CELLS = ["still8k.host", "video_hd.device"]


def setup(small_root, name):
    cell = spec.load_cell(name, small_root)
    cfg = cell.config
    geo = geometry.make_geometry(cfg["width"], cfg["height"],
                                 cfg["sampling"], cfg["interleaved"],
                                 cfg["restart_interval"])
    return cell, cfg, geo, judge.Deployment(cfg, geo)


def test_tables_equal_the_programs():
    from gpujpeg_tpu_torch import tables as pt
    from gpujpeg_tpu_torch.types import ComponentType, HuffmanType
    for cls in (0, 1):
        for kind in (0, 1):
            h = pt.default_huffman_table(ComponentType(kind),
                                         HuffmanType(cls))
            bits, values, code_of, len_of = tables.default_huffman(cls, kind)
            assert list(h.values) == list(values)
            assert (h.ehufco == code_of).all() and (h.ehufsi == len_of).all()
            assert (h.lut16 == tables.huffman_lut16(bits, values)).all()
    for q in (1, 50, 75, 100):
        for kind in (0, 1):
            assert (pt.quant_table_zz(ComponentType(kind), q)
                    == tables.quant_table_zz(kind, q)).all()
    M, bias = pt.fdct_quant_matrix(pt.quant_table_zz(0, 75))
    M2, bias2 = tables.fdct_operator(tables.quant_table_zz(0, 75))
    assert np.allclose(M, M2, atol=1e-15) and np.allclose(bias, bias2)


@pytest.mark.parametrize("name", CELLS)
def test_geometry_equals_the_programs_plan(small_root, name):
    from portbench.program import Program
    cell, cfg, geo, _ = setup(small_root, name)
    from gpujpeg_tpu_torch.plan import make_plan
    prog = Program(cfg, cell.traffic, "cpu", False)
    plan = make_plan(prog.params, prog.image)
    assert (plan.block_plane_idx == geo.block_plane_idx).all()
    assert (plan.block_comp == geo.block_comp).all()
    assert (plan.dc_pred_idx == geo.dc_pred).all()
    assert (plan.seg_block_start == geo.seg_start).all()
    assert (plan.seg_block_count == geo.seg_count).all()


@pytest.mark.parametrize("name", CELLS)
def test_golden_coder_reads_exact(small_root, name):
    """The program's golden (float64) coder and the reference agree
    exactly: its streams miss by 0, its decode of the reference's
    streams by 0."""
    from gpujpeg_tpu_torch.models.decoder import Decoder
    from gpujpeg_tpu_torch.models.encoder import Encoder
    cell, cfg, geo, dep = setup(small_root, name)
    prog = Program(cfg, cell.traffic, "cpu", False)
    pool = frames.make_pool(cfg, 2 ** 33 + 5, "cpu")
    enc = Encoder(backend="golden")
    streams = [(i, enc.encode(f.numpy(), prog.params, prog.image))
               for i, f in enumerate(pool)]
    frames_of = dict(enumerate(pool))
    assert judge.worst_miss(dep, streams, frames_of, "cpu") == 0.0
    dec = Decoder(backend="golden")
    dec.set_output_format(prog.decoder.output_color_space,
                          prog.decoder.output_format)
    outs = [(i, dec.decode(dep.stream(f))[0]) for i, f in enumerate(pool)]
    assert judge.decode_miss(dep, outs, frames_of, "cpu") == 0.0
    # the reference decodes its own streams to its coefficients
    for i, f in enumerate(pool):
        coeff, quant = dep.decode([dep.stream(f)], "cpu")[0]
        want = codec.coefficients(dep.planes(f), geo, dep.quant)
        assert torch.equal(coeff, want)
        assert all((q == r).all() for q, r in zip(quant, dep.quant))


@pytest.mark.parametrize("name", CELLS)
def test_cpu_route_within_limits(small_root, name):
    cell, cfg, geo, dep = setup(small_root, name)
    prog = Program(cfg, cell.traffic, "cpu", False)
    pool = frames.make_pool(cfg, 12345, "cpu")
    frames_of = dict(enumerate(pool))
    streams = [(i, prog.encode(f.numpy())) for i, f in enumerate(pool)]
    assert judge.worst_miss(dep, streams, frames_of, "cpu") \
        <= cfg["limits"]["enc_worst_miss"]
    outs = [(i, prog.decode(dep.stream(f))) for i, f in enumerate(pool)]
    assert judge.decode_miss(dep, outs, frames_of, "cpu") \
        <= cfg["limits"]["dec_worst_miss"]


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      3.0, -1.0 - 2 ** -12], dtype=torch.float32)
    assert codec.tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -9, 3.0, -1.0]

"""E0 (``csrc/preprocess.cu``) and D3 (``csrc/postprocess.cu``) without a
division: their closed forms and magic multipliers on every value, and a
NumPy emulation of their work mapping built from the host geometry the
wrappers hand to the C entries (``PlaneGeometry.bands`` / ``.host``,
``OutGeometry.host``): every output byte is written exactly once, every
read lies in the raw frame or the planes, and E0's bands read only their
own raw rows. The kernels' values run on the card (chip_smoke.py phases 7
and 10); their plain versions are held against the JAX package by
tests/test_torch_preprocess.py and tests/test_torch_postprocess.py."""
import numpy as np
import pytest

import gpujpeg_tpu_torch as port
from gpujpeg_tpu_torch.ops import colorspace, preprocess as pre
from gpujpeg_tpu_torch.plan import make_plan

PF, CS = port.PixelFormat, port.ColorSpace
FORMATS = [pf for pf in PF if pf != PF.NONE]
#: (width, height): the plain tests' sizes and a width that is not a
#: multiple of 16 (nor 8), with whole 16-pixel chunks before its edge
SIZES = [(17, 13), (1, 1), (64, 96), (203, 11)]
SUBS = (444, 422, 420)
N_E0, N_D3 = 8, 16      # bytes (E0) and pixels (D3) a lane takes at a time
#: bytes a pixel of the interleaved formats
BPP = {PF.U8: 1, PF.PF_444_U8_P012: 3, PF.PF_422_U8_P1020: 2,
       PF.PF_444_U8_P012Z: 4, PF.PF_444_U8_P012A: 4}


def _width(pf, w):
    return w + w % 2 if pf == PF.PF_422_U8_P1020 and w > 1 else w


def _trunc_div(a, b):
    """C division: truncation toward zero."""
    return np.sign(a) * (np.abs(a) // b)


def test_closed_forms_equal_the_divisions_on_every_value():
    d = np.arange(-255, 256)
    inverse = d + (d == 255) - (d == -255)
    np.testing.assert_array_equal(inverse, _trunc_div(d * 256, 255))
    c = np.arange(256)
    np.testing.assert_array_equal(c + (c == 255), c * 256 // 255)
    # colorspace's own division forms agree
    np.testing.assert_array_equal(colorspace._expand_signed(d, np), inverse)
    np.testing.assert_array_equal(colorspace._expand(c, np), c + (c == 255))


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 7, 8, 16, 255])
def test_div_magic_exact_over_every_16_bit_row_and_column(d):
    """``div_magic``: (2x * m) >> 32 with m = ceil(2**31 / d) equals x // d
    for every x of a JPEG dimension (below 2**16), and ``magic_exact``
    says so."""
    x = np.arange(1 << 16, dtype=np.uint64)
    m = np.uint64(pre.magic(d))
    assert int(m) <= 1 << 31
    np.testing.assert_array_equal((2 * x * m) >> np.uint64(32), x // d)
    assert pre.magic_exact(d, (1 << 16) - 1)


def test_magic_exact_refuses_where_the_multiply_is_not_exact():
    """For d = 255 (m * d - 2**31 = 127) the multiply first errs at the
    first x >= 2**31 / 127 with x % 255 == 254; ``magic_exact`` refuses
    it and accepts every x below it."""
    d = 255
    m = pre.magic(d)
    e = m * d - (1 << 31)
    x = -(-(1 << 31) // e)
    x += (d - 1 - x % d) % d
    assert (2 * x * m) >> 32 == x // d + 1
    assert not pre.magic_exact(d, x)
    assert pre.magic_exact(d, ((1 << 31) - 1) // e)
    assert not pre.magic_exact(1, 1 << 30)


def _e0_plan(pf, w, h, sub, interleaved):
    """UYVY takes the next even width (``upload_raw`` refuses an odd one)."""
    w += w % 2 if pf == PF.PF_422_U8_P1020 else 0
    image = port.ImageParameters(width=w, height=h,
                                 color_space=CS.YCBCR_BT709, pixel_format=pf)
    params = port.Parameters(restart_interval=2, interleaved=interleaved,
                             color_space_internal=CS.YCBCR_BT601_256LVLS
                             ).with_chroma_subsampling(sub)
    return make_plan(params, image)


def _e0_host(g):
    """The C entry's host words, split as ``gj_preprocess_planes`` reads
    them."""
    h = g.host
    fmt, H, W, C = (int(v) for v in h[:4])
    comp = h[4:4 + 8 * C].reshape(C, 8)
    src = h[4 + 8 * C:4 + 8 * C + 15].reshape(3, 5)
    xf = h[4 + 8 * C + 15:]
    return fmt, H, W, comp, src, xf


def _e0_reads(pf, W, src, Y, x0, cs, rx):
    """(start, length) of every raw byte run a lane reads for the chunk of
    plane bytes x0..x0 + 7 selecting raw row Y: the span loads of the
    kernel's fast path, else one load per byte (4 for a 4-byte pixel)."""
    fast = rx in (1, 2) and x0 + N_E0 <= cs and (x0 + N_E0) * rx <= W
    X0 = x0 * rx
    if pf in pre._PLANAR:
        runs = []
        for k, (off, w, _, sx, sy) in enumerate(src):
            sh = 1 if sx == 2 else 0
            row = off + (Y >> (1 if sy == 2 else 0)) * w
            if fast:
                runs.append((row + (X0 >> sh), (N_E0 * rx) >> sh))
            else:
                runs += [(row + ((min(x0 + j, cs - 1) * rx) >> sh), 1)
                         for j in range(N_E0)]
        return runs
    bpp, row = BPP[pf], Y * W * BPP[pf]
    if fast and pf in (PF.PF_444_U8_P012Z, PF.PF_444_U8_P012A):
        return [(row + 4 * (X0 + j * rx), 4) for j in range(N_E0)]
    if fast:
        return [(row + bpp * X0, bpp * N_E0 * rx)]
    runs = []
    for j in range(N_E0):
        X = min(x0 + j, cs - 1) * rx
        if pf == PF.PF_422_U8_P1020:
            runs += [(row + 2 * X + 1, 1), (row + 4 * (X >> 1), 1),
                     (row + 4 * (X >> 1) + 2, 1)]
        else:
            runs.append((row + bpp * X, bpp))
    return runs


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("pf", FORMATS, ids=lambda pf: pf.name)
def test_e0_bands_write_every_plane_byte_once(pf, size):
    """E0's mapping over every sampling, interleaved or not: a CTA per
    band, each band's plane rows from ``bands``, a lane per 8 bytes of a
    row. Every plane byte is written once; every selected raw row lies in
    its band (padding rows in the band of the last selected row); every
    read lies in the raw frame."""
    for sub in SUBS:
        for interleaved in (False, True):
            plan = _e0_plan(pf, *size, sub, interleaved)
            g = pre.plane_geometry(plan, "cpu")
            fmt, H, W, comp, src, xf = _e0_host(g)
            assert (fmt, H, W) == (g.fmt, g.height, g.width)
            np.testing.assert_array_equal(comp, g.comp.numpy())
            np.testing.assert_array_equal(src, g.src.numpy())
            np.testing.assert_array_equal(xf, g.xf.numpy())
            bands = g.bands.numpy()
            assert bands.shape == (-(-H // pre.BAND_ROWS) + 1, len(comp))
            written = np.zeros(g.total, np.int64)
            for b in range(bands.shape[0] - 1):
                for c, (off, dw, dh, rs, cs, ry, rx, ch) in enumerate(comp):
                    assert off % 64 == 0 and dw % 8 == 0
                    for y in range(bands[b, c], bands[b + 1, c]):
                        Y = min(y, rs - 1) * ry
                        assert Y // pre.BAND_ROWS == b and 0 <= Y < H
                        for x0 in range(0, dw, N_E0):
                            written[off + y * dw + x0:
                                    off + y * dw + x0 + N_E0] += 1
                            for start, n in _e0_reads(PF(fmt), W,
                                                      src, Y, x0, cs, rx):
                                assert 0 <= start and start + n <= g.raw_bytes
            np.testing.assert_array_equal(written, 1)


#: the stream plans of D3's sweep: (input pixel format, which sets the
#: component count 1/3/4, sampling, interleaved)
STREAMS = [(PF.U8, 444, False)] + [
    (PF.PF_444_U8_P012, sub, inter) for sub in SUBS
    for inter in (False, True)] + [(PF.PF_444_U8_P012A, 420, True)]


def _d3_host(g):
    """The C entry's host words, split as ``gj_postprocess_planes`` reads
    them."""
    h = g.host
    fmt, H, W, C = (int(v) for v in h[:4])
    comp = h[4:4 + 6 * C].reshape(C, 6)
    magic = h[4 + 6 * C:4 + 8 * C].view(np.uint32).reshape(C, 2)
    dst = h[4 + 8 * C:4 + 8 * C + 15].reshape(3, 5)
    return fmt, H, W, comp, magic, dst, h[4 + 8 * C + 15:]


def _div(x, m):
    return (2 * x * int(m)) >> 32


def _d3_writes(pf, W, dst, Y, X0, fast):
    """(start, length) of the raw bytes a lane writes for pixels X0.. of
    row Y: the chunk's stores on the fast path, else pixel by pixel."""
    p = Y * W + X0
    if pf in pre._PLANAR:
        sx = 1 if dst[1][3] == 2 else 0
        sy = 1 if dst[1][4] == 2 else 0
        sel = Y & sy == 0
        if fast:
            runs = [(dst[0][0] + p, N_D3)]
            if sel:
                runs += [(dst[k][0] + (Y >> sy) * dst[k][1] + (X0 >> sx),
                          N_D3 >> sx) for k in (1, 2)]
            return runs
        runs = []
        for X in range(X0, min(X0 + N_D3, W)):
            runs.append((dst[0][0] + Y * W + X, 1))
            if sel and X & sx == 0:
                runs += [(dst[k][0] + (Y >> sy) * dst[k][1] + (X >> sx), 1)
                         for k in (1, 2)]
        return runs
    bpp = BPP[pf]
    if fast:
        return [(bpp * p, bpp * N_D3)]
    runs = []
    for X in range(X0, min(X0 + N_D3, W)):
        q = Y * W + X
        if pf == PF.PF_422_U8_P1020:
            runs.append((2 * q + 1, 1))
            if X % 2 == 0:
                runs.append((2 * q, 1))
                if X + 1 < W:
                    runs.append((2 * q + 2, 1))
        else:
            runs.append((bpp * q, bpp))
    return runs


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("pf", FORMATS, ids=lambda pf: pf.name)
def test_d3_rows_write_every_raw_byte_once(pf, size):
    """D3's mapping over 1/3/4-component streams of every sampling,
    interleaved or not: a CTA per band of BAND_ROWS output rows, a warp
    per row, a lane per 16 pixels. Every raw byte is written once; every
    plane read (one or two 8-byte loads a component, else a byte at
    ``div_magic(x, rx)``) lies in its component's cropped rows and columns;
    ``div_magic`` of every row and column equals the division."""
    w, h = _width(pf, size[0]), size[1]
    for in_pf, sub, interleaved in STREAMS:
        plan = make_plan(port.Parameters(restart_interval=2,
                                         interleaved=interleaved)
                         .with_chroma_subsampling(sub),
                         port.ImageParameters(width=w, height=h,
                                              pixel_format=in_pf))
        out = port.ImageParameters(width=w, height=h, color_space=CS.RGB,
                                   pixel_format=pf)
        try:
            g = pre.out_geometry(plan, out, "cpu")
        except ValueError:   # what postprocess cannot pack either
            assert len(plan.components) < 3 and pf != PF.U8
            continue
        fmt, H, W, comp, magic, dst, xf = _d3_host(g)
        assert (fmt, H, W) == (g.fmt, g.height, g.width)
        np.testing.assert_array_equal(comp, g.comp.numpy())
        np.testing.assert_array_equal(dst, g.dst.numpy())
        np.testing.assert_array_equal(xf, g.xf.numpy())
        span = all(rx <= 2 for *_, rx in comp)
        written = np.zeros(g.raw_bytes, np.int64)
        for Y in range(H):
            rows = []
            for (off, dw, hc, wc, ry, rx), (my, mx) in zip(comp, magic):
                r = _div(Y, my)
                assert r == Y // ry and r < hc
                rows.append(off + r * dw)
            for X0 in range(0, W, N_D3):
                fast = span and X0 + N_D3 <= W
                for (off, dw, hc, wc, ry, rx), (my, mx), row in zip(
                        comp, magic, rows):
                    if fast:
                        lo, n = X0 // rx, N_D3 // rx
                        assert row % 8 == 0 and lo % 8 == 0
                    else:
                        cols = [_div(X, mx) for X in
                                range(X0, min(X0 + N_D3, W))]
                        assert cols == [X // rx for X in
                                        range(X0, min(X0 + N_D3, W))]
                        lo, n = cols[0], cols[-1] - cols[0] + 1
                    assert lo + n <= wc <= dw
                for start, n in _d3_writes(PF(fmt), W, dst, Y, X0,
                                           fast):
                    written[start:start + n] += 1
        np.testing.assert_array_equal(written, 1)


def test_perf_pixels_kernel_stage_on_cpu(capsys):
    """The tool's ``kernel`` stage on the CPU: the plain versions of E0
    and D3 on the six cells, host clock."""
    from gpujpeg_tpu_torch.tools import perf_pixels
    rows = perf_pixels.main(["kernel", "--device", "cpu", "--height", "24",
                             "--width", "40", "--reps", "1"])
    assert [r["kernel"] for r in rows] == [
        f"{k} {c}" for k, cells in (
            ("preprocess_planes", ("(a)", "(c)", "S3")),
            ("postprocess_planes", ("(a)", "(c)", "(e)"))) for c in cells]
    assert all(r["clock"] == "host clock" and "share_of_bound" not in r
               for r in rows)
    assert "on cpu" in capsys.readouterr().out


def test_perf_pixels_cut_edits_match_the_sources():
    """Each edit of the cut stage finds its line once in the current
    sources, and the stage refuses the CPU."""
    import os
    from gpujpeg_tpu_torch import _build
    from gpujpeg_tpu_torch.tools import perf_pixels
    for name, old, _ in perf_pixels.CUT_EDITS:
        with open(os.path.join(_build.CSRC, name)) as f:
            assert f.read().count(old) == 1, (name, old)
    with pytest.raises(RuntimeError, match="card"):
        perf_pixels.run(("cut",), "cpu", 16, 16)

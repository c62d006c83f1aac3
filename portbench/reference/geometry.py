"""Block and segment geometry of a baseline JPEG deployment (T.81 A.2).

Components, their planes padded to whole MCUs, scans (one interleaved
scan, or one a component), restart segments of ``restart_interval``
MCUs (one segment a scan where it is 0: no restart markers), and the
order in which blocks are entropy coded. A frozen copy of
the geometry of GPUJPEG's ``gpujpeg_coder_init_image``
(``gpujpeg_common.c``), written afresh from the same rules.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: pixel format -> (planar, bytes a pixel, sampling per channel)
PIXEL_FORMATS = {
    "U8": (False, 1, ((1, 1),)),
    "PF_444_U8_P012": (False, 3, ((1, 1),) * 3),
    "PF_444_U8_P0P1P2": (True, 0, ((1, 1),) * 3),
    "PF_422_U8_P1020": (False, 2, ((2, 1), (1, 1), (1, 1))),
    "PF_422_U8_P0P1P2": (True, 0, ((2, 1), (1, 1), (1, 1))),
    "PF_420_U8_P0P1P2": (True, 0, ((2, 2), (1, 1), (1, 1))),
    "PF_444_U8_P012Z": (False, 4, ((1, 1),) * 3),
    "PF_444_U8_P012A": (False, 4, ((1, 1),) * 4),
}


def raw_size(width: int, height: int, pixel_format: str) -> int:
    """Bytes of one raw frame."""
    planar, bpp, samp = PIXEL_FORMATS[pixel_format]
    if not planar:
        return width * height * bpp
    h0, v0 = samp[0]
    return sum(-(-width * h // h0) * -(-height * v // v0) for h, v in samp)


@dataclasses.dataclass(frozen=True)
class Component:
    index: int
    kind: int            # 0 luminance, 1 chrominance: selects the tables
    h: int               # sampling factors
    v: int
    width: int           # samples of the component's plane
    height: int
    data_width: int      # padded to whole MCUs
    data_height: int
    blocks_x: int
    blocks_y: int
    plane_offset: int    # first block of this plane in plane order


@dataclasses.dataclass(frozen=True)
class Geometry:
    width: int
    height: int
    interleaved: bool
    restart_interval: int
    components: tuple
    #: scans: tuple of component index tuples
    scans: tuple
    n_blocks: int
    n_segments: int
    #: scan order -> plane order, (n_blocks,)
    block_plane_idx: np.ndarray
    #: component of each block in scan order
    block_comp: np.ndarray
    #: scan-order index of the block whose DC predicts this one, -1 none
    dc_pred: np.ndarray
    #: first block (scan order), block count and scan of each segment
    seg_start: np.ndarray
    seg_count: np.ndarray
    seg_scan: np.ndarray


def make_geometry(width: int, height: int, sampling, interleaved: bool,
                  restart_interval: int, internal_rgb: bool = False
                  ) -> Geometry:
    """The geometry of a frame coded with per-component ``sampling``
    ((h, v) pairs), one interleaved scan or a scan a component, and
    ``restart_interval`` MCUs a segment; 0 for none: one segment a scan,
    its DC predictor never reset (T.81 F.1.1.5.1)."""
    if restart_interval < 0:
        raise ValueError(f"restart interval {restart_interval}")
    n = len(sampling)
    if n == 1:
        sampling = ((1, 1),)
    interleaved = interleaved and n > 1
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    comps, off = [], 0
    for i, (h, v) in enumerate(sampling):
        w = -(-width * h // hmax)
        ht = -(-height * v // vmax)
        mx, my = (8 * h, 8 * v) if interleaved else (8, 8)
        dw, dh = -(-w // mx) * mx, -(-ht // my) * my
        kind = 0 if (internal_rgb or i == 0) else 1
        comps.append(Component(i, kind, h, v, w, ht, dw, dh, dw // 8,
                               dh // 8, off))
        off += (dw // 8) * (dh // 8)
    if interleaved:
        mcx, mcy = comps[0].data_width // (8 * comps[0].h), \
            comps[0].data_height // (8 * comps[0].v)
        slot = [(c.index, y, x) for c in comps for y in range(c.v)
                for x in range(c.h)]
        sc = np.array([s[0] for s in slot])
        sy = np.array([s[1] for s in slot])
        sx = np.array([s[2] for s in slot])
        mcu = np.arange(mcx * mcy)
        ri = restart_interval or len(mcu)
        my_, mx_ = mcu // mcx, mcu % mcx
        hs = np.array([c.h for c in comps])[sc]
        vs = np.array([c.v for c in comps])[sc]
        bw = np.array([c.blocks_x for c in comps])[sc]
        po = np.array([c.plane_offset for c in comps])[sc]
        plane = (po + (my_[:, None] * vs + sy) * bw
                 + mx_[:, None] * hs + sx).reshape(-1)
        comp = np.broadcast_to(sc, (len(mcu), len(slot))).reshape(-1)
        seg_of_block = np.repeat(mcu // ri, len(slot))
        n_seg = -(-len(mcu) // ri)
        starts = np.arange(n_seg) * ri * len(slot)
        counts = np.minimum((np.arange(n_seg) + 1) * ri, len(mcu)) \
            * len(slot) - starts
        seg_scan = np.zeros(n_seg, np.int64)
        scans = (tuple(c.index for c in comps),)
    else:
        plane = np.arange(off)
        comp = np.concatenate([np.full(c.blocks_x * c.blocks_y, c.index)
                               for c in comps])
        seg_of_block, starts, counts, seg_scan = [], [], [], []
        seg0, blk0 = 0, 0
        for c in comps:
            nb = c.blocks_x * c.blocks_y
            ri = restart_interval or nb
            ns = -(-nb // ri)
            seg_of_block.append(np.arange(nb) // ri + seg0)
            st = np.arange(ns) * ri
            starts.append(st + blk0)
            counts.append(np.minimum(st + ri, nb) - st)
            seg_scan.append(np.full(ns, c.index))
            seg0 += ns
            blk0 += nb
        seg_of_block = np.concatenate(seg_of_block)
        starts, counts = np.concatenate(starts), np.concatenate(counts)
        seg_scan = np.concatenate(seg_scan)
        scans = tuple((c.index,) for c in comps)
    # the DC predictor: the previous block of the same component in the
    # same segment (T.81 F.1.1.5.1, reset at each restart marker)
    nb = len(comp)
    order = np.lexsort((np.arange(nb), comp, seg_of_block))
    prev = np.full(nb, -1, np.int64)
    same = ((seg_of_block[order][1:] == seg_of_block[order][:-1])
            & (comp[order][1:] == comp[order][:-1]))
    prev[order[1:][same]] = order[:-1][same]
    return Geometry(width, height, interleaved, restart_interval,
                    tuple(comps), scans, nb,
                    len(starts), plane.astype(np.int64),
                    comp.astype(np.int64), prev,
                    starts.astype(np.int64), counts.astype(np.int64),
                    np.asarray(seg_scan, np.int64))

"""Geometry and memory planner — the analog of ``gpujpeg_coder_init_image``
(reference: src/gpujpeg_common.c:533-1004).

Where the reference builds device-side component/segment/block tables, this
planner produces a static, NumPy-backed :class:`CoderPlan` whose arrays feed
the JAX pipeline as constants. Every shape is a pure function of
(image parameters, codec parameters), so jitted computations are traced once
per distinct geometry and reused for free across a video stream — the same
re-use trick as the reference's parameter-equality early-out
(gpujpeg_common.c:536-540).

Block ordering convention:

* **plane order** — per component, 8x8 blocks in raster order, components
  concatenated (comp0's blocks, then comp1's, ...). This is the natural
  layout coming out of the block-ified pixel planes.
* **scan order** — segment -> MCU -> component -> v -> h: the order blocks
  are entropy-coded in (reference block list: gpujpeg_common.c:930-987).

``block_plane_idx`` maps scan order -> plane order (a gather for encode, a
scatter for decode).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np

from .params import ImageParameters, Parameters
from .types import ColorSpace, ComponentType, PixelFormat, SamplingFactor

#: Upper bound on the entropy-coded size of one 8x8 block, in bytes.
#: Worst case is 63 AC symbols * 26 bits + DC 27 bits + EOB = ~1665 bits.
#: (reference uses 512: gpujpeg_common_internal.h:55.)
MAX_BLOCK_COMPRESSED_BYTES = 256

#: Per-segment alignment of compressed-data offsets
#: (reference: SEGMENT_ALIGN, gpujpeg_common.c:72).
SEGMENT_ALIGN = 128


def _div_ceil(a: int, b: int) -> int:
    return -(-a // b)


@dataclasses.dataclass(frozen=True)
class ComponentPlan:
    """Geometry of one color component
    (reference: struct gpujpeg_component, gpujpeg_common_internal.h:156-209)."""

    index: int
    comp_type: ComponentType
    sampling: SamplingFactor
    #: real pixel dims of this component's plane
    width: int
    height: int
    #: dims rounded up to the MCU grid
    data_width: int
    data_height: int
    #: MCU size in this component's plane (8*samp if interleaved else 8)
    mcu_size_x: int
    mcu_size_y: int
    mcu_count_x: int
    mcu_count_y: int
    mcu_count: int
    block_count_x: int
    block_count_y: int
    block_count: int
    #: MCUs per segment and segment count for this component's own scan
    #: (non-interleaved mode; reference: gpujpeg_common.c:621-650)
    segment_mcu_count: int
    segment_count: int
    #: offset of this component's first block in plane order
    plane_block_offset: int
    #: index of quant table (0 = luminance, 1 = chrominance)
    quant_table_index: int
    #: Huffman table indices
    dc_huff_index: int
    ac_huff_index: int


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    index: int
    #: component indices coded in this scan
    comp_indices: tuple[int, ...]
    segment_index_start: int
    segment_count: int
    block_index_start: int
    block_count: int
    #: blocks per full MCU of this scan
    blocks_per_mcu: int
    mcu_count: int
    segment_mcu_count: int


@dataclasses.dataclass(frozen=True)
class CoderPlan:
    params: Parameters
    image: ImageParameters
    components: tuple[ComponentPlan, ...]
    scans: tuple[ScanPlan, ...]

    #: total number of 8x8 blocks across all components
    n_blocks: int
    n_segments: int
    mcu_count: int

    # ---- static device-feedable arrays (all in scan order) ----
    #: (n_blocks,) gather index: scan order -> plane order
    block_plane_idx: np.ndarray
    #: (n_blocks,) component index of each block
    block_comp: np.ndarray
    #: (n_blocks,) segment id of each block
    block_segment: np.ndarray
    #: (n_blocks,) scan-order index of the DC predecessor (-1 = none)
    dc_pred_idx: np.ndarray
    #: (n_segments,) first block (scan order) of each segment
    seg_block_start: np.ndarray
    #: (n_segments,) number of blocks in each segment
    seg_block_count: np.ndarray
    #: (n_segments,) scan id of each segment
    seg_scan: np.ndarray
    #: (n_segments,) index of the segment within its scan
    seg_scan_index: np.ndarray

    @property
    def max_seg_block_count(self) -> int:
        return int(self.seg_block_count.max()) if self.n_segments else 0

    def component_planes_shape(self) -> tuple[tuple[int, int], ...]:
        return tuple((c.data_height, c.data_width) for c in self.components)


def _component_plans(params: Parameters, image: ImageParameters) -> list[ComponentPlan]:
    comp_count = image.comp_count
    sampling = params.sampling_factor[:comp_count]
    if comp_count == 1:
        sampling = (SamplingFactor(1, 1),)
    max_h = max(s.horizontal for s in sampling)
    max_v = max(s.vertical for s in sampling)

    comps = []
    plane_block_offset = 0
    for i in range(comp_count):
        s = sampling[i]
        # real component dims (reference: gpujpeg_common.c:585-592)
        width = _div_ceil(image.width * s.horizontal, max_h)
        height = _div_ceil(image.height * s.vertical, max_v)
        if params.interleaved:
            mcu_sx, mcu_sy = 8 * s.horizontal, 8 * s.vertical
        else:
            mcu_sx, mcu_sy = 8, 8
        data_width = _div_ceil(width, mcu_sx) * mcu_sx
        data_height = _div_ceil(height, mcu_sy) * mcu_sy
        mcu_cx = data_width // mcu_sx
        mcu_cy = data_height // mcu_sy
        mcu_count = mcu_cx * mcu_cy
        bx, by = data_width // 8, data_height // 8
        block_count = bx * by
        seg_mcu = params.restart_interval if params.restart_interval > 0 else mcu_count
        seg_count = _div_ceil(mcu_count, seg_mcu) if mcu_count else 0
        # component class (reference: gpujpeg_common.c:595)
        is_luma = (params.color_space_internal == ColorSpace.RGB) or i == 0
        ctype = ComponentType.LUMINANCE if is_luma else ComponentType.CHROMINANCE
        comps.append(ComponentPlan(
            index=i, comp_type=ctype, sampling=s,
            width=width, height=height,
            data_width=data_width, data_height=data_height,
            mcu_size_x=mcu_sx, mcu_size_y=mcu_sy,
            mcu_count_x=mcu_cx, mcu_count_y=mcu_cy, mcu_count=mcu_count,
            block_count_x=bx, block_count_y=by, block_count=block_count,
            segment_mcu_count=seg_mcu, segment_count=seg_count,
            plane_block_offset=plane_block_offset,
            quant_table_index=int(ctype),
            dc_huff_index=int(ctype),
            ac_huff_index=int(ctype),
        ))
        plane_block_offset += block_count
    return comps


def _plan_noninterleaved(params, image, comps):
    """One scan per component; MCU == one 8x8 block
    (reference: gpujpeg_common.c:739-766)."""
    scans = []
    block_plane_idx, block_comp, block_segment, dc_pred = [], [], [], []
    seg_start, seg_count_blocks, seg_scan, seg_scan_idx = [], [], [], []
    block_base = 0
    seg_base = 0
    for c in comps:
        nb = c.block_count
        ri = c.segment_mcu_count
        n_seg = c.segment_count
        idx = np.arange(nb, dtype=np.int32)
        block_plane_idx.append(idx + c.plane_block_offset)
        block_comp.append(np.full(nb, c.index, dtype=np.int32))
        seg_of_block = idx // ri
        block_segment.append(seg_of_block + seg_base)
        # DC predecessor: previous block unless first in segment
        pred = idx - 1 + block_base
        pred[idx % ri == 0] = -1
        dc_pred.append(pred)
        starts = np.arange(n_seg, dtype=np.int32) * ri
        counts = np.minimum(starts + ri, nb) - starts
        seg_start.append(starts + block_base)
        seg_count_blocks.append(counts)
        seg_scan.append(np.full(n_seg, c.index, dtype=np.int32))
        seg_scan_idx.append(np.arange(n_seg, dtype=np.int32))
        scans.append(ScanPlan(
            index=c.index, comp_indices=(c.index,),
            segment_index_start=seg_base, segment_count=n_seg,
            block_index_start=block_base, block_count=nb,
            blocks_per_mcu=1, mcu_count=c.mcu_count,
            segment_mcu_count=ri,
        ))
        block_base += nb
        seg_base += n_seg
    return scans, block_plane_idx, block_comp, block_segment, dc_pred, \
        seg_start, seg_count_blocks, seg_scan, seg_scan_idx


def _plan_interleaved(params, image, comps):
    """Single scan; MCU interleaves sampling_h x sampling_v blocks per
    component (reference block-list build: gpujpeg_common.c:930-987)."""
    mcu_cx = comps[0].mcu_count_x
    mcu_cy = comps[0].mcu_count_y
    # All components share the interleaved MCU grid.
    for c in comps:
        assert c.mcu_count_x == mcu_cx and c.mcu_count_y == mcu_cy, \
            "interleaved components must share the MCU grid"
    n_mcu = mcu_cx * mcu_cy
    ri = params.restart_interval if params.restart_interval > 0 else n_mcu
    n_seg = _div_ceil(n_mcu, ri)

    # Within-MCU template: slot -> (comp, v, h), comp-major then v, h.
    tmpl_comp, tmpl_v, tmpl_h = [], [], []
    for c in comps:
        for v in range(c.sampling.vertical):
            for h in range(c.sampling.horizontal):
                tmpl_comp.append(c.index)
                tmpl_v.append(v)
                tmpl_h.append(h)
    tmpl_comp = np.array(tmpl_comp, dtype=np.int32)
    tmpl_v = np.array(tmpl_v, dtype=np.int32)
    tmpl_h = np.array(tmpl_h, dtype=np.int32)
    bpm = tmpl_comp.shape[0]  # blocks per MCU

    # previous slot of the same component within the MCU (-1 if first)
    prev_same = np.full(bpm, -1, dtype=np.int32)
    last_of_comp = {}
    for s in range(bpm):
        cidx = int(tmpl_comp[s])
        if cidx in last_of_comp:
            prev_same[s] = last_of_comp[cidx]
        last_of_comp[cidx] = s
    last_slot_of_comp = np.zeros(len(comps), dtype=np.int32)
    for cidx, s in last_of_comp.items():
        last_slot_of_comp[cidx] = s

    mcu = np.arange(n_mcu, dtype=np.int32)
    my, mx = mcu // mcu_cx, mcu % mcu_cx

    samp_h = np.array([c.sampling.horizontal for c in comps], dtype=np.int32)
    samp_v = np.array([c.sampling.vertical for c in comps], dtype=np.int32)
    bw = np.array([c.block_count_x for c in comps], dtype=np.int32)
    plane_off = np.array([c.plane_block_offset for c in comps], dtype=np.int32)

    # (n_mcu, bpm) plane indices
    cc = tmpl_comp[None, :]
    by = my[:, None] * samp_v[cc] + tmpl_v[None, :]
    bx = mx[:, None] * samp_h[cc] + tmpl_h[None, :]
    plane_idx = plane_off[cc] + by * bw[cc] + bx

    block_plane_idx = plane_idx.reshape(-1)
    block_comp = np.broadcast_to(tmpl_comp, (n_mcu, bpm)).reshape(-1).copy()
    seg_of_mcu = mcu // ri
    block_segment = np.repeat(seg_of_mcu, bpm)

    # DC predecessor in scan order
    scan_pos = np.arange(n_mcu * bpm, dtype=np.int32).reshape(n_mcu, bpm)
    pred = np.where(
        prev_same[None, :] >= 0,
        (mcu * bpm)[:, None] + prev_same[None, :],
        ((mcu - 1) * bpm)[:, None] + last_slot_of_comp[cc],
    ).astype(np.int32)
    # first MCU of each segment: chains with no within-MCU predecessor reset
    seg_first = (mcu % ri == 0)
    pred = np.where(seg_first[:, None] & (prev_same[None, :] < 0), -1, pred)
    dc_pred = pred.reshape(-1)
    del scan_pos

    starts_mcu = np.arange(n_seg, dtype=np.int32) * ri
    counts_mcu = np.minimum(starts_mcu + ri, n_mcu) - starts_mcu
    seg_start = starts_mcu * bpm
    seg_count_blocks = counts_mcu * bpm
    seg_scan = np.zeros(n_seg, dtype=np.int32)
    seg_scan_idx = np.arange(n_seg, dtype=np.int32)

    scans = [ScanPlan(
        index=0, comp_indices=tuple(c.index for c in comps),
        segment_index_start=0, segment_count=n_seg,
        block_index_start=0, block_count=n_mcu * bpm,
        blocks_per_mcu=bpm, mcu_count=n_mcu, segment_mcu_count=ri,
    )]
    return scans, [block_plane_idx], [block_comp], [block_segment], [dc_pred], \
        [seg_start], [seg_count_blocks], [seg_scan], [seg_scan_idx]


@functools.lru_cache(maxsize=32)
def make_plan(params: Parameters, image: ImageParameters) -> CoderPlan:
    """Build the full coder plan. Cached on (params, image) — the analog of
    the reference's parameter-equality early-out (gpujpeg_common.c:536-540)."""
    comps = _component_plans(params, image)
    if params.interleaved and image.comp_count > 1:
        parts = _plan_interleaved(params, image, comps)
    else:
        parts = _plan_noninterleaved(params, image, comps)
    (scans, block_plane_idx, block_comp, block_segment, dc_pred,
     seg_start, seg_count_blocks, seg_scan, seg_scan_idx) = parts

    block_plane_idx = np.concatenate(block_plane_idx)
    block_comp = np.concatenate(block_comp)
    block_segment = np.concatenate(block_segment)
    dc_pred = np.concatenate(dc_pred)
    seg_start = np.concatenate(seg_start)
    seg_count_blocks = np.concatenate(seg_count_blocks)
    seg_scan = np.concatenate(seg_scan)
    seg_scan_idx = np.concatenate(seg_scan_idx)

    if params.interleaved and image.comp_count > 1:
        mcu_count = scans[0].mcu_count
    else:
        mcu_count = sum(c.mcu_count for c in comps)

    return CoderPlan(
        params=params, image=image,
        components=tuple(comps), scans=tuple(scans),
        n_blocks=int(block_plane_idx.shape[0]),
        n_segments=int(seg_start.shape[0]),
        mcu_count=mcu_count,
        block_plane_idx=block_plane_idx,
        block_comp=block_comp,
        block_segment=block_segment,
        dc_pred_idx=dc_pred,
        seg_block_start=seg_start,
        seg_block_count=seg_count_blocks,
        seg_scan=seg_scan,
        seg_scan_index=seg_scan_idx,
    )

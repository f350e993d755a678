"""APS (adaptation parameter set) parsing: ALF filter sets and DRA tables.

The Main profile signals ALF coefficients (APS type 0) and DRA piecewise
scale tables (APS type 1) in dedicated NAL units, buffered by id in a
32-slot array and referenced from slice headers / PPS
(ref: src_main/xevdm.c:2937-2991 dispatch,
src_main/xevdm_eco.c:2082-2510 payload syntax).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .bitstream import BitReader
from .syntax import MalformedBitstream

APS_MAX_NUM = 32
MAX_NUM_ALF_CLASSES = 25
MAX_NUM_ALF_LUMA_COEFF = 13

# 7x7 / 5x5 diamond shape metadata (ref: src_main/xevdm_alf.h:130-191,
# xevdm_alf.c:462-492): num_coef = size^2/4 + 1
GOLOMB_IDX_5 = [0, 0, 1, 0, 0, 1]
GOLOMB_IDX_7 = [0, 0, 1, 0, 0, 1, 2, 1, 0, 0, 1, 2]
ALF_FILTER_5, ALF_FILTER_7 = 0, 1


@dataclass
class AlfSliceParam:
    """Mirror of XEVD_ALF_SLICE_PARAM (ref: src_main/xevdm_def.h:401-447)."""
    enabled_flag: list = field(default_factory=lambda: [0, 0, 0])
    luma_filter_type: int = ALF_FILTER_5
    num_luma_filters: int = 1
    luma_coeff: list = field(
        default_factory=lambda: [0] * (MAX_NUM_ALF_CLASSES
                                       * MAX_NUM_ALF_LUMA_COEFF))
    chroma_coeff: list = field(default_factory=lambda: [0] * 7)
    filter_coeff_delta_idx: list = field(
        default_factory=lambda: [0] * MAX_NUM_ALF_CLASSES)
    filter_coeff_flag: list = field(
        default_factory=lambda: [1] * MAX_NUM_ALF_CLASSES)
    fixed_filter_pattern: int = 0
    fixed_filter_idx: list = field(
        default_factory=lambda: [0] * MAX_NUM_ALF_CLASSES)
    fixed_filter_usage_flag: list = field(
        default_factory=lambda: [0] * MAX_NUM_ALF_CLASSES)
    coeff_delta_flag: int = 0
    coeff_delta_pred_mode_flag: int = 0
    chroma_filter_present: int = 0
    chroma_ctb_present_flag: int = 0
    is_ctb_alf_on: int = 0
    alf_ctu_enable_flag: object = None   # per-CTU map (parsed in-slice)


@dataclass
class SigParamDra:
    """Mirror of SIG_PARAM_DRA (ref: src_main/xevdm_def.h:126-138)."""
    signal_dra_flag: int = 1
    dra_descriptor1: int = 4
    dra_descriptor2: int = 9
    num_ranges: int = 0
    equal_ranges_flag: int = 0
    in_ranges: list = field(default_factory=lambda: [0] * 34)
    dra_scale_value: list = field(default_factory=lambda: [0] * 32)
    dra_cb_scale_value: int = 0
    dra_cr_scale_value: int = 0
    dra_table_idx: int = 0


def alf_golomb_decode(bs: BitReader, k: int, signed_val: bool) -> int:
    """Exp-Golomb with order k (ref: src_main/xevdm_eco.c:2154-2187)."""
    num_leading = -1
    sym = 0
    while not sym:
        sym = bs.read1()
        num_leading += 1
    symbol = ((1 << num_leading) - 1) << k
    if num_leading + k > 0:
        symbol += bs.read(num_leading + k)
    if signed_val and symbol != 0:
        if not bs.read1():
            symbol = -symbol
    return symbol


def _parse_alf_filter(bs: BitReader, p: AlfSliceParam, is_chroma: bool):
    """(ref: src_main/xevdm_eco.c:2224-2318)"""
    if not is_chroma:
        p.coeff_delta_flag = bs.read1()
        if not p.coeff_delta_flag and p.num_luma_filters > 1:
            p.coeff_delta_pred_mode_flag = bs.read1()
        else:
            p.coeff_delta_pred_mode_flag = 0
    if is_chroma or p.luma_filter_type == ALF_FILTER_5:
        num_coeff = 7
        golomb_idx = GOLOMB_IDX_5
        max_golomb_idx = 2
    else:
        num_coeff = 13
        golomb_idx = GOLOMB_IDX_7
        max_golomb_idx = 3
    k_min = bs.read_ue() + 1
    if k_min > 7:
        raise MalformedBitstream("alf min eg order out of range")
    k_min_tab = []
    for _ in range(max_golomb_idx):
        k_min = k_min + bs.read1()
        k_min_tab.append(k_min)
    num_filters = 1 if is_chroma else p.num_luma_filters
    coeff = p.chroma_coeff if is_chroma else p.luma_coeff
    if not is_chroma:
        if p.coeff_delta_flag:
            for ind in range(p.num_luma_filters):
                p.filter_coeff_flag[ind] = bs.read1()
        for ind in range(num_filters):
            if p.filter_coeff_flag[ind]:
                for i in range(num_coeff - 1):
                    coeff[ind * MAX_NUM_ALF_LUMA_COEFF + i] = \
                        alf_golomb_decode(bs, k_min_tab[golomb_idx[i]], True)
            else:
                for i in range(num_coeff):
                    coeff[ind * MAX_NUM_ALF_LUMA_COEFF + i] = 0
    else:
        for i in range(num_coeff - 1):
            coeff[i] = alf_golomb_decode(bs, k_min_tab[golomb_idx[i]], True)


def parse_alf_aps(bs: BitReader) -> AlfSliceParam:
    """ALF APS payload (ref: src_main/xevdm_eco.c:2396-2480)."""
    p = AlfSliceParam()
    from .tables import TBL_LOG2
    luma_signal = bs.read1()
    p.enabled_flag[0] = luma_signal
    chroma_signal = bs.read1()
    p.chroma_filter_present = chroma_signal
    if luma_signal:
        num_m1 = bs.read_ue()
        if num_m1 >= MAX_NUM_ALF_CLASSES:
            raise MalformedBitstream("alf num filters out of range")
        p.luma_filter_type = bs.read1()
        p.num_luma_filters = num_m1 + 1
        if num_m1 > 0:
            nbits = int(TBL_LOG2[num_m1]) + 1
            for i in range(MAX_NUM_ALF_CLASSES):
                p.filter_coeff_delta_idx[i] = bs.read(nbits)
        pattern = alf_golomb_decode(bs, 0, False)
        p.fixed_filter_pattern = pattern
        if pattern == 2:
            for c in range(MAX_NUM_ALF_CLASSES):
                p.fixed_filter_usage_flag[c] = bs.read1()
        elif pattern == 1:
            for c in range(MAX_NUM_ALF_CLASSES):
                p.fixed_filter_usage_flag[c] = 1
        if pattern > 0:
            for c in range(MAX_NUM_ALF_CLASSES):
                if p.fixed_filter_usage_flag[c]:
                    p.fixed_filter_idx[c] = bs.read(4)
        _parse_alf_filter(bs, p, False)
    if chroma_signal:
        _parse_alf_filter(bs, p, True)
    return p


def parse_dra_aps(bs: BitReader, bit_depth: int) -> SigParamDra:
    """DRA APS payload (ref: src_main/xevdm_eco.c:2319-2395)."""
    p = SigParamDra()
    p.dra_descriptor1 = bs.read(4)
    p.dra_descriptor2 = bs.read(4)
    if p.dra_descriptor1 != 4 or p.dra_descriptor2 != 9:
        raise MalformedBitstream("unsupported DRA descriptor")
    nbits = p.dra_descriptor1 + p.dra_descriptor2
    num_ranges_m1 = bs.read_ue()
    if num_ranges_m1 > 31:
        raise MalformedBitstream("DRA num ranges out of range")
    p.equal_ranges_flag = bs.read1()
    global_offset = bs.read(10)
    delta = [0] * 32
    if p.equal_ranges_flag:
        delta[0] = bs.read(10)
    else:
        for i in range(num_ranges_m1 + 1):
            delta[i] = bs.read(10)
    for i in range(num_ranges_m1 + 1):
        p.dra_scale_value[i] = bs.read(nbits)
    p.dra_cb_scale_value = bs.read(nbits)
    p.dra_cr_scale_value = bs.read(nbits)
    p.dra_table_idx = bs.read_ue()
    if p.dra_table_idx > 58:
        raise MalformedBitstream("DRA table idx out of range")
    p.num_ranges = num_ranges_m1 + 1
    sh = max(0, bit_depth - 10)
    p.in_ranges[0] = global_offset << sh
    for i in range(1, p.num_ranges + 1):
        d = delta[0] if p.equal_ranges_flag else delta[i - 1]
        p.in_ranges[i] = p.in_ranges[i - 1] + (d << sh)
    return p


def parse_aps(bs: BitReader, bit_depth: int):
    """APS NALU → (aps_id, aps_type_id, payload)
    (ref: src_main/xevdm_eco.c:2082-2138)."""
    aps_id = bs.read(5)
    aps_type = bs.read(3)
    if aps_type == 0:
        payload = parse_alf_aps(bs)
    elif aps_type == 1:
        payload = parse_dra_aps(bs, bit_depth)
    else:
        payload = None   # reference only warns on unknown APS types
    if payload is not None:
        if bs.read1() != 0:
            raise MalformedBitstream("aps_extension_flag != 0")
        bs.align()
    return aps_id, aps_type, payload

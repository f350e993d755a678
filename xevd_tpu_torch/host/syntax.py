"""High-level syntax (NALU/SPS/PPS/SH/SEI) for EVC Baseline.

Parsers mirror the normative HLS (ref: src_base/xevd_eco.c:1178-1695).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .bitstream import BitReader
from . import tables as T


class UnsupportedStream(Exception):
    """Raised when the stream enables a tool this decoder (or the selected
    pixel backend) does not implement yet.  Refusing loudly is mandatory:
    decoding anyway would silently emit wrong pixels."""


class MalformedBitstream(Exception):
    pass


@dataclass
class Nalu:
    nal_unit_type: int = 0
    nuh_temporal_id: int = 0


def parse_nalu_header(bs: BitReader) -> Nalu:
    """16-bit NAL header (ref: src_base/xevd_eco.c:1178-1208)."""
    if bs.read(1) != 0:
        raise MalformedBitstream("forbidden_zero_bit != 0")
    nut_plus1 = bs.read(6)
    tid = bs.read(3)
    if bs.read(5) != 0:
        raise MalformedBitstream("nuh_reserved_zero_5bits != 0")
    if bs.read(1) != 0:
        raise MalformedBitstream("nuh_extension_flag != 0")
    return Nalu(nal_unit_type=nut_plus1 - 1, nuh_temporal_id=tid)


@dataclass
class ChromaQpTable:
    present: bool = False
    same_qp_table_for_chroma: bool = False
    global_offset_flag: bool = False
    num_points_in_qp_table_minus1: list = field(default_factory=lambda: [0, 0])
    delta_qp_in_val_minus1: list = field(default_factory=lambda: [[0] * 58, [0] * 58])
    delta_qp_out_val: list = field(default_factory=lambda: [[0] * 58, [0] * 58])


@dataclass
class RefPicListStruct:
    """One candidate reference-picture list (ref: src_main/xevdm_eco.c:1820-1845)."""
    poc: int = 0
    tid: int = 0
    ref_pic_num: int = 0
    ref_pic_active_num: int = 0
    ref_pics: list = field(default_factory=list)   # signed delta POCs


@dataclass
class Sps:
    sps_seq_parameter_set_id: int = 0
    profile_idc: int = 0
    level_idc: int = 0
    toolset_idc_h: int = 0
    toolset_idc_l: int = 0
    chroma_format_idc: int = 1
    pic_width_in_luma_samples: int = 0
    pic_height_in_luma_samples: int = 0
    bit_depth_luma_minus8: int = 0
    bit_depth_chroma_minus8: int = 0
    sps_btt_flag: int = 0
    log2_ctu_size_minus5: int = 0
    log2_min_cb_size_minus2: int = 0
    log2_diff_ctu_max_14_cb_size: int = 0
    log2_diff_ctu_max_tt_cb_size: int = 0
    log2_diff_min_cb_min_tt_cb_size_minus2: int = 0
    sps_suco_flag: int = 0
    log2_diff_ctu_size_max_suco_cb_size: int = 0
    log2_diff_max_suco_min_suco_cb_size: int = 0
    tool_admvp: int = 0
    tool_affine: int = 0
    tool_amvr: int = 0
    tool_dmvr: int = 0
    tool_mmvd: int = 0
    tool_hmvp: int = 0
    tool_eipd: int = 0
    ibc_flag: int = 0
    ibc_log_max_size: int = 0
    tool_cm_init: int = 0
    tool_adcc: int = 0
    tool_iqt: int = 0
    tool_ats: int = 0
    tool_addb: int = 0
    tool_alf: int = 0
    tool_htdf: int = 0
    tool_rpl: int = 0
    tool_pocs: int = 0
    dquant_flag: int = 0
    tool_dra: int = 0
    log2_max_pic_order_cnt_lsb_minus4: int = 0
    log2_sub_gop_length: int = 0
    log2_ref_pic_gap_length: int = 0
    max_num_ref_pics: int = 0
    sps_max_dec_pic_buffering_minus1: int = 0
    long_term_ref_pics_flag: int = 0
    rpl1_same_as_rpl0_flag: int = 0
    rpls_l0: list = field(default_factory=list)
    rpls_l1: list = field(default_factory=list)
    picture_cropping_flag: int = 0
    picture_crop_left_offset: int = 0
    picture_crop_right_offset: int = 0
    picture_crop_top_offset: int = 0
    picture_crop_bottom_offset: int = 0
    chroma_qp_table: ChromaQpTable = field(default_factory=ChromaQpTable)
    vui_parameters_present_flag: int = 0
    num_reorder_pics: int = 0
    bitstream_restriction_flag: int = 0

    @property
    def bit_depth_luma(self):
        return self.bit_depth_luma_minus8 + 8

    @property
    def bit_depth_chroma(self):
        return self.bit_depth_chroma_minus8 + 8

    @property
    def is_main(self):
        return self.profile_idc in (1, 3)


def parse_rlp(bs: BitReader) -> RefPicListStruct:
    """ref_pic_list_struct (ref: src_main/xevdm_eco.c:1820-1845)."""
    rpl = RefPicListStruct()
    rpl.ref_pic_num = bs.read_ue()
    if rpl.ref_pic_num > 0:
        delta = bs.read_ue()
        if delta != 0:
            if bs.read1():   # strp_entry_sign_flag: 1 => negative
                delta = -delta
        rpl.ref_pics.append(delta)
    for _ in range(1, rpl.ref_pic_num):
        delta = bs.read_ue()
        if delta != 0:
            if bs.read1():
                delta = -delta
        rpl.ref_pics.append(rpl.ref_pics[-1] + delta)
    return rpl


def parse_sps(bs: BitReader) -> Sps:
    """Unified SPS parser: Baseline flat reads plus Main-profile conditional
    fields (ref: src_base/xevd_eco.c:1305-1394, src_main/xevdm_eco.c:1847-2004)."""
    sps = Sps()
    sps.sps_seq_parameter_set_id = bs.read_ue()
    sps.profile_idc = bs.read(8)
    if sps.profile_idc not in (0, 1, 2, 3):
        raise MalformedBitstream(f"bad profile_idc {sps.profile_idc}")
    main = sps.is_main
    sps.level_idc = bs.read(8)
    sps.toolset_idc_h = bs.read(32)
    sps.toolset_idc_l = bs.read(32)
    sps.chroma_format_idc = bs.read_ue()
    sps.pic_width_in_luma_samples = bs.read_ue()
    sps.pic_height_in_luma_samples = bs.read_ue()
    sps.bit_depth_luma_minus8 = bs.read_ue()
    sps.bit_depth_chroma_minus8 = bs.read_ue()
    sps.sps_btt_flag = bs.read1()
    if main and sps.sps_btt_flag:
        sps.log2_ctu_size_minus5 = bs.read_ue()
        sps.log2_min_cb_size_minus2 = bs.read_ue()
        sps.log2_diff_ctu_max_14_cb_size = bs.read_ue()
        sps.log2_diff_ctu_max_tt_cb_size = bs.read_ue()
        sps.log2_diff_min_cb_min_tt_cb_size_minus2 = bs.read_ue()
    sps.sps_suco_flag = bs.read1()
    if main and sps.sps_suco_flag:
        sps.log2_diff_ctu_size_max_suco_cb_size = bs.read_ue()
        sps.log2_diff_max_suco_min_suco_cb_size = bs.read_ue()
    sps.tool_admvp = bs.read1()
    if main and sps.tool_admvp:
        sps.tool_affine = bs.read1()
        sps.tool_amvr = bs.read1()
        sps.tool_dmvr = bs.read1()
        sps.tool_mmvd = bs.read1()
        sps.tool_hmvp = bs.read1()
    sps.tool_eipd = bs.read1()
    if main and sps.tool_eipd:
        sps.ibc_flag = bs.read1()
        if sps.ibc_flag:
            sps.ibc_log_max_size = bs.read_ue() + 2
    sps.tool_cm_init = bs.read1()
    if main and sps.tool_cm_init:
        sps.tool_adcc = bs.read1()
    sps.tool_iqt = bs.read1()
    if main and sps.tool_iqt:
        sps.tool_ats = bs.read1()
    sps.tool_addb = bs.read1()
    sps.tool_alf = bs.read1()
    sps.tool_htdf = bs.read1()
    sps.tool_rpl = bs.read1()
    sps.tool_pocs = bs.read1()
    sps.dquant_flag = bs.read1()
    sps.tool_dra = bs.read1()
    if main and sps.tool_pocs:
        sps.log2_max_pic_order_cnt_lsb_minus4 = bs.read_ue()
    if not sps.tool_rpl or not sps.tool_pocs:
        sps.log2_sub_gop_length = bs.read_ue()
        if sps.log2_sub_gop_length == 0:
            sps.log2_ref_pic_gap_length = bs.read_ue()
    if not sps.tool_rpl:
        sps.max_num_ref_pics = bs.read_ue()
    elif main:
        sps.sps_max_dec_pic_buffering_minus1 = bs.read_ue()
        sps.long_term_ref_pics_flag = bs.read1()
        sps.rpl1_same_as_rpl0_flag = bs.read1()
        n0 = bs.read_ue()
        for _ in range(n0):
            sps.rpls_l0.append(parse_rlp(bs))
        if not sps.rpl1_same_as_rpl0_flag:
            n1 = bs.read_ue()
            for _ in range(n1):
                sps.rpls_l1.append(parse_rlp(bs))
        else:
            raise MalformedBitstream("rpl1_same_as_rpl0 unsupported (matches reference)")
    sps.picture_cropping_flag = bs.read1()
    if sps.picture_cropping_flag:
        sps.picture_crop_left_offset = bs.read_ue()
        sps.picture_crop_right_offset = bs.read_ue()
        sps.picture_crop_top_offset = bs.read_ue()
        sps.picture_crop_bottom_offset = bs.read_ue()
    if sps.chroma_format_idc != 0:
        cqt = sps.chroma_qp_table
        cqt.present = bool(bs.read1())
        if cqt.present:
            cqt.same_qp_table_for_chroma = bool(bs.read1())
            cqt.global_offset_flag = bool(bs.read1())
            for i in range(1 if cqt.same_qp_table_for_chroma else 2):
                cqt.num_points_in_qp_table_minus1[i] = bs.read_ue()
                for j in range(cqt.num_points_in_qp_table_minus1[i] + 1):
                    cqt.delta_qp_in_val_minus1[i][j] = bs.read(6)
                    cqt.delta_qp_out_val[i][j] = bs.read_se()
    sps.vui_parameters_present_flag = bs.read1()
    if sps.vui_parameters_present_flag:
        _parse_vui(bs, sps)
    bs.align()
    return sps


def _parse_vui(bs: BitReader, sps: Sps):
    """VUI — parsed for position correctness; only reorder depth is kept
    (ref: src_base/xevd_eco.c:1229-1303)."""
    if bs.read1():  # aspect_ratio_info
        idc = bs.read(8)
        if idc == 255:
            bs.read(16)
            bs.read(16)
    if bs.read1():  # overscan_info
        bs.read1()
    if bs.read1():  # video_signal_type
        bs.read(3)
        bs.read1()
        if bs.read1():
            bs.read(8)
            bs.read(8)
            bs.read(8)
    if bs.read1():  # chroma_loc_info
        bs.read_ue()
        bs.read_ue()
    bs.read1()  # neutral_chroma
    bs.read1()  # field_seq
    if bs.read1():  # timing_info
        bs.read(32)
        bs.read(32)
        bs.read1()
    nal_hrd = bs.read1()
    if nal_hrd:
        _parse_hrd(bs)
    vcl_hrd = bs.read1()
    if vcl_hrd:
        _parse_hrd(bs)
    if nal_hrd or vcl_hrd:
        bs.read1()
    bs.read1()  # pic_struct
    sps.bitstream_restriction_flag = bs.read1()
    if sps.bitstream_restriction_flag:
        bs.read1()
        bs.read_ue()
        bs.read_ue()
        bs.read_ue()
        bs.read_ue()
        sps.num_reorder_pics = bs.read_ue()
        bs.read_ue()


def _parse_hrd(bs: BitReader):
    cpb_cnt_minus1 = bs.read_ue()
    bs.read(4)
    bs.read(4)
    for _ in range(cpb_cnt_minus1 + 1):
        bs.read_ue()
        bs.read_ue()
        bs.read1()
    for _ in range(4):
        bs.read(5)


@dataclass
class Pps:
    pps_pic_parameter_set_id: int = 0
    pps_seq_parameter_set_id: int = 0
    num_ref_idx_default_active_minus1: list = field(default_factory=lambda: [0, 0])
    additional_lt_poc_lsb_len: int = 0
    rpl1_idx_present_flag: int = 0
    single_tile_in_pic_flag: int = 1
    tile_id_len_minus1: int = 0
    explicit_tile_id_flag: int = 0
    pic_dra_enabled_flag: int = 0
    pic_dra_aps_id: int = 0
    arbitrary_slice_present_flag: int = 0
    constrained_intra_pred_flag: int = 0
    cu_qp_delta_enabled_flag: int = 0
    cu_qp_delta_area: int = 0
    # tile grid (single-tile defaults; multi-tile for Main)
    num_tile_columns_minus1: int = 0
    num_tile_rows_minus1: int = 0
    uniform_tile_spacing_flag: int = 1
    tile_column_width_minus1: list = field(default_factory=list)
    tile_row_height_minus1: list = field(default_factory=list)
    loop_filter_across_tiles_enabled_flag: int = 0
    tile_offset_lens_minus1: int = 0
    tile_id_val: list = field(default_factory=list)


APS_MAX_NUM_IN_BITS = 5


def parse_pps(bs: BitReader, sps: Sps) -> Pps:
    """Unified PPS (ref: src_base/xevd_eco.c:1396-1432,
    src_main/xevdm_eco.c:2006-2081)."""
    pps = Pps()
    pps.pps_pic_parameter_set_id = bs.read_ue()
    pps.pps_seq_parameter_set_id = bs.read_ue()
    pps.num_ref_idx_default_active_minus1[0] = bs.read_ue()
    pps.num_ref_idx_default_active_minus1[1] = bs.read_ue()
    pps.additional_lt_poc_lsb_len = bs.read_ue()
    pps.rpl1_idx_present_flag = bs.read1()
    pps.single_tile_in_pic_flag = bs.read1()
    if sps.is_main and not pps.single_tile_in_pic_flag:
        pps.num_tile_columns_minus1 = bs.read_ue()
        pps.num_tile_rows_minus1 = bs.read_ue()
        pps.uniform_tile_spacing_flag = bs.read1()
        if not pps.uniform_tile_spacing_flag:
            for _ in range(pps.num_tile_columns_minus1):
                pps.tile_column_width_minus1.append(bs.read_ue())
            for _ in range(pps.num_tile_rows_minus1):
                pps.tile_row_height_minus1.append(bs.read_ue())
        pps.loop_filter_across_tiles_enabled_flag = bs.read1()
        pps.tile_offset_lens_minus1 = bs.read_ue()
    pps.tile_id_len_minus1 = bs.read_ue()
    pps.explicit_tile_id_flag = bs.read1()
    if sps.is_main and pps.explicit_tile_id_flag:
        for _ in range(pps.num_tile_rows_minus1 + 1):
            row = []
            for _ in range(pps.num_tile_columns_minus1 + 1):
                row.append(bs.read(pps.tile_id_len_minus1 + 1))
            pps.tile_id_val.append(row)
    pps.pic_dra_enabled_flag = bs.read1()
    if sps.is_main and pps.pic_dra_enabled_flag:
        pps.pic_dra_aps_id = bs.read(APS_MAX_NUM_IN_BITS)
    pps.arbitrary_slice_present_flag = bs.read1()
    pps.constrained_intra_pred_flag = bs.read1()
    pps.cu_qp_delta_enabled_flag = bs.read1()
    if pps.cu_qp_delta_enabled_flag:
        pps.cu_qp_delta_area = bs.read_ue() + 6
    bs.align()
    return pps


@dataclass
class SliceHeader:
    slice_pic_parameter_set_id: int = 0
    single_tile_in_slice_flag: int = 1
    first_tile_id: int = 0
    arbitrary_slice_flag: int = 0
    last_tile_id: int = 0
    num_remaining_tiles_in_slice_minus1: int = 0
    delta_tile_id_minus1: list = field(default_factory=list)
    slice_type: int = T.SLICE_I
    no_output_of_prior_pics_flag: int = 0
    num_ref_idx_active_override_flag: int = 0
    ref_pic_active_num: list = field(default_factory=lambda: [1, 1])
    deblocking_filter_on: int = 1
    qp: int = 17
    qp_u_offset: int = 0
    qp_v_offset: int = 0
    qp_u: int = 17
    qp_v: int = 17
    entry_point_offset_minus1: list = field(default_factory=list)
    poc_lsb: int = 0
    num_tiles_in_slice: int = 1
    # -- Main-profile fields (ref: src_main/xevdm_eco.c:2510-2809) --
    mmvd_group_enable_flag: int = 0
    alf_on: int = 0
    aps_id_y: int = -1
    aps_id_ch: int = -1
    aps_id_ch2: int = -1
    alf_chroma_idc: int = 0
    alf_is_ctb_alf_on: int = 0
    alf_chroma_map_signalled: int = 0
    alf_chroma2_map_signalled: int = 0
    chroma_alf_enabled_flag: int = 0
    chroma_alf_enabled2_flag: int = 0
    ref_pic_list_sps_flag: list = field(default_factory=lambda: [0, 0])
    rpl_l0_idx: int = -1
    rpl_l1_idx: int = -1
    rpl_l0: RefPicListStruct = None
    rpl_l1: RefPicListStruct = None
    temporal_mvp_asigned_flag: int = 0
    collocated_from_list_idx: int = 1   # SLICE_B default L1? set below
    collocated_mvp_source_list_idx: int = 0
    collocated_from_ref_idx: int = 0
    sh_deblock_alpha_offset: int = 0
    sh_deblock_beta_offset: int = 0


def parse_sh(bs: BitReader, sps: Sps, pps: Pps, nut: int) -> SliceHeader:
    """Unified slice header (ref: src_base/xevd_eco.c:1434-1580,
    src_main/xevdm_eco.c:2510-2809)."""
    sh = SliceHeader()
    sh.slice_pic_parameter_set_id = bs.read_ue()

    if not pps.single_tile_in_pic_flag:
        sh.single_tile_in_slice_flag = bs.read1()
        sh.first_tile_id = bs.read(pps.tile_id_len_minus1 + 1)
    else:
        sh.single_tile_in_slice_flag = 1

    num_tiles_in_slice = 1
    if not sh.single_tile_in_slice_flag:
        if pps.arbitrary_slice_present_flag:
            sh.arbitrary_slice_flag = bs.read1()
        if not sh.arbitrary_slice_flag:
            sh.last_tile_id = bs.read(pps.tile_id_len_minus1 + 1)
        else:
            sh.num_remaining_tiles_in_slice_minus1 = bs.read_ue()
            num_tiles_in_slice = sh.num_remaining_tiles_in_slice_minus1 + 2
            for _ in range(num_tiles_in_slice - 1):
                sh.delta_tile_id_minus1.append(bs.read_ue())

    sh.slice_type = bs.read_ue()

    if not sh.arbitrary_slice_flag:
        w_tile = pps.num_tile_columns_minus1 + 1
        tile_cnt = (pps.num_tile_rows_minus1 + 1) * w_tile
        first, last = sh.first_tile_id, sh.last_tile_id
        delta = last - first
        if last < first:
            delta += tile_cnt + (w_tile if first % w_tile > last % w_tile else 0)
        elif first % w_tile > last % w_tile:
            delta += w_tile
        num_tiles_in_slice = ((delta % w_tile) + 1) * ((delta // w_tile) + 1)

    sh.num_tiles_in_slice = num_tiles_in_slice

    if nut == T.NUT_IDR:
        sh.no_output_of_prior_pics_flag = bs.read1()

    if sps.tool_mmvd and sh.slice_type in (T.SLICE_B, T.SLICE_P):
        sh.mmvd_group_enable_flag = bs.read1()

    if sps.tool_alf:
        sh.alf_on = bs.read1()
        if sh.alf_on:
            sh.aps_id_y = bs.read(5)
            sh.alf_is_ctb_alf_on = bs.read1()   # alf_sh_param map flag
            sh.alf_chroma_idc = bs.read(2)
            sh.chroma_alf_enabled_flag = bool(sh.alf_chroma_idc & 1)
            sh.chroma_alf_enabled2_flag = bool((sh.alf_chroma_idc >> 1) & 1)
            if sh.alf_chroma_idc and sps.chroma_format_idc in (1, 2):
                sh.aps_id_ch = bs.read(5)
        if sps.chroma_format_idc == 3 and sh.chroma_alf_enabled_flag:
            sh.aps_id_ch = bs.read(5)
            sh.alf_chroma_map_signalled = bs.read1()
        if sps.chroma_format_idc == 3 and sh.chroma_alf_enabled2_flag:
            sh.aps_id_ch2 = bs.read(5)
            sh.alf_chroma2_map_signalled = bs.read1()

    if nut != T.NUT_IDR:
        if sps.tool_pocs:
            sh.poc_lsb = bs.read(sps.log2_max_pic_order_cnt_lsb_minus4 + 4)
        if sps.tool_rpl:
            sh.ref_pic_list_sps_flag[0] = bs.read1() if sps.rpls_l0 else 0
            if sh.ref_pic_list_sps_flag[0]:
                if len(sps.rpls_l0) > 1:
                    sh.rpl_l0_idx = bs.read_ue()
                else:
                    sh.rpl_l0_idx = 0
                import copy
                sh.rpl_l0 = copy.deepcopy(sps.rpls_l0[sh.rpl_l0_idx])
            else:
                sh.rpl_l0 = parse_rlp(bs)
            if pps.rpl1_idx_present_flag:
                sh.ref_pic_list_sps_flag[1] = bs.read1() if sps.rpls_l1 else 0
            else:
                sh.ref_pic_list_sps_flag[1] = sh.ref_pic_list_sps_flag[0]
            if sh.ref_pic_list_sps_flag[1]:
                if pps.rpl1_idx_present_flag:
                    if len(sps.rpls_l1) > 1:
                        sh.rpl_l1_idx = bs.read_ue()
                    else:
                        sh.rpl_l1_idx = 0
                else:
                    sh.rpl_l1_idx = sh.rpl_l0_idx
                import copy
                sh.rpl_l1 = copy.deepcopy(sps.rpls_l1[sh.rpl_l1_idx])
            else:
                sh.rpl_l1 = parse_rlp(bs)

    if sh.slice_type != T.SLICE_I:
        sh.num_ref_idx_active_override_flag = bs.read1()
        if sh.num_ref_idx_active_override_flag:
            sh.ref_pic_active_num[0] = bs.read_ue() + 1
            if sh.slice_type == T.SLICE_B:
                sh.ref_pic_active_num[1] = bs.read_ue() + 1
        else:
            sh.ref_pic_active_num[0] = pps.num_ref_idx_default_active_minus1[0] + 1
            sh.ref_pic_active_num[1] = pps.num_ref_idx_default_active_minus1[1] + 1
        if sh.rpl_l0 is not None:
            sh.rpl_l0.ref_pic_active_num = sh.ref_pic_active_num[0]
        if sh.rpl_l1 is not None:
            sh.rpl_l1.ref_pic_active_num = sh.ref_pic_active_num[1]

        if sps.tool_admvp:
            sh.temporal_mvp_asigned_flag = bs.read1()
            if sh.temporal_mvp_asigned_flag:
                if sh.slice_type == T.SLICE_B:
                    sh.collocated_from_list_idx = bs.read1()
                    sh.collocated_mvp_source_list_idx = bs.read1()
                sh.collocated_from_ref_idx = bs.read1()

    sh.deblocking_filter_on = bs.read1()
    if sh.deblocking_filter_on and sps.tool_addb:
        sh.sh_deblock_alpha_offset = bs.read_se()
        sh.sh_deblock_beta_offset = bs.read_se()
    sh.qp = bs.read(6)
    if sh.qp < 0 or sh.qp > 51:
        raise MalformedBitstream("slice qp out of range")
    sh.qp_u_offset = bs.read_se()
    sh.qp_v_offset = bs.read_se()
    sh.qp_u = _clip3(-6 * sps.bit_depth_luma_minus8, 57, sh.qp + sh.qp_u_offset)
    sh.qp_v = _clip3(-6 * sps.bit_depth_luma_minus8, 57, sh.qp + sh.qp_v_offset)

    if not sh.single_tile_in_slice_flag:
        for _ in range(num_tiles_in_slice - 1):
            sh.entry_point_offset_minus1.append(bs.read(pps.tile_offset_lens_minus1 + 1))

    while not bs.is_byte_aligned():
        if bs.read1() != 0:
            raise MalformedBitstream("nonzero slice-header align bit")
    return sh


def _clip3(lo, hi, v):
    return lo if v < lo else (hi if v > hi else v)


@dataclass
class SeiMessage:
    payload_type: int
    payload: bytes


def parse_sei(bs: BitReader, num_planes: int):
    """SEI NALU → (picture-signature or None, list of other payloads)
    (ref: src_base/xevd_eco.c:1617-1679)."""
    signature = None
    others = []
    while True:
        ptype = 0
        while True:
            v = bs.read(8)
            ptype += v
            if v != 0xFF:
                break
        psize = 0
        while True:
            v = bs.read(8)
            psize += v
            if v != 0xFF:
                break
        if ptype == 0x10:  # XEVD_UD_PIC_SIGNATURE
            sig = []
            for _ in range(num_planes):
                sig.append(bytes(bs.read(8) for _ in range(psize)))
            signature = sig
        else:
            others.append(SeiMessage(ptype, bytes(bs.read(8) for _ in range(psize))))
        if bs.size - bs.bytes_read() <= 1:
            break
    return signature, others

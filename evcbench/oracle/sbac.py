"""EVC SBAC binary arithmetic decoder (host side).

The EVC arithmetic coder is a 512-state adaptive engine with a 16-bit value
window and range in [8192, 16384) (ref: src_base/xevd_eco.c:35-164).  This
module holds the pure-Python engine; context-model layout for Baseline is in
`SbacCtx`.  Per-frame entropy decode is the only bit-serial stage of the
decoder and runs on host; everything downstream is batched device work.
"""
from __future__ import annotations

from . import trace as _trace

from .bitstream import BitReader

PROB_INIT = 512  # state=256, mps=0  (ref: src_base/xevd_def.h:76)


def _cm_init_model(init_value: int, qp: int) -> int:
    """CM_INIT model seed: 16-bit packed (slope, offset) linear-in-QP state
    (ref: src_base/xevd_util.c:1243-1275)."""
    slope = (init_value & 14) << 4
    if init_value & 1:
        slope = -slope
    offset = ((init_value >> 4) & 62) << 7
    if (init_value >> 4) & 1:
        offset = -offset
    offset += 4096
    state = min(511, max(1, (slope * qp + offset) >> 4))
    if state > 256:
        return ((512 - state) << 1)        # mps = 0
    return (state << 1) + 1                # mps = 1

# Context counts, Baseline subset (ref: src_base/xevd_def.h:441-475)
NUM_CTX_SKIP_FLAG = 2
NUM_CTX_CBF_LUMA = 1
NUM_CTX_CBF_CB = 1
NUM_CTX_CBF_CR = 1
NUM_CTX_CBF_ALL = 1
NUM_CTX_PRED_MODE = 3
NUM_CTX_INTER_PRED_IDC = 2
NUM_CTX_DIRECT_MODE_FLAG = 1
NUM_CTX_MERGE_MODE_FLAG = 1
NUM_CTX_REF_IDX = 2
NUM_CTX_MERGE_IDX = 5
NUM_CTX_MVP_IDX = 3
NUM_CTX_BI_PRED_IDX = 2
NUM_CTX_MVD = 1
NUM_CTX_INTRA_PRED_MODE = 2
NUM_CTX_INTRA_LUMA_PRED_MPM_FLAG = 1
NUM_CTX_INTRA_LUMA_PRED_MPM_IDX = 1
NUM_CTX_INTRA_CHROMA_PRED_MODE = 1
NUM_CTX_CC_RUN = 24
NUM_CTX_CC_LAST = 2
NUM_CTX_CC_LEVEL = 24
NUM_CTX_SPLIT_CU_FLAG = 1
NUM_CTX_DELTA_QP = 1

# Main-profile context counts (ref: src_base/xevd_def.h:441-507)
NUM_CTX_LAST_SIG_COEFF = 21
NUM_CTX_SIG_COEFF_FLAG = 47
NUM_CTX_GTX = 18
NUM_CTX_MMVD_FLAG = 1
NUM_CTX_MMVD_GROUP_IDX = 2
NUM_CTX_MMVD_MERGE_IDX = 3
NUM_CTX_MMVD_DIST_IDX = 7
NUM_CTX_MMVD_DIRECTION_IDX = 2
NUM_CTX_AFFINE_MVD_FLAG = 2
NUM_CTX_IBC_FLAG = 2
NUM_CTX_BTT_SPLIT_FLAG = 15
NUM_CTX_BTT_SPLIT_DIR = 5
NUM_CTX_BTT_SPLIT_TYPE = 1
NUM_CTX_SUCO_FLAG = 14
NUM_CTX_MODE_CONS = 3
NUM_CTX_AMVR_IDX = 4
NUM_CTX_AFFINE_FLAG = 2
NUM_CTX_AFFINE_MODE = 1
NUM_CTX_AFFINE_MRG = 5
NUM_CTX_AFFINE_MVP_IDX = 1
NUM_CTX_ALF_CTB_FLAG = 1
NUM_CTX_ATS_MODE_FLAG = 1
NUM_CTX_ATS_INTER_FLAG = 2
NUM_CTX_ATS_INTER_QUAD_FLAG = 1
NUM_CTX_ATS_INTER_HOR_FLAG = 3
NUM_CTX_ATS_INTER_POS_FLAG = 1


class SbacCtx:
    """Adaptive context models, Baseline + Main
    (ref: src_base/xevd_eco.c:743-793, src_main/xevdm_eco.c:986-1118)."""

    FIELDS = [
        ("skip_flag", NUM_CTX_SKIP_FLAG),
        ("direct_mode_flag", NUM_CTX_DIRECT_MODE_FLAG),
        ("merge_mode_flag", NUM_CTX_MERGE_MODE_FLAG),
        ("inter_dir", NUM_CTX_INTER_PRED_IDC),
        ("intra_dir", NUM_CTX_INTRA_PRED_MODE),
        ("intra_luma_pred_mpm_flag", NUM_CTX_INTRA_LUMA_PRED_MPM_FLAG),
        ("intra_luma_pred_mpm_idx", NUM_CTX_INTRA_LUMA_PRED_MPM_IDX),
        ("intra_chroma_pred_mode", NUM_CTX_INTRA_CHROMA_PRED_MODE),
        ("pred_mode", NUM_CTX_PRED_MODE),
        ("refi", NUM_CTX_REF_IDX),
        ("merge_idx", NUM_CTX_MERGE_IDX),
        ("mvp_idx", NUM_CTX_MVP_IDX),
        ("bi_idx", NUM_CTX_BI_PRED_IDX),
        ("mvd", NUM_CTX_MVD),
        ("cbf_all", NUM_CTX_CBF_ALL),
        ("cbf_luma", NUM_CTX_CBF_LUMA),
        ("cbf_cb", NUM_CTX_CBF_CB),
        ("cbf_cr", NUM_CTX_CBF_CR),
        ("run", NUM_CTX_CC_RUN),
        ("last", NUM_CTX_CC_LAST),
        ("level", NUM_CTX_CC_LEVEL),
        ("split_cu_flag", NUM_CTX_SPLIT_CU_FLAG),
        ("delta_qp", NUM_CTX_DELTA_QP),
        # -- Main-profile models --
        ("last_sig_coeff_x_prefix", NUM_CTX_LAST_SIG_COEFF),
        ("last_sig_coeff_y_prefix", NUM_CTX_LAST_SIG_COEFF),
        ("sig_coeff_flag", NUM_CTX_SIG_COEFF_FLAG),
        ("coeff_abs_level_greaterAB_flag", NUM_CTX_GTX),
        ("mmvd_flag", NUM_CTX_MMVD_FLAG),
        ("mmvd_merge_idx", NUM_CTX_MMVD_MERGE_IDX),
        ("mmvd_distance_idx", NUM_CTX_MMVD_DIST_IDX),
        ("mmvd_direction_idx", NUM_CTX_MMVD_DIRECTION_IDX),
        ("mmvd_group_idx", NUM_CTX_MMVD_GROUP_IDX),
        ("mode_cons", NUM_CTX_MODE_CONS),
        ("affine_mvp_idx", NUM_CTX_AFFINE_MVP_IDX),
        ("mvr_idx", NUM_CTX_AMVR_IDX),
        ("btt_split_flag", NUM_CTX_BTT_SPLIT_FLAG),
        ("btt_split_dir", NUM_CTX_BTT_SPLIT_DIR),
        ("btt_split_type", NUM_CTX_BTT_SPLIT_TYPE),
        ("suco_flag", NUM_CTX_SUCO_FLAG),
        ("alf_ctb_flag", NUM_CTX_ALF_CTB_FLAG),
        ("affine_flag", NUM_CTX_AFFINE_FLAG),
        ("affine_mode", NUM_CTX_AFFINE_MODE),
        ("affine_mrg", NUM_CTX_AFFINE_MRG),
        ("affine_mvd_flag", NUM_CTX_AFFINE_MVD_FLAG),
        ("ibc_flag", NUM_CTX_IBC_FLAG),
        ("ats_mode", NUM_CTX_ATS_MODE_FLAG),
        ("ats_cu_inter_flag", NUM_CTX_ATS_INTER_FLAG),
        ("ats_cu_inter_quad_flag", NUM_CTX_ATS_INTER_QUAD_FLAG),
        ("ats_cu_inter_hor_flag", NUM_CTX_ATS_INTER_HOR_FLAG),
        ("ats_cu_inter_pos_flag", NUM_CTX_ATS_INTER_POS_FLAG),
    ]

    # context fields with a non-default table name in tables_cabac_init
    _INIT_ALIAS = {"delta_qp": "dqp"}

    def __init__(self):
        for name, n in self.FIELDS:
            setattr(self, name, [PROB_INIT] * n)
        self.ats_intra_cu = [PROB_INIT]  # Main-only ctx (xevdm_eco.c:354)

    def reset(self, slice_type: int = 0, slice_qp: int = 0,
              cm_init: bool = False):
        """Reset all models; with CM_INIT, seed from the normative
        slice-type/QP linear model (ref: src_base/xevd_util.c:1243-1275,
        src_main/xevdm_eco.c:1010-1064)."""
        if not cm_init:
            for name, n in self.FIELDS:
                setattr(self, name, [PROB_INIT] * n)
            self.ats_intra_cu = [PROB_INIT]
            return
        from . import tables_cabac_init as CI
        qp = min(51, max(0, slice_qp))
        is_b = 1 if slice_type == 0 else 0  # SLICE_B == 0 (tables.py)
        for name, n in self.FIELDS:
            tbl = getattr(CI, "init_" + self._INIT_ALIAS.get(name, name))
            row = tbl[is_b]
            setattr(self, name, [_cm_init_model(row[i], qp) for i in range(n)])
        self.ats_intra_cu = [_cm_init_model(CI.init_ats_intra_cu[is_b][0], qp)]


class Sbac:
    """The arithmetic decoding engine (ref: src_base/xevd_eco.c:35-164)."""

    __slots__ = ("range", "value", "ctx", "bs")

    def __init__(self, bs: BitReader):
        self.bs = bs
        self.range = 16384
        self.value = 0
        self.ctx = SbacCtx()

    def reset(self, bs: BitReader, slice_type: int = 0, slice_qp: int = 0,
              cm_init: bool = False):
        """Per-tile SBAC reset: range=2^14, preload 14 bits
        (ref: src_base/xevd_eco.c:743-764, src_main/xevdm_eco.c:986-1118)."""
        self.bs = bs
        self.range = 16384
        value = 0
        for _ in range(14):
            value = ((value << 1) | bs.read1()) & 0xFFFF
        self.value = value
        self.ctx.reset(slice_type, slice_qp, cm_init)

    def decode_bin(self, model: list, i: int) -> int:
        m = model[i]
        state = m >> 1
        mps = m & 1
        lps = (state * self.range) >> 9
        if lps < 437:
            lps = 437
        self.range -= lps
        if self.value >= self.range:
            bin_ = 1 - mps
            self.value -= self.range
            self.range = lps
            state = state + ((512 - state + 16) >> 5)
            if state > 256:
                mps = 1 - mps
                state = 512 - state
            model[i] = (state << 1) + mps
        else:
            bin_ = mps
            state = state - ((state + 16) >> 5)
            model[i] = (state << 1) + mps
        rng = self.range
        if rng < 8192:
            bs = self.bs
            value = self.value
            while rng < 8192:
                rng <<= 1
                value = ((value << 1) | bs.read1()) & 0xFFFF
            self.range = rng
            self.value = value
        if _trace._fp is not None and _trace._bins:
            _trace.line(f"bin {bin_}")
        return bin_

    def decode_bin_ep(self) -> int:
        self.range >>= 1
        if self.value >= self.range:
            bin_ = 1
            self.value -= self.range
        else:
            bin_ = 0
        self.range <<= 1
        self.value = ((self.value << 1) | self.bs.read1()) & 0xFFFF
        return bin_

    def decode_bins_ep(self, num: int) -> int:
        v = 0
        for _ in range(num):
            v = (v << 1) | self.decode_bin_ep()
        return v

    def decode_bin_trm(self) -> int:
        """Terminating bin (tile end flag)
        (ref: src_base/xevd_eco.c:123-164)."""
        self.range -= 1
        if self.value >= self.range:
            # byte-align; padding bits must be zero
            while not self.bs.is_byte_aligned():
                if self.bs.read1() != 0:
                    raise ValueError("malformed: nonzero SBAC align bit")
            return 1
        while self.range < 8192:
            self.range <<= 1
            self.value = ((self.value << 1) | self.bs.read1()) & 0xFFFF
        return 0

    # -- composite readers (ref: src_base/xevd_eco.c:166-253) --

    def read_unary_sym_ep(self, max_val: int) -> int:
        sym = self.decode_bin_ep()
        if sym == 0:
            return 0
        sym = 0
        counter = 1
        t = 1
        while t:
            t = 0 if counter == max_val else self.decode_bin_ep()
            counter += 1
            sym += 1
        return sym

    def read_unary_sym(self, model: list, base: int, num_ctx: int) -> int:
        sym = self.decode_bin(model, base)
        if sym == 0:
            return 0
        sym = 0
        ctx_idx = 0
        while True:
            if ctx_idx < num_ctx - 1:
                ctx_idx += 1
            t = self.decode_bin(model, base + ctx_idx)
            sym += 1
            if not t:
                break
        return sym

    def read_truncate_unary_sym(self, model: list, num_ctx: int, max_num: int) -> int:
        ctx_idx = 0
        if max_num > 1:
            while ctx_idx < max_num - 1:
                sym = self.decode_bin(model, min(ctx_idx, num_ctx - 1))
                if sym == 0:
                    break
                ctx_idx += 1
        return ctx_idx

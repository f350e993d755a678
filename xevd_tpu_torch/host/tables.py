"""Constant tables of MPEG-5 EVC (ISO/IEC 23094-1), Baseline profile.

These are normative constants of the EVC specification; the authoritative
values were cross-checked against the reference decoder's tables
(ref: src_base/xevd_tbl.c:89-352, src_base/xevd_mc.c:80-134).
"""
from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Geometry constants (ref: src_base/xevd_def.h:188-211)
# ---------------------------------------------------------------------------
MAX_CU_LOG2 = 7
MIN_CU_LOG2 = 2
MAX_CU_SIZE = 1 << MAX_CU_LOG2
MIN_CU_SIZE = 1 << MIN_CU_LOG2
MAX_TR_LOG2 = 6
MAX_TR_SIZE = 1 << MAX_TR_LOG2
PIC_PAD_SIZE_L = MAX_CU_SIZE + 16      # 144
PIC_PAD_SIZE_C = PIC_PAD_SIZE_L >> 1

# Baseline CTU geometry (ref: src_base/xevd.c:252-255)
CTU_LOG2_B = 6
CTU_SIZE_B = 1 << CTU_LOG2_B

# Slice types (ref: inc/xevd.h:180-183)
SLICE_B = 0
SLICE_P = 1
SLICE_I = 2

# Prediction modes (ref: src_base/xevd_def.h:284-300)
MODE_INTRA = 0
MODE_INTER = 1
MODE_SKIP = 2
MODE_DIR = 3
MODE_IBC = 6      # (ref: src_main/xevdm_def.h:281)
PRED_L0 = 0
PRED_L1 = 1
PRED_BI = 2
PRED_DIR = 4

# Intra prediction modes, Baseline (ref: src_base/xevd_def.h:332-347)
IPD_DC_B = 0
IPD_HOR_B = 1
IPD_VER_B = 2
IPD_UL_B = 3
IPD_UR_B = 4
IPD_CNT_B = 5

# Intra prediction modes, Main EIPD (ref: src_base/xevd_def.h:318-355)
IPD_DC = 0
IPD_PLN = 1
IPD_BI = 2
IPD_VER = 12
IPD_HOR = 24
IPD_DIA_R = 18
IPD_DIA_L = 6
IPD_DIA_U = 30
IPD_CNT = 33
IPD_DM_C = 0
IPD_BI_C = 1
IPD_DC_C = 2
IPD_HOR_C = 3
IPD_VER_C = 4
IPD_CHROMA_CNT = 5
INTRA_MPM_NUM = 2
INTRA_PIMS_NUM = 8

# Angular prediction {dx/dy, dy/dx} in Q10/Q5 fixed point
# (ref: src_base/xevd_tbl.c:294-305)
IPRED_DXDY = np.array([
    [0, 0],
    [0, 0], [0, 0], [2816, 372], [2048, 512], [1408, 744],
    [1024, 1024], [744, 1408], [512, 2048], [372, 2816], [256, 4096],
    [128, 8192], [0, 0], [128, 8192], [256, 4096], [372, 2816],
    [512, 2048], [744, 1408], [1024, 1024], [1408, 744], [2048, 512],
    [2816, 372], [4096, 256], [8192, 128], [0, 0], [8192, 128],
    [4096, 256], [2816, 372], [2048, 512], [1408, 744], [1024, 1024],
    [744, 1408], [512, 2048],
], dtype=np.int64)

# 4-tap ADI interpolation filter (ref: src_base/xevd_tbl.c:257-292)
IPRED_ADI = np.array([[32 - i, 64 - i, 32 + i, i] for i in range(32)],
                     dtype=np.int64)

# Default intra mode priority list (ref: src_main/xevdm_ipred.c:307-318)
INTRA_MODE_LIST = [
    IPD_DC, IPD_BI, IPD_VER, IPD_PLN, IPD_HOR,
    IPD_VER - 1, IPD_VER + 1, IPD_VER - 2, IPD_VER + 2, IPD_VER - 3,
    IPD_VER + 3,
    IPD_HOR - 1, IPD_HOR + 1, IPD_HOR - 2, IPD_HOR + 2, IPD_HOR - 3,
    IPD_HOR + 3,
    IPD_DIA_R,
    IPD_DIA_L, IPD_DIA_L - 3, IPD_DIA_L - 2, IPD_DIA_L - 1,
    IPD_DIA_U, IPD_DIA_U + 1, IPD_DIA_U + 2,
    IPD_VER + 5, IPD_VER + 4,
    IPD_HOR - 4, IPD_HOR - 5,
    IPD_VER - 5, IPD_VER - 4,
    IPD_HOR + 5, IPD_HOR + 4,
]

REFP_NUM = 2
MV_D = 2
REFI_INVALID = -1

# NAL unit types (ref: inc/xevd.h:134-140)
NUT_NONIDR = 0
NUT_IDR = 1
NUT_SPS = 24
NUT_PPS = 25
NUT_APS = 26
NUT_FD = 27
NUT_SEI = 28

# quant (ref: src_base/xevd_def.h:572-573)
QUANT_SHIFT = 14
QUANT_IQUANT_SHIFT = 20
MAX_TX_DYNAMIC_RANGE = 15
MAX_TX_VAL = (1 << MAX_TX_DYNAMIC_RANGE) - 1
MIN_TX_VAL = -(1 << MAX_TX_DYNAMIC_RANGE)

# DPB (ref: src_base/xevd_def.h:221-230,600-601)
MAX_NUM_REF_PICS = 21
MAX_NUM_ACTIVE_REF_FRAME = 5
DELAYED_FRAME = 1
EXTRA_FRAME = MAX_NUM_ACTIVE_REF_FRAME + DELAYED_FRAME
MAX_PB_SIZE = MAX_NUM_REF_PICS + EXTRA_FRAME
MAX_NUM_MVP = 4

MC_PRECISION = 4  # 1/16-pel internal motion precision

# ---------------------------------------------------------------------------
# Inverse-DCT2 basis matrices, sizes 2..64.  tm[k][i] = basis value of
# frequency k at spatial position i (ref: src_base/xevd_tbl.c:89-241).
# The full 2^n family is generated from the 64-point kernel by the standard
# even-entry sub-sampling relation: tmN[k][i] = tm64[k*(64//N)][i].
# ---------------------------------------------------------------------------
_TM64_ROW0 = [
    64, 90, 90, 90, 90, 90, 90, 89, 89, 88, 88, 87, 87, 86, 85, 84,
    84, 83, 82, 81, 80, 79, 78, 76, 75, 74, 73, 71, 70, 69, 67, 66,
    64, 62, 61, 59, 57, 56, 54, 52, 50, 48, 47, 45, 43, 41, 39, 37,
    35, 33, 30, 28, 26, 24, 22, 20, 18, 15, 13, 11, 9, 7, 4, 2,
]


def _gen_tm64() -> np.ndarray:
    """Generate the 64-point DCT-2 integer basis from its first column.

    The EVC integer DCT-2 matrix satisfies tm[k][i] =
    round(scale * cos(pi*k*(2i+1)/128)) with per-frequency integer values
    matching column 0; the exact table is reproduced via the cosine
    symmetry of the first column entries.
    """
    tm = np.zeros((64, 64), dtype=np.int32)
    # col0[k] = tm[k][0] given by _TM64_ROW0
    # Other entries follow from tm[k][i] = sgn * col0[(k*(2i+1)) mod 256 folded]
    # Use the standard folding of the cosine argument:
    for k in range(64):
        for i in range(64):
            a = (k * (2 * i + 1)) % 256  # angle index in units of pi/128
            # fold into [0,64] with sign
            if a > 128:
                a = 256 - a
            if a > 64:
                sgn = -1
                a = 128 - a
            else:
                sgn = 1
            tm[k, i] = sgn * _TM64_ROW0[a] if a < 64 else 0
    return tm


TM64 = _gen_tm64()
TM32 = TM64[::2, :32].copy()
TM16 = TM64[::4, :16].copy()
TM8 = TM64[::8, :8].copy()
TM4 = TM64[::16, :4].copy()
TM2 = TM64[::32, :2].copy()
TM = {1: TM2, 2: TM4, 3: TM8, 4: TM16, 5: TM32, 6: TM64}

# Dequant scales (ref: src_base/xevd_tbl.c:255-256)
DQ_SCALE = np.array([40, 45, 51, 57, 64, 72], dtype=np.int32)
DQ_SCALE_B = np.array([40, 45, 51, 57, 64, 71], dtype=np.int32)

# ---------------------------------------------------------------------------
# Deblocking strength table by QP (ref: src_base/xevd_tbl.c:306-324)
# ---------------------------------------------------------------------------
DF_ST = np.array([
    # intra
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1,
     1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10,
     11, 12, 12, 12, 12, 12],
    # non-zero luma coeff
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 1, 1, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 5, 5, 6, 7, 8, 9,
     10, 11, 11, 11, 11, 11],
    # no coeff & |mvd| >= 4 (quarter-pel units)
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 4, 4, 5, 6, 7, 8,
     9, 10, 10, 10, 10, 10],
    # no deblock
    [0] * 52,
], dtype=np.int32)

# ---------------------------------------------------------------------------
# MPM table: mpm[ipm_left][ipm_up] is a permutation of the 5 baseline modes
# (ref: src_base/xevd_tbl.c:46-54).  Index 0 in each axis = "unavailable".
# ---------------------------------------------------------------------------
MPM_B = np.array([
    [[0, 2, 3, 1, 4], [0, 2, 1, 3, 4], [0, 2, 1, 3, 4], [1, 2, 0, 3, 4], [0, 2, 1, 3, 4], [0, 1, 2, 3, 4]],
    [[1, 0, 2, 3, 4], [0, 1, 2, 3, 4], [0, 1, 2, 3, 4], [1, 2, 0, 3, 4], [0, 1, 3, 2, 4], [0, 2, 1, 4, 3]],
    [[1, 0, 2, 3, 4], [1, 0, 2, 3, 4], [1, 0, 2, 3, 4], [2, 0, 1, 3, 4], [1, 0, 3, 2, 4], [0, 1, 2, 4, 3]],
    [[1, 0, 2, 3, 4], [0, 2, 1, 3, 4], [1, 0, 2, 3, 4], [1, 2, 0, 3, 4], [0, 1, 2, 3, 4], [0, 2, 1, 4, 3]],
    [[0, 1, 2, 3, 4], [0, 3, 2, 1, 4], [1, 0, 2, 3, 4], [1, 2, 0, 3, 4], [1, 2, 3, 0, 4], [0, 2, 1, 4, 3]],
    [[0, 1, 2, 3, 4], [0, 1, 2, 4, 3], [0, 1, 2, 4, 3], [0, 2, 1, 4, 3], [0, 1, 2, 3, 4], [0, 1, 2, 4, 3]],
], dtype=np.int32)

# ---------------------------------------------------------------------------
# Motion-compensation filter taps
# (ref: src_base/xevd_mc.c:80-134). Index = fractional phase.
# ---------------------------------------------------------------------------
MC_L_COEFF = np.zeros((16, 8), dtype=np.int32)
MC_L_COEFF[0] = [0, 0, 0, 64, 0, 0, 0, 0]
MC_L_COEFF[4] = [0, 1, -5, 52, 20, -5, 1, 0]
MC_L_COEFF[8] = [0, 2, -10, 40, 40, -10, 2, 0]
MC_L_COEFF[12] = [0, 1, -5, 20, 52, -5, 1, 0]

MC_C_COEFF = np.zeros((32, 4), dtype=np.int32)
MC_C_COEFF[0] = [0, 64, 0, 0]
MC_C_COEFF[4] = [-2, 58, 10, -2]
MC_C_COEFF[8] = [-4, 52, 20, -4]
MC_C_COEFF[12] = [-6, 46, 30, -6]
MC_C_COEFF[16] = [-8, 40, 40, -8]
MC_C_COEFF[20] = [-6, 30, 46, -6]
MC_C_COEFF[24] = [-4, 20, 52, -4]
MC_C_COEFF[28] = [-2, 10, 58, -2]

# ---------------------------------------------------------------------------
# Chroma QP adjust tables (ref: src_base/xevd_tbl.c:334-352)
# ---------------------------------------------------------------------------
QP_CHROMA_ADJUST_BASE = np.array([
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9,
    10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
    29, 29, 30, 31, 32, 32, 33, 33, 34, 34,
    35, 35, 36, 36, 36, 37, 37, 37, 38, 38,
    39, 39, 40, 40, 40, 41, 41, 41], dtype=np.int32)

QP_CHROMA_ADJUST_MAIN = np.array([
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9,
    10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37,
    38, 39, 40, 40, 41, 42, 43, 44, 45, 46,
    47, 48, 49, 50, 51, 52, 53, 54], dtype=np.int32)

MAX_QP_TABLE_SIZE = 58
MAX_QP_TABLE_SIZE_EXT = 94


def build_chroma_qp_tables(bit_depth_chroma: int,
                           chroma_qp_table=None,
                           base_profile: bool = True) -> np.ndarray:
    """Build the dynamic chroma QP mapping table, indexed by
    qp_i + 6*(bd-8) (we store with offset so index 0 == qp -6*(bd-8)).

    Returns array of shape [2, MAX_QP_TABLE_SIZE_EXT] where entry
    [c][qp + qp_bd_offset] = mapped chroma qp (before +6*(bd-8) add).
    (ref: src_base/xevd_tbl.c:363-425, src_base/xevd.c:347-358)
    """
    qp_bd_offset = 6 * (bit_depth_chroma - 8)
    tbl = np.zeros((2, MAX_QP_TABLE_SIZE_EXT), dtype=np.int32)
    for c in range(2):
        for i in range(qp_bd_offset):
            tbl[c, i] = i - qp_bd_offset
    adjust = QP_CHROMA_ADJUST_BASE if base_profile else QP_CHROMA_ADJUST_MAIN
    if chroma_qp_table is None or not chroma_qp_table.present:
        for c in range(2):
            tbl[c, qp_bd_offset:qp_bd_offset + MAX_QP_TABLE_SIZE] = adjust
    else:
        _derive_signalled_chroma_qp(tbl, chroma_qp_table, bit_depth_chroma)
    return tbl


def _derive_signalled_chroma_qp(tbl, cqt, bit_depth):
    """Piecewise-linear signalled chroma QP tables
    (ref: src_base/xevd_tbl.c:375-425)."""
    MAX_QP = MAX_QP_TABLE_SIZE - 1
    qp_bd_offset = 6 * (bit_depth - 8)
    start_qp = 16 if cqt.global_offset_flag else -qp_bd_offset
    num_tables = 1 if cqt.same_qp_table_for_chroma else 2

    def T(c, qp):  # map qp in [-qp_bd_offset, MAX_QP] to index
        return (c, qp + qp_bd_offset)

    for i in range(num_tables):
        n = cqt.num_points_in_qp_table_minus1[i]
        qp_in = [0] * (n + 1)
        qp_out = [0] * (n + 1)
        qp_in[0] = start_qp + cqt.delta_qp_in_val_minus1[i][0]
        qp_out[0] = start_qp + cqt.delta_qp_in_val_minus1[i][0] + cqt.delta_qp_out_val[i][0]
        for j in range(1, n + 1):
            qp_in[j] = qp_in[j - 1] + cqt.delta_qp_in_val_minus1[i][j] + 1
            qp_out[j] = qp_out[j - 1] + (cqt.delta_qp_in_val_minus1[i][j] + 1 + cqt.delta_qp_out_val[i][j])
        tbl[T(i, qp_in[0])] = qp_out[0]
        for k in range(qp_in[0] - 1, -qp_bd_offset - 1, -1):
            tbl[T(i, k)] = np.clip(tbl[T(i, k + 1)] - 1, -qp_bd_offset, MAX_QP)
        for j in range(n):
            sh = (cqt.delta_qp_in_val_minus1[i][j + 1] + 1) >> 1
            m = 1
            for k in range(qp_in[j] + 1, qp_in[j + 1] + 1):
                tbl[T(i, k)] = tbl[T(i, qp_in[j])] + (
                    (qp_out[j + 1] - qp_out[j]) * m + sh) // (cqt.delta_qp_in_val_minus1[i][j + 1] + 1)
                m += 1
        for k in range(qp_in[n] + 1, MAX_QP + 1):
            tbl[T(i, k)] = np.clip(tbl[T(i, k - 1)] + 1, -qp_bd_offset, MAX_QP)
    if cqt.same_qp_table_for_chroma:
        tbl[1] = tbl[0]


# ---------------------------------------------------------------------------
# Zigzag scan tables (ref: src_base/xevd_util.c:1004-1047)
# ---------------------------------------------------------------------------
def zigzag_scan(size_x: int, size_y: int) -> np.ndarray:
    """scan[pos] = raster index of the pos-th coefficient in zigzag order."""
    scan = np.zeros(size_x * size_y, dtype=np.int32)
    pos = 1
    scan[0] = 0
    for l in range(1, size_x + size_y - 1):
        if l % 2:  # decreasing x
            x = min(l, size_x - 1)
            y = max(0, l - (size_x - 1))
            while x >= 0 and y < size_y:
                scan[pos] = y * size_x + x
                pos += 1
                x -= 1
                y += 1
        else:
            y = min(l, size_y - 1)
            x = max(0, l - (size_y - 1))
            while y >= 0 and x < size_x:
                scan[pos] = y * size_x + x
                pos += 1
                x += 1
                y -= 1
    return scan


SCAN_TBL = {}
for _ly in range(1, MAX_CU_LOG2):
    for _lx in range(1, MAX_CU_LOG2):
        SCAN_TBL[(_lx, _ly)] = zigzag_scan(1 << _lx, 1 << _ly)

TBL_LOG2 = np.zeros(257, dtype=np.int32)
for _i in range(2, 257):
    TBL_LOG2[_i] = int(np.log2(_i))


# ---------------------------------------------------------------------------
# ADCC (advanced coefficient coding) constants
# (ref: src_main/xevdm_tbl.c:390-402, src_main/xevdm_def.h:239-252)
# ---------------------------------------------------------------------------
LOG2_CG_SIZE = 4
CAFLAG_NUMBER = 8
ADCC_GROUP_IDX = [0, 1, 2, 3, 4, 4, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7,
                  8, 8, 8, 8, 8, 8, 8, 8, 9, 9, 9, 9, 9, 9, 9, 9,
                  10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10,
                  10, 10, 10, 10, 11, 11, 11, 11, 11, 11, 11, 11,
                  11, 11, 11, 11, 11, 11, 11, 11]
ADCC_MIN_IN_GROUP = [0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96]
ADCC_GO_RICE_RANGE = [6, 5, 6, 3, 3, 3, 3, 3, 3, 3]
ADCC_GO_RICE_PARA = [0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1,
                     2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 3, 3, 3]
NUM_CTX_LAST_SIG_COEFF_LUMA = 18
NUM_CTX_SIG_COEFF_LUMA = 39
NUM_CTX_SIG_COEFF_LUMA_TU = 13
NUM_CTX_GTX_LUMA = 13

# inverse zigzag: INV_SCAN_TBL[(lw, lh)][raster] = scan position
INV_SCAN_TBL = {}
for _k, _scan in SCAN_TBL.items():
    _inv = np.zeros_like(_scan)
    _inv[_scan] = np.arange(len(_scan), dtype=np.int32)
    INV_SCAN_TBL[_k] = _inv


def adcc_last_pos_ctx_para(ch_type: int, width: int, height: int):
    """Context offsets/shifts for last-position prefixes
    (ref: src_base/xevd_util.c:1194-1219)."""
    cw = max(int(TBL_LOG2[width]) - 2, 0)
    ch = max(int(TBL_LOG2[height]) - 2, 0)
    if ch_type == 0:
        off_x = (cw * 3) + ((cw + 1) >> 2)
        off_y = (ch * 3) + ((ch + 1) >> 2)
        sh_x = (cw + 3) >> 2
        sh_y = (ch + 3) >> 2
        if cw >= 4:
            off_x += ((width >> 6) << 1) + (width >> 7)
            sh_x = 2
        if ch >= 4:
            off_y += ((height >> 6) << 1) + (height >> 7)
            sh_y = 2
    else:
        off_x = off_y = 0
        sh_x = cw - int(TBL_LOG2[width >> 4])   # TBL_LOG2[0] == 0
        sh_y = ch - int(TBL_LOG2[height >> 4])
    return off_x, off_y, sh_x, sh_y


# Main-profile (ADMVP) interpolation filters
# (ref: src_main/xevdm_mc.c:121-155, selected at xevdm_mc.c "sps_admvp_flag")
MC_L_COEFF_MAIN = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [0, 1, -3, 63, 4, -2, 1, 0],
    [-1, 2, -5, 62, 8, -3, 1, 0],
    [-1, 3, -8, 60, 13, -4, 1, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 52, 26, -8, 3, -1],
    [-1, 3, -9, 47, 31, -10, 4, -1],
    [-1, 4, -11, 45, 34, -10, 4, -1],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [-1, 4, -10, 34, 45, -11, 4, -1],
    [-1, 4, -10, 31, 47, -9, 3, -1],
    [-1, 3, -8, 26, 52, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
    [0, 1, -4, 13, 60, -8, 3, -1],
    [0, 1, -3, 8, 62, -5, 2, -1],
    [0, 1, -2, 4, 63, -3, 1, 0],
], dtype=np.int64)

MC_C_COEFF_MAIN = np.array([
    [0, 64, 0, 0], [-1, 63, 2, 0], [-2, 62, 4, 0], [-2, 60, 7, -1],
    [-2, 58, 10, -2], [-3, 57, 12, -2], [-4, 56, 14, -2], [-4, 55, 15, -2],
    [-4, 54, 16, -2], [-5, 53, 18, -2], [-6, 52, 20, -2], [-6, 49, 24, -3],
    [-6, 46, 28, -4], [-5, 44, 29, -4], [-4, 42, 30, -4], [-4, 39, 33, -4],
    [-4, 36, 36, -4], [-4, 33, 39, -4], [-4, 30, 42, -4], [-4, 29, 44, -5],
    [-4, 28, 46, -6], [-3, 24, 49, -6], [-2, 20, 52, -6], [-2, 18, 53, -5],
    [-2, 16, 54, -4], [-2, 15, 55, -4], [-2, 14, 56, -4], [-2, 12, 57, -3],
    [-2, 10, 58, -2], [-1, 7, 60, -2], [0, 4, 62, -2], [0, 2, 63, -1],
], dtype=np.int64)


# ---------------------------------------------------------------------------
# ATS multi-transform bases: forward DST-7 / DCT-8 matrices, sizes 4..32,
# generated exactly like the reference's runtime init
# (ref: src_main/xevdm_itdq.c:81-120 xevdm_init_multi_tbl).
# Layout: TR[k][n] row-major, used by the inverse as out[j] = sum_k x[k]*TR[k][j].
# ---------------------------------------------------------------------------
def _gen_tr(n: int, dct8: bool) -> np.ndarray:
    import math
    s = math.sqrt(n) * 64
    m = np.zeros((n, n), dtype=np.int64)
    for k in range(n):
        for j in range(n):
            if dct8:
                v = math.cos(math.pi * (k + 0.5) * (j + 0.5) / (n + 0.5)) \
                    * math.sqrt(2.0 / (n + 0.5))
            else:
                v = math.sin(math.pi * (k + 0.5) * (j + 1) / (n + 0.5)) \
                    * math.sqrt(2.0 / (n + 0.5))
            m[k, j] = int(s * v + (0.5 if v > 0 else -0.5))
    return m


TR_DST7 = {lg: _gen_tr(1 << lg, False) for lg in (1, 2, 3, 4, 5)}
TR_DCT8 = {lg: _gen_tr(1 << lg, True) for lg in (1, 2, 3, 4, 5)}


def ats_inter_tu_size(ats_inter_info: int, log2_cuw: int, log2_cuh: int):
    """(ref: src_main/xevdm_util.c:3585-3634)"""
    idx = ats_inter_info & 0xF
    if idx == 0:
        return min(log2_cuw, MAX_TR_LOG2), min(log2_cuh, MAX_TR_LOG2)
    horizontal = idx in (2, 4)
    quad = idx in (3, 4)
    if horizontal:
        ltw = min(log2_cuw, MAX_TR_LOG2)
        lth = log2_cuh - (2 if quad else 1)
        lth = min(lth, MAX_TR_LOG2)
    else:
        ltw = log2_cuw - (2 if quad else 1)
        ltw = min(ltw, MAX_TR_LOG2)
        lth = min(log2_cuh, MAX_TR_LOG2)
    return ltw, lth


def ats_inter_tu_offset(ats_inter_info: int, log2_cuw: int, log2_cuh: int):
    """(ref: src_main/xevdm_util.c get_tu_pos_offset)"""
    idx = ats_inter_info & 0xF
    pos = (ats_inter_info >> 4) & 0xF
    if idx == 0:
        return 0, 0
    cuw, cuh = 1 << log2_cuw, 1 << log2_cuh
    horizontal = idx in (2, 4)
    quad = idx in (3, 4)
    if horizontal:
        return 0, 0 if pos == 0 else cuh - (cuh // 4 if quad else cuh // 2)
    return (0 if pos == 0 else cuw - (cuw // 4 if quad else cuw // 2)), 0


def ats_inter_trs(ats_inter_info: int, log2_cuw: int, log2_cuh: int):
    """Luma transform pair for an ATS-inter TU → (ats_cu, ats_mode)
    (ref: src_main/xevdm_util.c:3636-3669); mode bit: 0=DST7, 1=DCT8."""
    if ats_inter_info == 0:
        return 0, 0
    if log2_cuw > 5 or log2_cuh > 5:
        return 0, 0
    idx = ats_inter_info & 0xF
    pos = (ats_inter_info >> 4) & 0xF
    if idx in (2, 4):      # horizontal split
        t_h = 0
        t_v = 1 if pos == 0 else 0
    else:
        t_v = 0
        t_h = 1 if pos == 0 else 0
    return 1, (t_h << 1) | t_v


def check_ats_inter_avail(cuw: int, cuh: int, pred_mode: int,
                          tool_ats: int) -> int:
    """(ref: src_main/xevdm_util.c:3565-3583)"""
    if not tool_ats or pred_mode == MODE_INTRA or cuw > MAX_TR_SIZE \
            or cuh > MAX_TR_SIZE or pred_mode == MODE_IBC:
        return 0
    mode_vert = 1 if cuw >= 8 else 0
    mode_vert_quad = 1 if cuw >= 16 else 0
    mode_hori = 1 if cuh >= 8 else 0
    mode_hori_quad = 1 if cuh >= 16 else 0
    return (mode_vert | (mode_hori << 1) | (mode_vert_quad << 2)
            | (mode_hori_quad << 3))


# ---------------------------------------------------------------------------
# ADDB (advanced deblocking) threshold tables
# (ref: src_main/xevdm_tbl.c:377-388, src_main/xevdm_df.c:331-347)
# ---------------------------------------------------------------------------
ADDB_BS_INTRA_STRONG = 4
ADDB_BS_INTRA = 3
ADDB_BS_CODED = 2
ADDB_BS_DIFF_REFS = 1
ADDB_BS_OTHERS = 0

ADDB_ALPHA = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 4, 5, 6,
    7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36, 40, 45,
    50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182, 203, 226,
    255, 255], dtype=np.int32)

ADDB_BETA = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 2, 2, 3,
    3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10,
    11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18],
    dtype=np.int32)

ADDB_CLIP = np.array([
    [0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0], [0, 0, 0, 0, 0],
    [0, 0, 0, 0, 0], [0, 0, 0, 1, 1], [0, 0, 0, 1, 1], [0, 0, 0, 1, 1],
    [0, 0, 0, 1, 1], [0, 0, 1, 1, 1], [0, 0, 1, 1, 1], [0, 1, 1, 1, 1],
    [0, 1, 1, 1, 1], [0, 1, 1, 1, 1], [0, 1, 1, 1, 1], [0, 1, 1, 2, 2],
    [0, 1, 1, 2, 2], [0, 1, 1, 2, 2], [0, 1, 1, 2, 2], [0, 1, 2, 3, 3],
    [0, 1, 2, 3, 3], [0, 2, 2, 3, 3], [0, 2, 2, 4, 4], [0, 2, 3, 4, 4],
    [0, 2, 3, 4, 4], [0, 3, 3, 5, 5], [0, 3, 4, 6, 6], [0, 3, 4, 6, 6],
    [0, 4, 5, 7, 7], [0, 4, 5, 8, 8], [0, 4, 6, 9, 9], [0, 5, 7, 10, 10],
    [0, 6, 8, 11, 11], [0, 6, 8, 13, 13], [0, 7, 10, 14, 14],
    [0, 8, 11, 16, 16], [0, 9, 12, 18, 18], [0, 10, 13, 20, 20],
    [0, 11, 15, 23, 23], [0, 13, 17, 25, 25]], dtype=np.int32)


# ---------------------------------------------------------------------------
# HTDF (hadamard-domain in-loop filter) LUTs
# (ref: src_main/xevdm_recon.c:153-171)
# ---------------------------------------------------------------------------
HTDF_TBL = np.array([
    [0, 0, 2, 6, 10, 14, 19, 23, 28, 32, 36, 41, 45, 49, 53, 57],
    [0, 0, 5, 12, 20, 29, 38, 47, 56, 65, 73, 82, 90, 98, 107, 115],
    [0, 0, 1, 4, 9, 16, 24, 32, 41, 50, 59, 68, 77, 86, 94, 103],
    [0, 0, 3, 9, 19, 32, 47, 64, 81, 99, 117, 135, 154, 179, 205, 230],
    [0, 0, 0, 2, 6, 11, 18, 27, 38, 51, 64, 96, 128, 160, 192, 224],
], dtype=np.int32)
HTDF_THR_LOG2 = np.array([6, 7, 7, 8, 8], dtype=np.int32)


def htdf_skip_and_idx(w: int, h: int, intra: bool, qp: int):
    """Skip condition + LUT index (ref: src_main/xevdm_recon.c:274-305).
    Returns -1 to skip, else the LUT row index."""
    if qp <= 17 or w * h < 64 or max(w, h) >= 128:
        return -1
    if not intra:
        if min(w, h) >= 32:
            return -1
    elif w == h and min(w, h) >= 32:
        qp -= 8
    idx = (qp - 20 + 4) >> 3
    return min(max(idx, 0), 4)


# ---------------------------------------------------------------------------
# DRA log/exp approximation tables (ref: src_main/xevdm_tbl.c:410-421)
# ---------------------------------------------------------------------------
DRA_CHROMA_QP_OFFSET = np.array([
    0, 1, 1, 1, 1, 1, 2, 2, 3, 4, 4, 6, 7, 9, 11, 14, 18, 23, 29, 36, 45,
    57, 72, 91, 114, 144, 181, 228, 287, 362, 456, 575, 724, 912, 1149,
    1448, 1825, 2299, 2896, 3649, 4598, 5793, 7298, 9195, 11585, 14596,
    18390, 23170, 29193, 36781, 46341, 58386, 73562, 92682, 116772],
    dtype=np.int64)

DRA_EXP_NOM = np.array([
    128, 144, 161, 181, 203, 228, 256, 287, 322, 362, 406, 456, 512, 574,
    645, 724, 812, 912, 1024, 1149, 1290, 1448, 1625, 1825, 2048],
    dtype=np.int64)

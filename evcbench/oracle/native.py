"""ctypes bindings for the native host entropy engine (native/evc_entropy.c).

Falls back transparently to the pure-Python entropy pass when the shared
library hasn't been built.

Frozen copy of xevd_tpu/native.py for the benchmark's reference decoder.
The engine's C sources are the copies in evcbench/oracle/native/.  The
library is built for this host at first use under
build/evcbench/oracle/<key>/ (key: the sources, the compiler command and
the CPU), each process compiling to a name of its own and renaming it
into place, so that parallel workers may build at once.  Edited lines:
    import hashlib, threading
    _SRC, _COMMAND, _key and _SO (the paths), _build and _stale
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from . import tables as T
from .frame import FrameSyntax

_SRC = Path(__file__).resolve().parent / "native"
_COMMAND = ("cc", "-O3", "-march=native", "-shared", "-fPIC")
_SRCS = ("evc_entropy.c", "evc_main.c", "evc_derive_main.c",
         "evc_wavefront.c")


def _key() -> str:
    h = hashlib.sha256(" ".join(_COMMAND).encode())
    for p in sorted(_SRC.glob("*.[ch]")):
        h.update(p.name.encode() + b"\0" + p.read_bytes())
    try:
        cpu = Path("/proc/cpuinfo").read_text()
        cpu = "\n".join(sorted({ln.strip() for ln in cpu.splitlines()
                                if ln.split(":")[0].strip()
                                in ("model name", "flags")}))
    except OSError:
        cpu = ""
    h.update(cpu.encode())
    return h.hexdigest()[:16]


_SO = (Path(__file__).resolve().parents[2] / "build" / "evcbench" / "oracle"
       / _key() / "libevc_entropy.so")
_LIB = None

CU_FIELDS = 29


def _build():
    _SO.parent.mkdir(parents=True, exist_ok=True)
    tmp = _SO.with_name(f".{_SO.name}.{os.getpid()}.{threading.get_ident()}")
    try:
        subprocess.run([*_COMMAND, "-o", str(tmp)]
                       + [str(_SRC / s) for s in _SRCS], check=True)
        os.replace(tmp, _SO)
    finally:
        tmp.unlink(missing_ok=True)


def _stale() -> bool:
    return not _SO.exists()


def get_lib():
    global _LIB
    if _LIB is not None:
        return _LIB
    if _stale():
        try:
            _build()
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(_SO))
    except OSError:
        return None
    lib.evc_decode_slice.restype = ctypes.c_int
    lib.evc_main_decode_slice.restype = ctypes.c_int
    lib.evc_main_derive.restype = ctypes.c_int
    _LIB = lib
    return lib


def available() -> bool:
    return get_lib() is not None


_SCRATCH = {}


def _scratch(w, h, flip=0):
    """Per-resolution reusable entropy-output buffers.  Every field the C
    engine writes is fully rewritten per frame (decode_cu/derive_cu cover
    the whole picture), so only the sparse-write buffers (coef planes,
    edge maps) are re-zeroed here.  Arrays that outlive the frame
    (map_mv/map_refi into the DPB, the cu record slice) are copied or
    freshly allocated by the caller."""
    key = (w, h, flip)
    s = _SCRATCH.get(key)
    w_lcu, h_lcu = (w + 63) // 64, (h + 63) // 64
    w_pad, h_pad = w_lcu * 64, h_lcu * 64
    w_scu, h_scu = (w + 3) >> 2, (h + 3) >> 2
    if s is None:
        s = {
            "coef_y": np.zeros((h_pad, w_pad), np.int16),
            "coef_u": np.zeros((h_pad >> 1, w_pad >> 1), np.int16),
            "coef_v": np.zeros((h_pad >> 1, w_pad >> 1), np.int16),
            "cu_out": np.zeros((w_scu * h_scu, CU_FIELDS), np.int32),
            "map_if": np.zeros((h_scu, w_scu), np.uint8),
            "map_qp": np.zeros((h_scu, w_scu), np.int32),
            "map_cbfl": np.zeros((h_scu, w_scu), np.uint8),
            "map_ipm": np.full((h_scu, w_scu), -1, np.int8),
            "map_skip": np.zeros((h_scu, w_scu), np.uint8),
            "edge_hor": np.zeros((h_scu, w_scu), np.uint8),
            "edge_ver": np.zeros((h_scu, w_scu), np.uint8),
            "cod_eco": np.zeros((h_scu, w_scu), np.uint8),
        }
        _SCRATCH[key] = s
    else:
        s["coef_y"][:] = 0
        s["coef_u"][:] = 0
        s["coef_v"][:] = 0
        s["edge_hor"][:] = 0
        s["edge_ver"][:] = 0
        s["cod_eco"][:] = 0      # decode-order availability: per-slice state
    return s, w_pad, h_pad, w_scu, h_scu


def decode_slice_native(payload: bytes, sps, pps, sh, num_refp,
                        chroma_qp_tbl, refp=None, poc=0, flip=0):
    """Native equivalent of frame.EntropyDecoder.decode_slice PLUS the
    baseline derive pass (final motion, intra availability) in C.

    Returns (fs, native_job) where native_job carries the derive outputs
    (cu_mv/cu_refi/nbr masks/map_mv/map_refi) for derive.job_from_native."""
    lib = get_lib()
    w = sps.pic_width_in_luma_samples
    h = sps.pic_height_in_luma_samples
    cfi = sps.chroma_format_idc
    # flip: ping-pong scratch set so a pipelined entropy pass for slice
    # n+1 never overwrites buffers (coef planes) the pack of slice n is
    # still reading on the main thread
    s, w_pad, h_pad, w_scu, h_scu = _scratch(w, h, flip)
    coef_y, coef_u, coef_v = s["coef_y"], s["coef_u"], s["coef_v"]
    cu_out = s["cu_out"]
    map_if, map_qp = s["map_if"], s["map_qp"]
    map_cbfl, map_ipm = s["map_cbfl"], s["map_ipm"]
    map_skip, cod_eco = s["map_skip"], s["cod_eco"]
    edge_hor, edge_ver = s["edge_hor"], s["edge_ver"]

    tbl_u = np.ascontiguousarray(chroma_qp_tbl[0], np.int32)
    tbl_v = np.ascontiguousarray(chroma_qp_tbl[1], np.int32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    # derive-pass inputs (ref: src_base/xevd_util.c:469-566)
    map_mv = np.zeros((h_scu, w_scu, 2, 2), np.int16)
    map_refi = np.full((h_scu, w_scu, 2), -1, np.int8)
    null16 = ctypes.POINTER(ctypes.c_int16)()
    ref_mv = [null16, null16]
    ref0_l0_poc = r1_poc = r1_list_poc0 = 0
    keep = []
    if refp is not None:
        for lidx in range(2):
            if num_refp[lidx] > 0:
                mvd = np.ascontiguousarray(refp[0][lidx].map_mv, np.int16)
                keep.append(mvd)
                ref_mv[lidx] = ptr(mvd, ctypes.c_int16)
        if num_refp[0] > 0:
            ref0_l0_poc = int(refp[0][0].poc)
        if num_refp[1] > 0:
            r1_poc = int(refp[0][1].poc)
            r1_list_poc0 = int(refp[0][1].list_poc[0])

    n = lib.evc_decode_slice(
        payload, len(payload), w, h, sh.slice_type, sh.qp,
        sh.qp_u_offset, sh.qp_v_offset, pps.cu_qp_delta_enabled_flag,
        cfi, num_refp[0], num_refp[1], sps.bit_depth_chroma_minus8,
        ptr(tbl_u, ctypes.c_int32), ptr(tbl_v, ctypes.c_int32),
        ptr(coef_y, ctypes.c_int16), ptr(coef_u, ctypes.c_int16),
        ptr(coef_v, ctypes.c_int16), ptr(cu_out, ctypes.c_int32),
        ptr(map_if, ctypes.c_uint8), ptr(map_qp, ctypes.c_int32),
        ptr(map_cbfl, ctypes.c_uint8), ptr(map_ipm, ctypes.c_int8),
        ptr(map_skip, ctypes.c_uint8), ptr(edge_hor, ctypes.c_uint8),
        ptr(edge_ver, ctypes.c_uint8), ptr(cod_eco, ctypes.c_uint8),
        ptr(map_mv, ctypes.c_int16), ptr(map_refi, ctypes.c_int8),
        pps.constrained_intra_pred_flag, int(poc), ref0_l0_poc,
        ref_mv[0], ref_mv[1], r1_poc, r1_list_poc0)
    if n < 0:
        raise ValueError(f"native entropy decode failed: {n}")

    fs = FrameSyntax(w=w, h=h, w_pad=w_pad, h_pad=h_pad, w_scu=w_scu,
                     h_scu=h_scu, slice_type=sh.slice_type, sh=sh)
    fs.coef_y = coef_y
    fs.coef_u = coef_u if cfi else None
    fs.coef_v = coef_v if cfi else None
    # copy: cu_out is reused scratch, but fs may outlive the frame
    # (e.g. parallel/gop capture keeps it)
    cu = cu_out[:n].copy()
    fs.cu_x = cu[:, 0]
    fs.cu_y = cu[:, 1]
    fs.cu_log2w = cu[:, 2]
    fs.cu_log2h = cu[:, 2]  # Baseline QT: always square
    fs.cu_pred_mode = cu[:, 3]
    fs.cu_ipm = cu[:, 4]
    fs.cu_qp = cu[:, 5]
    fs.cu_qp_u = cu[:, 6]
    fs.cu_qp_v = cu[:, 7]
    fs.cu_cbf = cu[:, 8:11]
    fs.cu_refi = cu[:, 11:13]
    fs.cu_mvp_idx = cu[:, 13:15]
    fs.cu_mvd = cu[:, 15:19].reshape(-1, 2, 2)
    fs.cu_inter_dir = cu[:, 19]
    fs.map_if = map_if
    fs.map_qp = map_qp
    fs.map_cbfl = map_cbfl
    fs.map_ipm = map_ipm
    fs.map_skip = map_skip
    fs.edge_hor = edge_hor
    fs.edge_ver = edge_ver
    fs.finalize()
    native_job = {
        "sh": sh, "chroma_qp_tbl": (tbl_u, tbl_v),
        "cu_mv": cu[:, 20:24].reshape(-1, 2, 2).astype(np.int32),
        "cu_refi": cu[:, 24:26].astype(np.int32),
        "nbr_up": cu[:, 26].astype(np.int64) & 0xFFFFFFFF,
        "nbr_left": cu[:, 27].astype(np.int64) & 0xFFFFFFFF,
        "nbr_corner": cu[:, 28].astype(np.uint8),
        "map_mv": map_mv,
        "map_refi": map_refi,
    }
    return fs, native_job


_DF_ST32 = None


def deblock_strengths_native(fs, sps, sh, tbl_u, tbl_v, map_refi, map_mv):
    """C boundary-strength derivation (native evc_deblock_strengths);
    returns (hy, hu, hv, vy, vu, vv) int32 maps."""
    global _DF_ST32
    lib = get_lib()
    if _DF_ST32 is None:
        _DF_ST32 = np.ascontiguousarray(T.DF_ST, np.int32)
    h_scu, w_scu = fs.h_scu, fs.w_scu
    outs = [np.empty((h_scu, w_scu), np.int32) for _ in range(6)]

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    mv16 = map_mv if map_mv.dtype == np.int16 else \
        np.ascontiguousarray(map_mv, np.int16)
    refi8 = map_refi if map_refi.dtype == np.int8 else \
        np.ascontiguousarray(map_refi, np.int8)
    lib.evc_deblock_strengths(
        w_scu, h_scu,
        ptr(fs.map_if, ctypes.c_uint8), ptr(fs.map_cbfl, ctypes.c_uint8),
        ptr(fs.map_qp, ctypes.c_int32),
        ptr(fs.edge_hor, ctypes.c_uint8), ptr(fs.edge_ver, ctypes.c_uint8),
        ptr(refi8, ctypes.c_int8), ptr(mv16, ctypes.c_int16),
        ptr(_DF_ST32, ctypes.c_int32),
        ptr(tbl_u, ctypes.c_int32), ptr(tbl_v, ctypes.c_int32),
        sh.qp_u_offset, sh.qp_v_offset,
        sps.bit_depth_luma_minus8, sps.bit_depth_chroma_minus8,
        *[ptr(o, ctypes.c_int32) for o in outs])
    return outs


# ---------------------------------------------------------------------------
# Main-profile native entropy (native/evc_main.c)
# ---------------------------------------------------------------------------
MAIN_CU_FIELDS = 43

_SCRATCH_MAIN = {}


def _scratch_main(w, h, log2_ctu, cw_s, ch_s, flip=0):
    key = (w, h, log2_ctu, cw_s, ch_s, flip)
    s = _SCRATCH_MAIN.get(key)
    ctu = 1 << log2_ctu
    w_lcu, h_lcu = (w + ctu - 1) // ctu, (h + ctu - 1) // ctu
    w_pad, h_pad = w_lcu * ctu, h_lcu * ctu
    w_scu, h_scu = (w + 3) >> 2, (h + 3) >> 2
    if s is None:
        s = {
            "coef_y": np.zeros((h_pad, w_pad), np.int16),
            "coef_u": np.zeros((h_pad >> ch_s, w_pad >> cw_s), np.int16),
            "coef_v": np.zeros((h_pad >> ch_s, w_pad >> cw_s), np.int16),
            "cu_out": np.zeros((w_scu * h_scu, MAIN_CU_FIELDS), np.int32),
            "map_if": np.zeros((h_scu, w_scu), np.uint8),
            "map_qp": np.zeros((h_scu, w_scu), np.int32),
            "map_cbfl": np.zeros((h_scu, w_scu), np.uint8),
            "map_ipm": np.full((h_scu, w_scu), -1, np.int8),
            "map_skip": np.zeros((h_scu, w_scu), np.uint8),
            "map_ats": np.zeros((h_scu, w_scu), np.uint8),
            "edge_hor": np.zeros((h_scu, w_scu), np.uint8),
            "edge_ver": np.zeros((h_scu, w_scu), np.uint8),
            "edge_hor_c": np.zeros((h_scu, w_scu), np.uint8),
            "edge_ver_c": np.zeros((h_scu, w_scu), np.uint8),
            "alf_ctu_on": np.ones(w_lcu * h_lcu, np.uint8),
        }
        _SCRATCH_MAIN[key] = s
    else:
        for k in ("coef_y", "coef_u", "coef_v", "edge_hor", "edge_ver",
                  "edge_hor_c", "edge_ver_c"):
            s[k][:] = 0
    return s, w_pad, h_pad, w_scu, h_scu


def decode_slice_native_main(payload: bytes, sps, pps, sh, num_refp,
                             chroma_qp_tbl, log2_ctu, flip=0):
    """Native equivalent of frame.EntropyDecoder.decode_slice for the Main
    profile (BTT/SUCO/ADCC/EIPD/ATS/CM_INIT/ALF-CTU-flags).  The Main
    derive pass (merge/HMVP/TMVP motion) stays in derive.derive_frame."""
    lib = get_lib()
    w = sps.pic_width_in_luma_samples
    h = sps.pic_height_in_luma_samples
    cfi = sps.chroma_format_idc
    cw_s = 1 if cfi in (1, 2) else 0
    ch_s = 1 if cfi == 1 else 0
    s, w_pad, h_pad, w_scu, h_scu = _scratch_main(w, h, log2_ctu, cw_s,
                                                  ch_s, flip)

    if sps.sps_btt_flag:
        from .partition import split_tbl_init
        tbl = split_tbl_init(sps, log2_ctu)
        split_flat = [v for pair in tbl for v in pair]
        min_cuwh = 1 << (sps.log2_min_cb_size_minus2 + 2)
    else:
        split_flat = [0] * 8
        min_cuwh = 4
    alf_ctb_bins = bool(getattr(sh, "alf_on", 0)
                        and getattr(sh, "alf_is_ctb_alf_on", 0))
    params = np.array([
        w, h, log2_ctu, min_cuwh, sh.slice_type, sh.qp,
        sh.qp_u_offset, sh.qp_v_offset, pps.cu_qp_delta_enabled_flag,
        cfi, cw_s, ch_s, num_refp[0], num_refp[1],
        sps.bit_depth_chroma_minus8,
        sps.sps_btt_flag, sps.sps_suco_flag,
        getattr(sps, "log2_diff_ctu_size_max_suco_cb_size", 0),
        getattr(sps, "log2_diff_max_suco_min_suco_cb_size", 0),
        (sps.log2_min_cb_size_minus2 + 2) if sps.sps_btt_flag else 2,
        sps.tool_admvp, sps.tool_eipd, sps.tool_cm_init, sps.tool_adcc,
        sps.tool_ats, sps.tool_amvr, sps.tool_mmvd,
        getattr(sh, "mmvd_group_enable_flag", 0), int(alf_ctb_bins),
        sps.ibc_flag, getattr(sps, "ibc_log_max_size", 0),
        pps.constrained_intra_pred_flag, sps.tool_affine,
    ] + split_flat, dtype=np.int32)

    tbl_u = np.ascontiguousarray(chroma_qp_tbl[0], np.int32)
    tbl_v = np.ascontiguousarray(chroma_qp_tbl[1], np.int32)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    n = lib.evc_main_decode_slice(
        payload, len(payload),
        ptr(params, ctypes.c_int32),
        ptr(tbl_u, ctypes.c_int32), ptr(tbl_v, ctypes.c_int32),
        ptr(s["coef_y"], ctypes.c_int16), ptr(s["coef_u"], ctypes.c_int16),
        ptr(s["coef_v"], ctypes.c_int16), ptr(s["cu_out"], ctypes.c_int32),
        ptr(s["map_if"], ctypes.c_uint8), ptr(s["map_qp"], ctypes.c_int32),
        ptr(s["map_cbfl"], ctypes.c_uint8), ptr(s["map_ipm"], ctypes.c_int8),
        ptr(s["map_skip"], ctypes.c_uint8), ptr(s["map_ats"], ctypes.c_uint8),
        ptr(s["edge_hor"], ctypes.c_uint8), ptr(s["edge_ver"], ctypes.c_uint8),
        ptr(s["edge_hor_c"], ctypes.c_uint8),
        ptr(s["edge_ver_c"], ctypes.c_uint8),
        ptr(s["alf_ctu_on"], ctypes.c_uint8))
    if n < 0:
        raise ValueError(f"native Main entropy decode failed: {n}")

    fs = FrameSyntax(w=w, h=h, w_pad=w_pad, h_pad=h_pad, w_scu=w_scu,
                     h_scu=h_scu, slice_type=sh.slice_type, sh=sh)
    fs.coef_y = s["coef_y"]
    fs.coef_u = s["coef_u"] if cfi else None
    fs.coef_v = s["coef_v"] if cfi else None
    cu = s["cu_out"][:n].copy()
    fs._native_cu = cu          # raw records: native derive consumes these
    fs.cu_x = cu[:, 0]
    fs.cu_y = cu[:, 1]
    fs.cu_log2w = cu[:, 2]
    fs.cu_log2h = cu[:, 3]
    fs.cu_pred_mode = cu[:, 4]
    fs.cu_ipm = cu[:, 5]
    fs.cu_ipm_c = cu[:, 6]
    fs.cu_qp = cu[:, 7]
    fs.cu_qp_u = cu[:, 8]
    fs.cu_qp_v = cu[:, 9]
    fs.cu_cbf = cu[:, 10:13]
    fs.cu_refi = cu[:, 13:15]
    fs.cu_mvp_idx = cu[:, 15:17]
    fs.cu_mvd = cu[:, 17:21].reshape(-1, 2, 2)
    fs.cu_inter_dir = cu[:, 21]
    fs.cu_tree = cu[:, 22]
    fs.cu_mvr_idx = cu[:, 23]
    fs.cu_bi_idx = cu[:, 24]
    fs.cu_mmvd_flag = cu[:, 25]
    fs.cu_mmvd_idx = cu[:, 26]
    fs.cu_ats = cu[:, 27:30]
    fs.cu_aff = cu[:, 30]
    fs.cu_aff_mvd = cu[:, 31:43].reshape(-1, 2, 3, 2)
    fs.map_if = s["map_if"]
    fs.map_qp = s["map_qp"]
    fs.map_cbfl = s["map_cbfl"]
    fs.map_ipm = s["map_ipm"]
    fs.map_skip = s["map_skip"]
    fs.map_ats = s["map_ats"]
    fs.edge_hor = s["edge_hor"]
    fs.edge_ver = s["edge_ver"]
    fs.edge_hor_c = s["edge_hor_c"]
    fs.edge_ver_c = s["edge_ver_c"]
    fs.alf_ctu_on = s["alf_ctu_on"]
    fs.finalize()
    return fs


def derive_frame_native_main(fs, sps, pps, sh, refp, poc, chroma_qp_tbl,
                             num_refp, log2_ctu):
    """Native equivalent of derive.derive_frame for the Main profile: the
    per-CU motion/availability/HTDF loop runs in C (evc_derive_main.c);
    the vectorized deblock-strength / ADDB parameter maps stay in
    derive.py's numpy helpers."""
    from .derive import FrameJob, _addb_params, _deblock_strengths
    lib = get_lib()
    cu = fs._native_cu
    n = len(cu)
    w_scu, h_scu = fs.w_scu, fs.h_scu
    is_main = bool(getattr(sps, "is_main", False))
    htdf_on = bool(is_main and sps.tool_htdf)
    if htdf_on and pps.constrained_intra_pred_flag:
        from .syntax import UnsupportedStream
        raise UnsupportedStream(
            "HTDF with constrained intra prediction unsupported")

    tmvp_assigned = int(getattr(sh, "temporal_mvp_asigned_flag", 0))
    if tmvp_assigned:
        col_list = sh.collocated_from_list_idx
        col_ref = sh.collocated_from_ref_idx
        col_src_list = sh.collocated_mvp_source_list_idx
    else:
        col_list = 0 if sh.slice_type == T.SLICE_P else 1
        col_ref = 0
        col_src_list = 0
    col = None
    try:
        col = refp[col_ref][col_list]
    except (IndexError, TypeError):
        col = None

    MAX_REFP = 16
    refp_poc = np.zeros((2, MAX_REFP), np.int32)
    for lidx in range(2):
        for i in range(min(num_refp[lidx], MAX_REFP)):
            rp = refp[i][lidx]
            if rp is not None:
                refp_poc[lidx, i] = int(rp.poc)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    null8 = ctypes.POINTER(ctypes.c_int8)()
    null16 = ctypes.POINTER(ctypes.c_int16)()
    null32 = ctypes.POINTER(ctypes.c_int32)()
    keep = []

    col_refi_p, col_mv_p, col_list_poc_p = null8, null16, null32
    col_poc = 0
    if col is not None:
        cr = np.ascontiguousarray(col.map_refi, np.int8)
        cm = np.ascontiguousarray(col.map_mv, np.int16)
        clp = np.zeros(33, np.int32)
        lp = getattr(col, "list_poc", None)
        if lp is not None:
            lp = np.asarray(lp).ravel()
            clp[:min(len(lp), 33)] = lp[:33]
        keep += [cr, cm, clp]
        col_refi_p = ptr(cr, ctypes.c_int8)
        col_mv_p = ptr(cm, ctypes.c_int16)
        col_list_poc_p = ptr(clp, ctypes.c_int32)
        col_poc = int(col.poc)

    r00_p, r01_p = null16, null16
    r1_poc = r1_list_poc0 = 0
    if num_refp[0] > 0 and refp[0][0] is not None:
        m = np.ascontiguousarray(refp[0][0].map_mv, np.int16)
        keep.append(m)
        r00_p = ptr(m, ctypes.c_int16)
    if num_refp[1] > 0 and refp[0][1] is not None:
        m = np.ascontiguousarray(refp[0][1].map_mv, np.int16)
        keep.append(m)
        r01_p = ptr(m, ctypes.c_int16)
        r1_poc = int(refp[0][1].poc)
        lp = getattr(refp[0][1], "list_poc", None)
        if lp is not None and len(np.asarray(lp).ravel()):
            r1_list_poc0 = int(np.asarray(lp).ravel()[0])

    params = np.array([
        fs.w, fs.h, sh.slice_type, int(poc), log2_ctu,
        int(bool(is_main and sps.tool_admvp)),
        int(bool(is_main and sps.tool_hmvp)),
        int(htdf_on), pps.constrained_intra_pred_flag,
        num_refp[0], num_refp[1],
        tmvp_assigned, col_list, col_ref, col_src_list,
        sh.qp, r1_poc, r1_list_poc0,
    ], dtype=np.int32)

    cu_mv = np.zeros((n, 2, 2), np.int32)
    cu_refi = np.zeros((n, 2), np.int32)
    cu_aff_flag = np.zeros(n, np.int32)
    cu_aff_mv = np.zeros((n, 2, 3, 2), np.int32)
    map_mv = np.zeros((h_scu, w_scu, 2, 2), np.int16)
    map_refi = np.zeros((h_scu, w_scu, 2), np.int8)
    nbr_up = np.zeros(n, np.int64)
    nbr_left = np.zeros(n, np.int64)
    nbr_corner = np.zeros(n, np.uint8)
    nbr_upext = np.zeros(n, np.int64)
    nbr_right = np.zeros(n, np.int64)
    avail_lr = np.zeros(n, np.uint8)
    htdf_idx = np.zeros(n, np.int32)
    htdf_avail = np.zeros(n, np.int32)

    cuc = np.ascontiguousarray(cu, np.int32)
    rc = lib.evc_main_derive(
        ptr(params, ctypes.c_int32), n, ptr(cuc, ctypes.c_int32),
        ptr(fs.map_if, ctypes.c_uint8),
        ptr(refp_poc, ctypes.c_int32),
        col_refi_p, col_mv_p, col_poc, col_list_poc_p,
        r00_p, r01_p,
        ptr(cu_mv, ctypes.c_int32), ptr(cu_refi, ctypes.c_int32),
        ptr(map_mv, ctypes.c_int16), ptr(map_refi, ctypes.c_int8),
        ptr(nbr_up, ctypes.c_int64), ptr(nbr_left, ctypes.c_int64),
        ptr(nbr_corner, ctypes.c_uint8),
        ptr(nbr_upext, ctypes.c_int64), ptr(nbr_right, ctypes.c_int64),
        ptr(avail_lr, ctypes.c_uint8),
        ptr(htdf_idx, ctypes.c_int32), ptr(htdf_avail, ctypes.c_int32),
        ptr(cu_aff_flag, ctypes.c_int32), ptr(cu_aff_mv, ctypes.c_int32))
    if rc != 0:
        raise ValueError(f"native Main derive failed: {rc}")

    job = FrameJob(fs=fs, bit_depth=sps.bit_depth_luma_minus8 + 8,
                   chroma_format_idc=sps.chroma_format_idc)
    job.poc = int(poc)
    job.tool_dmvr = bool(getattr(sps, "is_main", False)
                         and getattr(sps, "tool_dmvr", 0))
    job.cu_mv = cu_mv
    job.cu_refi = cu_refi
    job.map_mv = map_mv
    job.map_refi = map_refi
    job.cu_nbr_up = nbr_up
    job.cu_nbr_left = nbr_left
    job.cu_nbr_corner = nbr_corner
    job.cu_nbr_upext = nbr_upext
    job.cu_nbr_right = nbr_right
    job.cu_avail_lr = avail_lr
    job.cu_htdf_idx = htdf_idx
    job.cu_htdf_avail = htdf_avail
    job.cu_aff_flag = cu_aff_flag
    job.cu_aff_mv = cu_aff_mv

    if getattr(sps, "ibc_flag", 0):
        # IBC SCU map for deblock BS (ref: xevdm_df.c:411-414)
        map_ibc = np.zeros((h_scu, w_scu), np.uint8)
        ibc_rows = np.nonzero(cu[:, 4] == 6)[0]      # MODE_IBC
        for r in ibc_rows:
            ys, xs = int(cu[r, 1]) >> 2, int(cu[r, 0]) >> 2
            map_ibc[ys:ys + (1 << (int(cu[r, 3]) - 2)),
                    xs:xs + (1 << (int(cu[r, 2]) - 2))] = 1
        job.map_ibc = map_ibc

    if sh.deblocking_filter_on:
        if is_main and sps.tool_addb:
            _addb_params(job, fs, sps, sh, chroma_qp_tbl, refp, log2_ctu)
        else:
            _deblock_strengths(job, fs, sps, sh, chroma_qp_tbl)
    if job.db_hor_y is None:
        z = np.zeros((h_scu, w_scu), dtype=np.int32)
        job.db_hor_y = job.db_hor_u = job.db_hor_v = z
        job.db_ver_y = job.db_ver_u = job.db_ver_v = z
    return job


def wavefront_levels(fs, job, idx, chroma):
    """Native wavefront dependency leveling (evc_wavefront.c); same
    contract as ops.wavefront.level_scan_cus."""
    lib = get_lib()
    if not hasattr(lib, "_wf_types_set"):
        lib.evc_wavefront_levels.restype = None
        lib._wf_types_set = True
    n = len(idx)
    h_scu, w_scu = fs.h_scu, fs.w_scu

    def i32(a):
        return np.ascontiguousarray(a, np.int32)

    def i64(a):
        return np.ascontiguousarray(a, np.int64)

    idx_a = i32(idx)
    cu_x, cu_y = i32(fs.cu_x), i32(fs.cu_y)
    lw, lh = i32(fs.cu_log2w), i32(fs.cu_log2h)
    tree, pm = i32(fs.cu_tree), i32(fs.cu_pred_mode)
    up, le = i64(job.cu_nbr_up), i64(job.cu_nbr_left)
    ri, ue = i64(job.cu_nbr_right), i64(job.cu_nbr_upext)
    corner = np.ascontiguousarray(job.cu_nbr_corner, np.uint8)
    has_htdf = job.cu_htdf_idx is not None
    htdf = i32(job.cu_htdf_idx if has_htdf else np.zeros(len(cu_x)))
    lev = np.zeros(n, np.int32)
    wl = np.empty(h_scu * w_scu, np.int64)
    wc = np.empty(h_scu * w_scu, np.int64)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    lib.evc_wavefront_levels(
        n, ptr(idx_a, ctypes.c_int32),
        ptr(cu_x, ctypes.c_int32), ptr(cu_y, ctypes.c_int32),
        ptr(lw, ctypes.c_int32), ptr(lh, ctypes.c_int32),
        ptr(tree, ctypes.c_int32), ptr(pm, ctypes.c_int32),
        ptr(up, ctypes.c_int64), ptr(le, ctypes.c_int64),
        ptr(ri, ctypes.c_int64), ptr(ue, ctypes.c_int64),
        ptr(corner, ctypes.c_uint8),
        ptr(htdf, ctypes.c_int32), int(has_htdf),
        w_scu, h_scu, int(chroma),
        ptr(lev, ctypes.c_int32),
        ptr(wl, ctypes.c_int64), ptr(wc, ctypes.c_int64))
    return lev

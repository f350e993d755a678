"""Top-level EVC Baseline decoder.

API mirrors the reference `xevd_create/decode/pull` surface
(ref: inc/xevd.h:369-374, src_base/xevd.c:1786-2069) with a TPU-native
internal architecture: a host entropy pass emits per-frame tensor batches
(frame.py), a host derive pass resolves motion/availability (derive.py), and
a pixel backend (numpy oracle here; JAX/Pallas in ops/) reconstructs frames.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from . import tables as T
from .bitstream import BitReader
from .derive import derive_frame
from .dpb import Picture, PictureManager
from .frame import EntropyDecoder
from .ops import ref_numpy as RN
from .syntax import (MalformedBitstream, UnsupportedStream,
                     parse_nalu_header, parse_pps, parse_sei, parse_sh,
                     parse_sps)


def check_decoder_caps(sps):
    """Refuse toolsets the decoder cannot decode bit-exactly yet; a silent
    wrong decode is worse than an error (SPS tool flags: syntax.py:176-207,
    ref: src_base/xevd_def.h:841-894)."""
    unsup = []
    if unsup:
        raise UnsupportedStream(
            f"stream enables unimplemented tool(s): {', '.join(unsup)}")


@dataclass
class Stat:
    nalu_type: int = -1
    read: int = 0
    fnum: int = -1
    stype: int = 0
    poc: int = 0
    tid: int = 0
    ret: int = 0
    crc_ok: bool | None = None
    refpic: tuple = ((), ())


@dataclass
class OutFrame:
    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    poc: int
    bit_depth: int
    chroma_format_idc: int
    crop: tuple  # (left, right, top, bottom)
    sei: list = field(default_factory=list)


class _LazyPlane:
    """Deferred view of an output plane whose frame pack+dispatch is still
    pipelined; materialization drains the pipeline first."""

    def __init__(self, dec, pic, attr, slices):
        self._dec = dec
        self._pic = pic
        self._attr = attr
        self._slices = slices
        h = slices[0].stop - slices[0].start
        w = slices[1].stop - slices[1].start
        self.shape = (h, w)

    def _resolve(self):
        self._dec._drain_pipeline()
        return getattr(self._pic, self._attr)[self._slices]

    def __array__(self, dtype=None, copy=None):
        a = np.asarray(self._resolve())
        return a.astype(dtype) if dtype is not None else a


class Poc:
    def __init__(self):
        self.poc_val = 0
        self.prev_poc_val = 0
        self.prev_doc_offset = -1
        self.prev_pic_max_poc_val = 0


def poc_derivation(sps, tid, poc: Poc):
    """Temporal-id based POC derivation (ref: src_base/xevd_util.c:429-466)."""
    sub_gop_length = 1 << sps.log2_sub_gop_length
    if tid == 0:
        poc.poc_val = poc.prev_poc_val + sub_gop_length
        poc.prev_doc_offset = 0
        poc.prev_poc_val = poc.poc_val
        return
    doc_offset = (poc.prev_doc_offset + 1) % sub_gop_length
    if doc_offset == 0:
        poc.prev_poc_val += sub_gop_length
        expected_tid = 0
    else:
        expected_tid = 1 + int(math.log2(doc_offset))
    while tid != expected_tid:
        doc_offset = (doc_offset + 1) % sub_gop_length
        expected_tid = 0 if doc_offset == 0 else 1 + int(math.log2(doc_offset))
    poc_offset = int(sub_gop_length * ((2.0 * doc_offset + 1) / (1 << tid) - 2))
    poc.poc_val = poc.prev_poc_val + poc_offset
    poc.prev_doc_offset = doc_offset


class NumpyPixelBackend:
    """Bit-exact host reconstruction using ops/ref_numpy (oracle backend)."""

    name = "numpy"

    def make_picture_planes(self, rec_planes, fs, sps):
        """Pad-expand reconstructed planes into DPB picture planes."""
        rec_y, rec_u, rec_v = rec_planes
        cw_s = 1 if sps.chroma_format_idc in (1, 2) else 0
        ch_s = 1 if sps.chroma_format_idc == 1 else 0
        y = pad_expand(rec_y, fs.w, fs.h, T.PIC_PAD_SIZE_L)
        if sps.chroma_format_idc:
            u = pad_expand(rec_u, fs.w >> cw_s, fs.h >> ch_s, T.PIC_PAD_SIZE_C)
            v = pad_expand(rec_v, fs.w >> cw_s, fs.h >> ch_s, T.PIC_PAD_SIZE_C)
        else:
            u = v = None
        return y, u, v

    def to_host(self, plane):
        return np.asarray(plane)

    def decode_frame(self, job, sps, refp):
        fs = job.fs
        bd = sps.bit_depth_luma_minus8 + 8
        bd_c = sps.bit_depth_chroma_minus8 + 8
        cfi = sps.chroma_format_idc
        cw_s = 1 if cfi in (1, 2) else 0
        ch_s = 1 if cfi == 1 else 0
        rec_y = np.zeros((fs.h_pad, fs.w_pad), dtype=np.int16)
        rec_u = np.zeros((fs.h_pad >> ch_s, fs.w_pad >> cw_s), dtype=np.int16)
        rec_v = np.zeros_like(rec_u)
        n = fs.num_cus()

        # 1) residuals for every coded TU (batched-friendly; here per CU)
        is_main = bool(getattr(sps, "is_main", False))
        iqt = bool(is_main and sps.tool_iqt)
        resid = {}
        for i in range(n):
            if fs.cu_pred_mode[i] == T.MODE_SKIP:
                continue
            x, y = fs.cu_x[i], fs.cu_y[i]
            lw_, lh_ = fs.cu_log2w[i], fs.cu_log2h[i]
            cbf = fs.cu_cbf[i]
            ats_cu, ats_mode, ats_inter = fs.cu_ats[i]
            r = [None, None, None]
            if cbf[0]:
                qp_y = fs.cu_qp[i] + 6 * (bd - 8)
                scale = RN.qp_scale(qp_y, iqt)
                if ats_inter:
                    ltw, lth = T.ats_inter_tu_size(ats_inter, lw_, lh_)
                    xo, yo = T.ats_inter_tu_offset(ats_inter, lw_, lh_)
                    a_cu, a_mode = T.ats_inter_trs(ats_inter, lw_, lh_)
                    blk = fs.coef_y[y + yo:y + yo + (1 << lth),
                                    x + xo:x + xo + (1 << ltw)]
                    rb = RN.itdq_block(blk, ltw, lth, scale, bd, iqt,
                                       a_cu, a_mode)
                    r[0] = np.zeros((1 << lh_, 1 << lw_), np.int16)
                    r[0][yo:yo + (1 << lth), xo:xo + (1 << ltw)] = rb
                else:
                    blk = fs.coef_y[y:y + (1 << lh_), x:x + (1 << lw_)]
                    r[0] = RN.itdq_block(blk, lw_, lh_, scale, bd, iqt,
                                         ats_cu, ats_mode)
            if cfi and (cbf[1] or cbf[2]):
                lw, lh = lw_ - cw_s, lh_ - ch_s
                xc, yc = x >> cw_s, y >> ch_s
                ltw, lth = T.ats_inter_tu_size(ats_inter, lw, lh)
                xo, yo = T.ats_inter_tu_offset(ats_inter, lw, lh)

                def chroma_resid(plane, qp):
                    blk = plane[yc + yo:yc + yo + (1 << lth),
                                xc + xo:xc + xo + (1 << ltw)]
                    rb = RN.itdq_block(blk, ltw, lth,
                                       RN.qp_scale(qp, iqt), bd, iqt)
                    if not ats_inter:
                        return rb
                    out = np.zeros((1 << lh, 1 << lw), np.int16)
                    out[yo:yo + (1 << lth), xo:xo + (1 << ltw)] = rb
                    return out

                if cbf[1]:
                    r[1] = chroma_resid(fs.coef_u, fs.cu_qp_u[i])
                if cbf[2]:
                    r[2] = chroma_resid(fs.coef_v, fs.cu_qp_v[i])
            if any(v is not None for v in r):
                resid[i] = r

        # 2) inter CUs (MODE_SKIP / DIR / INTER): batched MC, no intra deps
        main_taps = bool(getattr(sps, "is_main", False) and sps.tool_admvp)
        aff_flags = getattr(job, "cu_aff_flag", None)
        for i in range(n):
            if fs.cu_pred_mode[i] in (T.MODE_INTRA, T.MODE_IBC):
                continue
            x, y = fs.cu_x[i], fs.cu_y[i]
            cuw = 1 << fs.cu_log2w[i]
            cuh = 1 << fs.cu_log2h[i]
            if aff_flags is not None and aff_flags[i]:
                # affine MC (ref: src_main/xevdm.c:1290-1296)
                from .ops.affine_mc import affine_mc
                refi_a = [int(job.cu_refi[i][0]), int(job.cu_refi[i][1])]
                aff_mv = job.cu_aff_mv[i].tolist()
                py, pu, pv = affine_mc(
                    int(x), int(y), fs.w, fs.h, int(cuw), int(cuh),
                    refi_a, aff_mv, refp, int(aff_flags[i]) + 1, bd, bd_c,
                    cfi)
                r = resid.get(i, (None, None, None))
                cbf = fs.cu_cbf[i]
                rec_y[y:y + cuh, x:x + cuw] = RN.recon(py, r[0],
                                                       bool(cbf[0]), bd)
                if cfi:
                    xc, yc = x >> cw_s, y >> ch_s
                    rec_u[yc:yc + (cuh >> ch_s), xc:xc + (cuw >> cw_s)] = \
                        RN.recon(pu, r[1], bool(cbf[1]), bd)
                    rec_v[yc:yc + (cuh >> ch_s), xc:xc + (cuw >> cw_s)] = \
                        RN.recon(pv, r[2], bool(cbf[2]), bd)
                continue
            refi = job.cu_refi[i]
            mv = job.cu_mv[i]
            if getattr(job, "dmvr_mvs", None) is not None \
                    and i in job.dmvr_mvs:
                from .ops.dmvr import process_dmvr
                if True:
                    p0, p1, ref_q, dxs, dys = process_dmvr(
                        int(x), int(y), fs.w, fs.h, int(cuw), int(cuh),
                        [int(refi[0]), int(refi[1])],
                        [[int(mv[0][0]), int(mv[0][1])],
                         [int(mv[1][0]), int(mv[1][1])]],
                        refp, bd, bd_c, cfi,
                        refined=job.dmvr_mvs[i])
                    py = RN.bi_average(p0[0], p1[0])
                    if cfi:
                        pu = RN.bi_average(p0[1], p1[1])
                        pv = RN.bi_average(p0[2], p1[2])
                    r = resid.get(i, (None, None, None))
                    cbf = fs.cu_cbf[i]
                    rec_y[y:y + cuh, x:x + cuw] = RN.recon(
                        py, r[0], bool(cbf[0]), bd)
                    if cfi:
                        xc, yc = x >> cw_s, y >> ch_s
                        rec_u[yc:yc + (cuh >> ch_s),
                              xc:xc + (cuw >> cw_s)] = RN.recon(
                            pu, r[1], bool(cbf[1]), bd)
                        rec_v[yc:yc + (cuh >> ch_s),
                              xc:xc + (cuw >> cw_s)] = RN.recon(
                            pv, r[2], bool(cbf[2]), bd)
                    continue
            preds = []
            used_pocs = []
            for lidx in range(2):
                if refi[lidx] < 0:
                    continue
                ref = refp[refi[lidx]][lidx]
                pic = ref.pic
                mvx_c, mvy_c = RN.mv_clip(x, y, fs.w, fs.h, cuw, cuh, mv[lidx])
                gx16 = ((x << 2) + mvx_c) << 2
                gy16 = ((y << 2) + mvy_c) << 2
                fx = (int(mv[lidx][0]) << 2) & 15
                fy = (int(mv[lidx][1]) << 2) & 15
                pad = pic.pad_l
                py = RN.mc_luma(pic.y, gx16 + (pad << 4), gy16 + (pad << 4),
                                fx, fy, cuw, cuh, bd, pad,
                                main_taps=main_taps)
                if cfi:
                    fx_c = (int(mv[lidx][0]) << 2) & 31
                    fy_c = (int(mv[lidx][1]) << 2) & 31
                    pad_c = pic.pad_c
                    pu = RN.mc_chroma(pic.u, gx16 + (pad_c << 5),
                                      gy16 + (pad_c << 5), fx_c, fy_c,
                                      cuw >> cw_s, cuh >> ch_s, bd_c,
                                      main_taps=main_taps)
                    pv = RN.mc_chroma(pic.v, gx16 + (pad_c << 5),
                                      gy16 + (pad_c << 5), fx_c, fy_c,
                                      cuw >> cw_s, cuh >> ch_s, bd_c,
                                      main_taps=main_taps)
                else:
                    pu = pv = None
                preds.append((py, pu, pv))
                used_pocs.append((ref.poc, mvx_c, mvy_c))
            if len(preds) == 2:
                # identical-motion skip (ref: src_base/xevd_mc.c:512-519)
                if used_pocs[0] == used_pocs[1]:
                    preds = preds[:1]
            if len(preds) == 2:
                py = RN.bi_average(preds[0][0], preds[1][0])
                if cfi:
                    pu = RN.bi_average(preds[0][1], preds[1][1])
                    pv = RN.bi_average(preds[0][2], preds[1][2])
            else:
                py, pu, pv = preds[0]
            r = resid.get(i, (None, None, None))
            cbf = fs.cu_cbf[i]
            rec_y[y:y + cuh, x:x + cuw] = RN.recon(py, r[0], bool(cbf[0]), bd)
            if cfi:
                xc, yc = x >> cw_s, y >> ch_s
                rec_u[yc:yc + (cuh >> ch_s), xc:xc + (cuw >> cw_s)] = \
                    RN.recon(pu, r[1], bool(cbf[1]), bd)
                rec_v[yc:yc + (cuh >> ch_s), xc:xc + (cuw >> cw_s)] = \
                    RN.recon(pv, r[2], bool(cbf[2]), bd)

        # 3) decode-order pass: intra CUs (sequential neighbor dependency)
        #    and HTDF (filtered pixels feed later intra predictions,
        #    ref: src_main/xevdm.c:1383-1390)
        eipd = bool(getattr(sps, "is_main", False) and sps.tool_eipd)
        htdf_on = job.cu_htdf_idx is not None and (job.cu_htdf_idx >= 0).any()
        if htdf_on:
            from .ops.htdf import htdf_block
        if eipd:
            from .ops import ref_numpy_main as RM
        for i in range(n):
            if fs.cu_pred_mode[i] == T.MODE_IBC:
                # in-loop block copy from the current reconstruction
                # (ref: src_main/xevdm_mc.c:2040 xevdm_IBC_mc)
                x, y = fs.cu_x[i], fs.cu_y[i]
                cuw = 1 << fs.cu_log2w[i]
                cuh = 1 << fs.cu_log2h[i]
                bvx, bvy = int(job.cu_mv[i][0][0]), int(job.cu_mv[i][0][1])
                tree = fs.cu_tree[i]
                r = resid.get(i, (None, None, None))
                cbf = fs.cu_cbf[i]
                if tree != 2:
                    py = rec_y[y + bvy:y + bvy + cuh,
                               x + bvx:x + bvx + cuw].astype(np.int32)
                    rec_y[y:y + cuh, x:x + cuw] = RN.recon(
                        py, r[0], bool(cbf[0]), bd)
                if cfi and tree != 1:
                    xc, yc = x >> cw_s, y >> ch_s
                    wc, hc = cuw >> cw_s, cuh >> ch_s
                    bvxc, bvyc = bvx >> cw_s, bvy >> ch_s
                    pu = rec_u[yc + bvyc:yc + bvyc + hc,
                               xc + bvxc:xc + bvxc + wc].astype(np.int32)
                    pv = rec_v[yc + bvyc:yc + bvyc + hc,
                               xc + bvxc:xc + bvxc + wc].astype(np.int32)
                    rec_u[yc:yc + hc, xc:xc + wc] = RN.recon(
                        pu, r[1], bool(cbf[1]), bd)
                    rec_v[yc:yc + hc, xc:xc + wc] = RN.recon(
                        pv, r[2], bool(cbf[2]), bd)
                continue
            if fs.cu_pred_mode[i] != T.MODE_INTRA:
                if htdf_on and job.cu_htdf_idx[i] >= 0:
                    htdf_block(rec_y, fs.cu_x[i], fs.cu_y[i],
                               1 << fs.cu_log2w[i], 1 << fs.cu_log2h[i],
                               int(job.cu_htdf_avail[i]),
                               int(job.cu_htdf_idx[i]), bd)
                continue
            x, y = fs.cu_x[i], fs.cu_y[i]
            cuw = 1 << fs.cu_log2w[i]
            cuh = 1 << fs.cu_log2h[i]
            tree = fs.cu_tree[i]
            up_m = int(job.cu_nbr_up[i])
            le_m = int(job.cu_nbr_left[i])
            co = int(job.cu_nbr_corner[i])
            ipm = fs.cu_ipm[i]
            r = resid.get(i, (None, None, None))
            cbf = fs.cu_cbf[i]
            if eipd:
                ue_m = int(job.cu_nbr_upext[i])
                ri_m = int(job.cu_nbr_right[i])
                lr = int(job.cu_avail_lr[i])
                ipm_c = fs.cu_ipm_c[i]
                if tree != 2:  # TREE_C units carry no luma
                    nb = RM.build_nbr_m(rec_y, x, y, cuw, cuh, 4, up_m, ue_m,
                                        le_m, ri_m, co, bd)
                    py = RM.ipred_main(nb, lr, ipm, cuw, cuh, bd)
                    rec_y[y:y + cuh, x:x + cuw] = RN.recon(py, r[0],
                                                           bool(cbf[0]), bd)
                if cfi and tree != 1:  # TREE_L units carry no chroma
                    xc, yc = x >> cw_s, y >> ch_s
                    wc, hc = cuw >> cw_s, cuh >> ch_s
                    nb = RM.build_nbr_m(rec_u, xc, yc, wc, hc, 4 >> cw_s,
                                        up_m, ue_m, le_m, ri_m, co, bd_c)
                    pu = RM.ipred_uv_main(nb, lr, ipm_c, ipm, wc, hc, bd_c)
                    nb = RM.build_nbr_m(rec_v, xc, yc, wc, hc, 4 >> cw_s,
                                        up_m, ue_m, le_m, ri_m, co, bd_c)
                    pv = RM.ipred_uv_main(nb, lr, ipm_c, ipm, wc, hc, bd_c)
                    rec_u[yc:yc + hc, xc:xc + wc] = RN.recon(
                        pu, r[1], bool(cbf[1]), bd)
                    rec_v[yc:yc + hc, xc:xc + wc] = RN.recon(
                        pv, r[2], bool(cbf[2]), bd)
                if htdf_on and job.cu_htdf_idx[i] >= 0:
                    htdf_block(rec_y, x, y, cuw, cuh,
                               int(job.cu_htdf_avail[i]),
                               int(job.cu_htdf_idx[i]), bd)
                continue
            if tree != 2:  # TREE_C units carry no luma
                left, up, corner = RN.build_nbr(rec_y, x, y, cuw, cuh, up_m,
                                                le_m, co, 4, bd)
                py = RN.ipred_b(left, up, corner, ipm, cuw, cuh)
                rec_y[y:y + cuh, x:x + cuw] = RN.recon(py, r[0],
                                                       bool(cbf[0]), bd)
            if cfi and tree != 1:  # TREE_L units carry no chroma
                xc, yc = x >> cw_s, y >> ch_s
                wc, hc = cuw >> cw_s, cuh >> ch_s
                left, up, corner = RN.build_nbr(rec_u, xc, yc, wc, hc, up_m,
                                                le_m, co, 4 >> cw_s, bd_c)
                pu = RN.ipred_b(left, up, corner, ipm, wc, hc)
                left, up, corner = RN.build_nbr(rec_v, xc, yc, wc, hc, up_m,
                                                le_m, co, 4 >> cw_s, bd_c)
                pv = RN.ipred_b(left, up, corner, ipm, wc, hc)
                rec_u[yc:yc + hc, xc:xc + wc] = RN.recon(pu, r[1], bool(cbf[1]), bd)
                rec_v[yc:yc + hc, xc:xc + wc] = RN.recon(pv, r[2], bool(cbf[2]), bd)
            if htdf_on and job.cu_htdf_idx[i] >= 0:
                htdf_block(rec_y, x, y, cuw, cuh,
                           int(job.cu_htdf_avail[i]),
                           int(job.cu_htdf_idx[i]), bd)

        # 4) deblocking (ADDB when tool_addb, else the base filter)
        if job.addb_luma is not None:
            from .ops.ref_numpy_addb import deblock_frame_addb
            deblock_frame_addb((rec_y, rec_u, rec_v), job, sps)
        else:
            RN.deblock_frame((rec_y, rec_u, rec_v), job, sps)

        # 5) ALF (ref: src_main/xevdm.c:3209-3213, after deblock)
        if job.alf_param is not None:
            from .ops.alf import alf_frame
            log2_ctu, across = job.alf_misc
            alf_frame((rec_y, rec_u, rec_v), fs.w, fs.h, job.alf_param,
                      fs.alf_ctu_on, job.alf_enable, log2_ctu, bd,
                      across_tiles=across)
        return rec_y, rec_u, rec_v


def pad_expand(plane: np.ndarray, w: int, h: int, pad: int) -> np.ndarray:
    """Edge-replicate pad (ref: src_base/xevd_util.c:365-428)."""
    return np.pad(plane[:h, :w], pad, mode="edge")


class Decoder:
    """EVC Baseline decoder with xevd-shaped API."""

    def __init__(self, threads: int = 1, backend=None,
                 use_native_entropy: bool | None = None):
        self.backend = backend or NumpyPixelBackend()
        if use_native_entropy is None:
            from . import native
            use_native_entropy = native.available()
        self.use_native_entropy = use_native_entropy
        self.sps = None
        self.pps = None
        self.sh = None
        self.dpm = None
        self.poc = Poc()
        self.pic_cnt = 0
        self.last_intra_poc = 0
        self.use_pic_signature = False
        self.chroma_qp_tbl = None
        self.entropy = None
        self.last_pic = None
        self.pending_sei = []
        self.max_coding_delay = 0
        self.crc_results = []
        self.aps_alf = [None] * 32
        self.aps_dra = [None] * 32
        # host/device frame pipelining (the reference's eco/recon overlap,
        # ref: src_base/xevd.c:1528-1606, re-expressed as: C entropy of
        # slice n+1 on a worker thread — ctypes releases the GIL — while
        # the main thread packs + dispatches slice n to the device)
        import os
        self._pipeline_on = (os.environ.get("XEVD_TPU_PIPELINE", "1") == "1"
                             and getattr(self.backend, "device_resident",
                                         False))
        self._entropy_pool = None
        self._pending = None     # deferred (job, sps, refp, pic, fs) pack
        self._scratch_flip = 0
        self._pull_retry = False

    # -- API -----------------------------------------------------------
    def decode(self, nalu: bytes) -> Stat:
        bs = BitReader(nalu)
        nal = parse_nalu_header(bs)
        stat = Stat(nalu_type=nal.nal_unit_type)
        nut = nal.nal_unit_type
        if nut >= T.NUT_SPS:
            # non-slice NALU (SPS/PPS/APS/SEI/FD): the deferred frame must
            # land first (SEI signatures read pixel planes; SPS may realloc)
            self._drain_pipeline()
        if nut == T.NUT_SPS:
            self.sps = parse_sps(bs)
            self._sequence_init()
        elif nut == T.NUT_PPS:
            self.pps = parse_pps(bs, self.sps)
        elif nut < T.NUT_SPS:
            self._decode_slice(bs, nut, nal.nuh_temporal_id, stat)
        elif nut == T.NUT_SEI:
            np_planes = 3 if self.sps and self.sps.chroma_format_idc else 1
            sig, others = parse_sei(bs, np_planes)
            self.pending_sei.extend(others)
            if sig is not None and self.last_pic is not None:
                if self.use_pic_signature:
                    stat.crc_ok = self._check_signature(sig)
                    self.crc_results.append(stat.crc_ok)
        elif nut == T.NUT_APS:
            # ALF (type 0) / DRA (type 1) parameter sets, buffered by id
            # (ref: src_main/xevdm.c:2937-2991)
            from .aps import parse_aps
            bd = (self.sps.bit_depth_luma_minus8 + 8) if self.sps else 8
            aps_id, aps_type, payload = parse_aps(bs, bd)
            if payload is not None:
                if aps_type == 0:
                    self.aps_alf[aps_id] = payload
                else:
                    self.aps_dra[aps_id] = payload
        elif nut == T.NUT_FD:
            pass
        else:
            raise MalformedBitstream(f"wrong NALU type {nut}")
        stat.read = len(nalu)
        return stat

    # xevd_config op codes (ref: inc/xevd.h:120-127)
    CFG_SET_USE_PIC_SIGNATURE = 301
    CFG_GET_CODEC_BIT_DEPTH = 401
    CFG_GET_WIDTH = 402
    CFG_GET_HEIGHT = 403
    CFG_GET_CODED_WIDTH = 404
    CFG_GET_CODED_HEIGHT = 405
    CFG_GET_COLOR_SPACE = 406
    CFG_GET_MAX_CODING_DELAY = 407

    def config(self, cfg: int, value=None):
        """Runtime get/set mirroring xevd_config
        (ref: src_base/xevd.c:2283-2341).  Set ops take `value` and return
        None; get ops return the value."""
        if cfg == self.CFG_SET_USE_PIC_SIGNATURE:
            self.use_pic_signature = bool(value)
            return None
        sps = self.sps
        if sps is None:
            raise ValueError("no sequence configured yet")
        if cfg == self.CFG_GET_CODEC_BIT_DEPTH:
            return sps.bit_depth_luma_minus8 + 8
        w = sps.pic_width_in_luma_samples
        h = sps.pic_height_in_luma_samples
        mul = 2 if sps.chroma_format_idc else 1
        if cfg == self.CFG_GET_WIDTH:
            if sps.picture_cropping_flag:
                w -= mul * (sps.picture_crop_left_offset
                            + sps.picture_crop_right_offset)
            return w
        if cfg == self.CFG_GET_HEIGHT:
            if sps.picture_cropping_flag:
                h -= mul * (sps.picture_crop_top_offset
                            + sps.picture_crop_bottom_offset)
            return h
        if cfg == self.CFG_GET_CODED_WIDTH:
            return w
        if cfg == self.CFG_GET_CODED_HEIGHT:
            return h
        if cfg == self.CFG_GET_COLOR_SPACE:
            return sps.chroma_format_idc
        if cfg == self.CFG_GET_MAX_CODING_DELAY:
            return self.max_coding_delay
        raise ValueError(f"unknown config op {cfg}")

    def pull(self):
        """Returns (OutFrame | None, status) like xevd_pull
        (ref: src_base/xevd.c:2042-2069)."""
        if self.dpm is None:
            return None, "empty"
        pic, status = self.dpm.out_pic()
        if pic is None:
            return None, status
        sps = self.sps
        crop = (sps.picture_crop_left_offset * 2 if sps.picture_cropping_flag else 0,
                sps.picture_crop_right_offset * 2 if sps.picture_cropping_flag else 0,
                sps.picture_crop_top_offset * 2 if sps.picture_cropping_flag else 0,
                sps.picture_crop_bottom_offset * 2 if sps.picture_cropping_flag else 0)
        pad = pic.pad_l
        pad_c = pic.pad_c
        cw_s = 1 if sps.chroma_format_idc in (1, 2) else 0
        ch_s = 1 if sps.chroma_format_idc == 1 else 0
        if self._pending is not None and pic is self._pending[3]:
            # this frame's pack+dispatch is still deferred (pipelined
            # decode): hand out lazy plane views so materialization — at
            # write time, behind the app's lookahead — triggers the drain,
            # keeping the overlap with the next slice's entropy
            y = _LazyPlane(self, pic, "y", (slice(pad, pad + pic.h),
                                            slice(pad, pad + pic.w)))
            if sps.chroma_format_idc:
                cs = (slice(pad_c, pad_c + (pic.h >> ch_s)),
                      slice(pad_c, pad_c + (pic.w >> cw_s)))
                u = _LazyPlane(self, pic, "u", cs)
                v = _LazyPlane(self, pic, "v", cs)
            else:
                u = v = None
        else:
            y = pic.y[pad:pad + pic.h, pad:pad + pic.w]
            if sps.chroma_format_idc:
                u = pic.u[pad_c:pad_c + (pic.h >> ch_s),
                          pad_c:pad_c + (pic.w >> cw_s)]
                v = pic.v[pad_c:pad_c + (pic.h >> ch_s),
                          pad_c:pad_c + (pic.w >> cw_s)]
            else:
                u = v = None
        if sps.is_main and sps.tool_dra and \
                getattr(pic, "dra_aps_id", -1) >= 0:
            y, u, v = self._apply_dra(pic.dra_aps_id, y, u, v)
        # The reference tags every decoded imgb as 10-bit regardless of the
        # SPS bit depth (ref: src_base/xevd_util.c:276 — cs is always
        # *_10LE), so the app's bit-depth conversion treats samples as
        # 10-bit.  We mirror that quirk for output compatibility.
        out = OutFrame(y=y, u=u, v=v,
                       poc=pic.poc, bit_depth=10,
                       chroma_format_idc=sps.chroma_format_idc, crop=crop,
                       sei=pic.sei)
        return out, "ok"

    # -- internals -----------------------------------------------------
    def _sequence_init(self):
        sps = self.sps
        check_decoder_caps(sps)
        check = getattr(self.backend, "check_caps", None)
        if check is not None:
            check(sps)
        from .tables import build_chroma_qp_tables
        # Main with tool_iqt picks the main chroma-QP adjust table
        # (ref: src_main/xevdm.c:472-479)
        self.chroma_qp_tbl = build_chroma_qp_tables(
            sps.bit_depth_chroma_minus8 + 8,
            sps.chroma_qp_table if sps.chroma_qp_table.present else None,
            base_profile=not (sps.is_main and sps.tool_iqt))
        # CTU size (ref: src_main/xevdm.c:328-340)
        if sps.is_main and sps.sps_btt_flag:
            self.log2_ctu = sps.log2_ctu_size_minus5 + 5
            self.log2_min_cu = sps.log2_min_cb_size_minus2 + 2
        else:
            self.log2_ctu = 6
            self.log2_min_cu = 2
        self.dpm = PictureManager(max(sps.max_num_ref_pics, 1))
        self.ref_pic_gap_length = 1 << sps.log2_ref_pic_gap_length
        self.entropy = None  # rebuilt lazily (needs pps)
        if sps.vui_parameters_present_flag and sps.bitstream_restriction_flag:
            self.max_coding_delay = sps.num_reorder_pics

    def _decode_slice(self, bs: BitReader, nut: int, tid: int, stat: Stat):
        sps, pps = self.sps, self.pps
        sh = parse_sh(bs, sps, pps, nut)
        self.sh = sh

        # POC derivation (ref: src_base/xevd.c:1842-1867; MSB/LSB
        # src_main/xevdm.c:3045-3076)
        if self.poc.poc_val > self.poc.prev_pic_max_poc_val:
            self.poc.prev_pic_max_poc_val = self.poc.poc_val
        use_pocs = bool(sps.is_main and sps.tool_pocs)
        if not use_pocs:
            if nut == T.NUT_IDR:
                sh.poc_lsb = 0
                self.poc.prev_doc_offset = -1
                self.poc.prev_poc_val = 0
                self.poc.poc_val = 0
            else:
                poc_derivation(sps, tid, self.poc)
                sh.poc_lsb = self.poc.poc_val
            slice_ref_flag = (tid == 0 or tid < sps.log2_sub_gop_length)
        else:
            if nut == T.NUT_IDR:
                sh.poc_lsb = 0
                self.poc.poc_val = 0
            else:
                max_lsb = 1 << (sps.log2_max_pic_order_cnt_lsb_minus4 + 4)
                lsb = sh.poc_lsb
                prev_lsb = self.poc.prev_poc_val & (max_lsb - 1)
                prev_msb = self.poc.prev_poc_val - prev_lsb
                if lsb < prev_lsb and prev_lsb - lsb >= max_lsb // 2:
                    msb = prev_msb + max_lsb
                elif lsb > prev_lsb and lsb - prev_lsb > max_lsb // 2:
                    msb = prev_msb - max_lsb
                else:
                    msb = prev_msb
                self.poc.poc_val = msb + lsb
                if tid == 0:
                    self.poc.prev_poc_val = self.poc.poc_val
            slice_ref_flag = True

        if sh.slice_type == T.SLICE_I:
            self.last_intra_poc = self.poc.poc_val

        if sps.is_main and sps.tool_rpl:
            # (ref: src_main/xevdm.c:3096-3104)
            self.dpm.refpic_marking_rpl(sh, self.poc.poc_val)
            refp = self.dpm.refp_init_rpl(sh, self.poc.poc_val)
        else:
            refp = self.dpm.refp_init(sh.slice_type, self.poc.poc_val, tid,
                                      self.last_intra_poc)
        num_refp = tuple(self.dpm.num_refp)

        if self.use_native_entropy and not sps.is_main:
            from .derive import job_from_native
            from .native import decode_slice_native
            payload = bytes(bs.buf[bs.bytes_read():])
            if self._pipeline_on:
                # overlap: submit this slice's C entropy (GIL-released) to
                # the worker, then pack+dispatch the PREVIOUS slice on this
                # thread while it runs
                if self._entropy_pool is None:
                    from concurrent.futures import ThreadPoolExecutor
                    self._entropy_pool = ThreadPoolExecutor(max_workers=1)
                self._scratch_flip ^= 1
                fut = self._entropy_pool.submit(
                    decode_slice_native, payload, sps, pps, sh, num_refp,
                    self.chroma_qp_tbl, refp, self.poc.poc_val,
                    self._scratch_flip)
                self._drain_pipeline()
                fs, native_job = fut.result()
            else:
                fs, native_job = decode_slice_native(
                    payload, sps, pps, sh, num_refp, self.chroma_qp_tbl,
                    refp=refp, poc=self.poc.poc_val)
            job = job_from_native(fs, sps, sh, self.chroma_qp_tbl,
                                  native_job)
        elif self.use_native_entropy and sps.is_main:
            from .native import decode_slice_native_main
            payload = bytes(bs.buf[bs.bytes_read():])
            if self._pipeline_on:
                if self._entropy_pool is None:
                    from concurrent.futures import ThreadPoolExecutor
                    self._entropy_pool = ThreadPoolExecutor(max_workers=1)
                self._scratch_flip ^= 1
                fut = self._entropy_pool.submit(
                    decode_slice_native_main, payload, sps, pps, sh,
                    num_refp, self.chroma_qp_tbl, self.log2_ctu,
                    self._scratch_flip)
                self._drain_pipeline()
                fs = fut.result()
            else:
                fs = decode_slice_native_main(
                    payload, sps, pps, sh, num_refp, self.chroma_qp_tbl,
                    self.log2_ctu)
            if getattr(sps, "tool_dmvr", 0) and sh.slice_type == T.SLICE_B:
                # DMVR refinement runs inside the derive loop (refined MVs
                # feed HMVP / the stored map); the C derive has no DMVR,
                # so B slices of DMVR streams use the Python derive.
                job = derive_frame(fs, sps, pps, sh, refp,
                                   self.poc.poc_val, self.chroma_qp_tbl,
                                   num_refp=num_refp,
                                   log2_ctu=self.log2_ctu)
            else:
                from .native import derive_frame_native_main
                job = derive_frame_native_main(
                    fs, sps, pps, sh, refp, self.poc.poc_val,
                    self.chroma_qp_tbl, num_refp, self.log2_ctu)
        else:
            self._drain_pipeline()
            ent = EntropyDecoder(sps, pps, self.chroma_qp_tbl,
                                 log2_ctu=self.log2_ctu)
            fs = ent.decode_slice(bs, sh, num_refp)
            job = derive_frame(fs, sps, pps, sh, refp, self.poc.poc_val,
                               self.chroma_qp_tbl, num_refp=num_refp,
                               log2_ctu=self.log2_ctu)
        if getattr(sh, "alf_on", 0):
            job.alf_param, job.alf_enable = self._assemble_alf(sh)
            job.alf_misc = (self.log2_ctu, bool(
                self.pps.loop_filter_across_tiles_enabled_flag))

        # build / recycle picture; planes are filled by the (possibly
        # deferred) pack+dispatch
        slot = self.dpm.get_empty_slot()
        if slot >= 0:
            self.dpm.remove_pic(slot)
        pic = Picture(w=fs.w, h=fs.h)
        if self._pipeline_on and self.use_native_entropy:
            self._pending = (job, sps, refp, pic, fs)
        else:
            rec_y, rec_u, rec_v = self.backend.decode_frame(job, sps, refp)
            pic.y, pic.u, pic.v = self.backend.make_picture_planes(
                (rec_y, rec_u, rec_v), fs, sps)
        pic.map_mv = job.map_mv
        pic.map_refi = job.map_refi
        # active DRA APS at decode time (applied out-of-loop at pull,
        # ref: src_main/xevdm.c:3321-3346)
        pic.dra_aps_id = (self.pps.pic_dra_aps_id
                          if self.pps.pic_dra_enabled_flag else -1)
        pic.sei = self.pending_sei
        self.pending_sei = []

        self.dpm.put_pic(pic, nut == T.NUT_IDR, self.poc.poc_val, tid, True,
                         refp, slice_ref_flag, self.ref_pic_gap_length,
                         tool_rpl=bool(sps.is_main and sps.tool_rpl))
        self.last_pic = pic

        self._pull_retry = False
        stat.fnum = self.pic_cnt
        stat.stype = sh.slice_type
        stat.poc = self.poc.poc_val
        stat.tid = tid
        stat.refpic = (
            tuple(refp[i][0].poc for i in range(num_refp[0])),
            tuple(refp[i][1].poc for i in range(num_refp[1])),
        )
        self.pic_cnt += 1

    def _drain_pipeline(self):
        """Run the deferred pack+dispatch of the previous slice (fills its
        Picture planes).  Must run before anything reads pixel planes
        (pull, picture signature) or before a new frame packs against
        reference planes."""
        if self._pending is None:
            return
        job, sps, refp, pic, fs = self._pending
        self._pending = None
        rec = self.backend.decode_frame(job, sps, refp)
        pic.y, pic.u, pic.v = self.backend.make_picture_planes(rec, fs, sps)

    def _assemble_alf(self, sh):
        """Assemble the effective ALF params from the APS buffers
        (ref: src_main/xevdm_alf.c:1251-1273 load via
        alf_load_paramline_from_aps_buffer2)."""
        import copy
        py = self.aps_alf[sh.aps_id_y]
        if py is None or not py.enabled_flag[0]:
            raise MalformedBitstream("SH references missing/luma-less "
                                     f"ALF APS {sh.aps_id_y}")
        param = copy.deepcopy(py)
        idc = sh.alf_chroma_idc
        if idc:
            pc = self.aps_alf[getattr(sh, "aps_id_ch", sh.aps_id_y)]
            if pc is None or not pc.chroma_filter_present:
                raise MalformedBitstream("SH references chroma-less ALF APS")
            param.chroma_coeff = list(pc.chroma_coeff)
        return param, (1, idc & 1, (idc >> 1) & 1)

    def _dra_luts(self, aps_id):
        """Cached inverse-DRA LUTs per APS id."""
        cache = getattr(self, "_dra_lut_cache", None)
        if cache is None:
            cache = self._dra_lut_cache = {}
        if aps_id not in cache:
            from .ops.dra import build_dra_luts
            p = self.aps_dra[aps_id]
            if p is None:
                raise MalformedBitstream(f"missing DRA APS {aps_id}")
            cache[aps_id] = build_dra_luts(
                p, self.sps.bit_depth_luma_minus8 + 8, self.chroma_qp_tbl)
        return cache[aps_id]

    def _apply_dra(self, aps_id, y, u, v):
        """Inverse DRA on output copies (the DPB keeps unmapped pixels)."""
        from .ops.dra import apply_dra_inverse
        luma_lut, chroma_lut = self._dra_luts(aps_id)
        y = np.array(np.asarray(y))
        u = None if u is None else np.array(np.asarray(u))
        v = None if v is None else np.array(np.asarray(v))
        apply_dra_inverse(y, u, v, luma_lut, chroma_lut)
        return y, u, v

    def _check_signature(self, sig) -> bool:
        """MD5 per cropped plane (ref: src_base/xevd_util.c:985-1002)."""
        import hashlib
        pic = self.last_pic
        sps = self.sps
        pad, pad_c = pic.pad_l, pic.pad_c
        cw_s = 1 if sps.chroma_format_idc in (1, 2) else 0
        ch_s = 1 if sps.chroma_format_idc == 1 else 0
        cl = sps.picture_crop_left_offset * 2 if sps.picture_cropping_flag else 0
        cr = sps.picture_crop_right_offset * 2 if sps.picture_cropping_flag else 0
        ct = sps.picture_crop_top_offset * 2 if sps.picture_cropping_flag else 0
        cb = sps.picture_crop_bottom_offset * 2 if sps.picture_cropping_flag else 0
        if sps.is_main and sps.tool_dra and \
                getattr(pic, "dra_aps_id", -1) >= 0:
            # the signature covers the DRA-mapped output
            # (ref: src_main/xevdm.c:3268-3286)
            yf = pic.y[pad:pad + pic.h, pad:pad + pic.w]
            uf = vf = None
            if sps.chroma_format_idc:
                uf = pic.u[pad_c:pad_c + (pic.h >> ch_s),
                           pad_c:pad_c + (pic.w >> cw_s)]
                vf = pic.v[pad_c:pad_c + (pic.h >> ch_s),
                           pad_c:pad_c + (pic.w >> cw_s)]
            yd, ud, vd = self._apply_dra(pic.dra_aps_id, yf, uf, vf)
            planes = [yd[ct:pic.h - cb, cl:pic.w - cr]]
            if sps.chroma_format_idc:
                planes += [ud[ct >> ch_s:(pic.h - cb) >> ch_s,
                              cl >> cw_s:(pic.w - cr) >> cw_s],
                           vd[ct >> ch_s:(pic.h - cb) >> ch_s,
                              cl >> cw_s:(pic.w - cr) >> cw_s]]
            for plane, want in zip(planes, sig):
                import hashlib as _h
                dig = _h.md5(np.ascontiguousarray(
                    plane.astype("<u2")).tobytes()).digest()
                if dig[:len(want)] != want:
                    return False
            return True
        planes = []
        y = np.asarray(pic.y[pad + ct:pad + pic.h - cb,
                             pad + cl:pad + pic.w - cr])
        planes.append(y)
        if sps.chroma_format_idc:
            u = np.asarray(pic.u[pad_c + (ct >> ch_s):pad_c + ((pic.h - cb) >> ch_s),
                                 pad_c + (cl >> cw_s):pad_c + ((pic.w - cr) >> cw_s)])
            v = np.asarray(pic.v[pad_c + (ct >> ch_s):pad_c + ((pic.h - cb) >> ch_s),
                                 pad_c + (cl >> cw_s):pad_c + ((pic.w - cr) >> cw_s)])
            planes += [u, v]
        for plane, want in zip(planes, sig):
            dig = hashlib.md5(np.ascontiguousarray(
                np.asarray(plane).astype("<u2")).tobytes()).digest()
            if dig[:len(want)] != want:
                return False
        return True

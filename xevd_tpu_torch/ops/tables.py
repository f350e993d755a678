"""Constant tables on the device, and JAX/numpy picture state into the port.

The decoder has no weights: these tables are its parameters, and the DPB
planes are its state.  Values come from `host/tables.py` (numpy)."""
from __future__ import annotations

import numpy as np
import torch

from ..host import tables as T

from ..plane import DevicePlane

# Bordered working planes: 72 px top/left, 136 px right/bottom, the same
# geometry as the JAX package (xevd_tpu/ops/jax_intra.py BORDER / PAD_R), so
# every neighbour read of the intra scan stays inside the allocation.
BORDER = 72
PAD_R = 136

PAD_L = T.PIC_PAD_SIZE_L        # DPB picture padding, luma (144)
PAD_C = T.PIC_PAD_SIZE_C        # chroma (72)
MIN_TX_VAL = T.MIN_TX_VAL
MAX_TX_VAL = T.MAX_TX_VAL

# EIPD constants (xevd_tpu/ops/jax_intra_main.py:33-36): 1/(n+1) in Q12 by
# log2 size difference, the plane predictor's multiplier and shift by
# log2 size - 2, the bi predictor's weight by log2 aspect ratio
EIPD_LUTP1 = np.array([2048, 1365, 819, 455, 241, 124, 63, 32], np.int32)
EIPD_IBM = np.array([13, 17, 5, 11, 23, 47], np.int32)
EIPD_IBS = np.array([7, 10, 11, 15, 19, 23], np.int32)
EIPD_WC = np.array([0, 341, 205, 114, 60, 31], np.int32)

# The EIPD and HTDF tables as one flat int32 table for the intra_main
# kernel (csrc/intra_main.cu reads it at these offsets)
INTRA_MAIN_PARTS = (("ipred_dxdy", T.IPRED_DXDY), ("ipred_adi", T.IPRED_ADI),
                    ("eipd_lutp1", EIPD_LUTP1), ("eipd_ibm", EIPD_IBM),
                    ("eipd_ibs", EIPD_IBS), ("eipd_wc", EIPD_WC),
                    ("htdf_tbl", T.HTDF_TBL),
                    ("htdf_thr_log2", T.HTDF_THR_LOG2))
# their flattened length (csrc/intra_main.cu TAB_N)
INTRA_MAIN_LEN = sum(np.asarray(a).size for _, a in INTRA_MAIN_PARTS)


def _ats_bases() -> np.ndarray:
    """int32 [2, 6, 32, 32]: [0, lg] the 2^lg-point DST-7, [1, lg] the
    DCT-8 (lg 1..5), zero-padded; TR[k][j] = frequency k, sample j
    (xevd_tpu/tables.py TR_DST7 / TR_DCT8)."""
    out = np.zeros((2, 6, 32, 32), np.int32)
    for kind, tbl in enumerate((T.TR_DST7, T.TR_DCT8)):
        for lg, m in tbl.items():
            out[kind, lg, :1 << lg, :1 << lg] = m
    return out


def device_tables(device: torch.device) -> dict:
    """Transform bases, MC taps and the EIPD/HTDF tables on `device`.

    tm64: int32 [64, 64], the 64-point DCT-2 basis; the n-point basis is
          tm64[::64 // n, :n] (xevd_tpu/tables.py TM2..TM32).
    tr:   int32 [2, 6, 32, 32], the ATS DST-7 ([0]) and DCT-8 ([1]) bases
          by log2 size 1..5 (`_ats_bases`).
    mc_l, mc_c: int32 [16, 8] luma 8-tap filters by 1/16-pel phase and
          [32, 4] chroma 4-tap filters by 1/32-pel phase, Baseline
          (MC_L_COEFF / MC_C_COEFF); mc_l_main, mc_c_main the Main (ADMVP)
          taps of the same shapes (MC_L_COEFF_MAIN / MC_C_COEFF_MAIN).
    intra_main: int32 [305], the EIPD and HTDF tables of INTRA_MAIN_PARTS
          (IPRED_DXDY [33, 2], IPRED_ADI [32, 4], the four EIPD constants,
          HTDF_TBL [5, 16], HTDF_THR_LOG2 [5]) flattened in that order."""
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
    tabs = {"tm64": dev(T.TM[6]), "tr": dev(_ats_bases()),
            "mc_l": dev(T.MC_L_COEFF), "mc_c": dev(T.MC_C_COEFF),
            "mc_l_main": dev(T.MC_L_COEFF_MAIN),
            "mc_c_main": dev(T.MC_C_COEFF_MAIN)}
    tabs["intra_main"] = dev(np.concatenate(
        [np.asarray(a, np.int32).ravel() for _, a in INTRA_MAIN_PARTS]))
    return tabs


def planes_from_numpy(y, u, v, device) -> tuple:
    """Wrap host int16 picture planes (e.g. from the JAX backend) as
    DevicePlanes on `device`; u/v may be None (4:0:0).  The planes are
    copied, so the caller's arrays are never aliased."""
    def one(p):
        if p is None:
            return None
        return DevicePlane(torch.from_numpy(
            np.array(p, dtype=np.int16)).to(device))
    return one(y), one(u), one(v)

"""Triton kernels for reconstruction and pad-expand.

Replaces: xevd_tpu/ops/pipeline.py `_recon_plane` (K4 recon) and `_pad_out`
(K14).  Both are memory-bound elementwise passes with no reuse and no
dependency between threads -- Triton's remit -- so Triton serves as well
as CUDA would, with less code:

  recon: out = clip(resid, 0, 2^bd - 1)    (an intra frame's zero
         prediction; 2 B read + 2 B written a sample)
  pad:   out[i, j] = area[clamp(i - P, 0, h - 1), clamp(j - P, 0, w - 1)]
         (one gather pass; the source rows are L2-resident neighbours)

Bound on the H100: device-memory bandwidth.  Design: 1-D blocks of 2048
samples for recon, 2-D tiles of 32 x 128 for pad.

`triton` is imported by `_jit()` at the first launch, never when the module
is imported: the kernel bodies below are plain functions until then, and
`tl` is bound to `triton.language` just before they are compiled."""
from __future__ import annotations

tl = None  # triton.language, bound by _jit()
_KERNELS = None

RECON_BLOCK = 2048
PAD_BM, PAD_BN = 32, 128


def _recon_kernel(resid_ptr, out_ptr, n, maxv, BLOCK: "tl.constexpr"):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    m = offs < n
    t = tl.load(resid_ptr + offs, mask=m, other=0).to(tl.int32)
    t = tl.minimum(tl.maximum(t, 0), maxv)
    tl.store(out_ptr + offs, t.to(tl.int16), mask=m)


def _pad_kernel(src_ptr, src_stride, out_ptr, out_stride, h, w, P,
                BM: "tl.constexpr", BN: "tl.constexpr"):
    i = tl.program_id(0) * BM + tl.arange(0, BM)
    j = tl.program_id(1) * BN + tl.arange(0, BN)
    si = tl.minimum(tl.maximum(i - P, 0), h - 1)
    sj = tl.minimum(tl.maximum(j - P, 0), w - 1)
    v = tl.load(src_ptr + si[:, None] * src_stride + sj[None, :])
    m = (i[:, None] < h + 2 * P) & (j[None, :] < w + 2 * P)
    tl.store(out_ptr + i[:, None] * out_stride + j[None, :], v, mask=m)


def _jit():
    global tl, _KERNELS
    if _KERNELS is None:
        import triton
        import triton.language
        tl = triton.language
        _KERNELS = (triton.jit(_recon_kernel), triton.jit(_pad_kernel))
    return _KERNELS


def launch_recon(resid, out, bd):
    recon_k, _ = _jit()
    n = resid.numel()
    grid = ((n + RECON_BLOCK - 1) // RECON_BLOCK,)
    recon_k[grid](resid, out, n, (1 << bd) - 1, BLOCK=RECON_BLOCK,
                  num_warps=4)


def launch_pad(area, out, h, w, pad):
    _, pad_k = _jit()
    H, W = out.shape
    grid = ((H + PAD_BM - 1) // PAD_BM, (W + PAD_BN - 1) // PAD_BN)
    pad_k[grid](area, area.stride(0), out, out.stride(0), h, w, pad,
                BM=PAD_BM, BN=PAD_BN, num_warps=4)

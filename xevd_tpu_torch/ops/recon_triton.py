"""Triton kernel for reconstruction.

Replaces: xevd_tpu/ops/pipeline.py `_recon_plane` (K4 recon).  A
memory-bound elementwise pass with no reuse and no dependency between
threads -- Triton's remit -- so Triton serves as well as CUDA would, with
less code:

  recon: out = clip(int16(p + resid), 0, 2^bd - 1), p the MC prediction
         sum, halved with rounding where cnt == 2 (HAS_PRED; 7 B read +
         2 B written a sample), or 0 for an intra frame (2 B + 2 B)

Bound on the H100: device-memory bandwidth.  Design: 1-D blocks of 2048
samples; a GOP batch (K15) runs over its G planes as one flat array.
Pad-expand (K14), a Triton kernel here until it became one CUDA launch a
picture over Y, U and V, is csrc/pad.cu (ops/recon.py `pad_picture`).

`triton` is imported by `_jit()` at the first launch, never when the module
is imported: the kernel body below is a plain function until then, and
`tl` is bound to `triton.language` just before it is compiled."""
from __future__ import annotations

tl = None  # triton.language, bound by _jit()
_KERNEL = None

RECON_BLOCK = 2048


def _recon_kernel(resid_ptr, pred_ptr, cnt_ptr, out_ptr, n, maxv,
                  HAS_PRED: "tl.constexpr", BLOCK: "tl.constexpr"):
    # 64-bit offsets: a GOP batch's G planes may pass 2^31 samples
    offs = tl.program_id(0).to(tl.int64) * BLOCK + tl.arange(0, BLOCK)
    m = offs < n
    t = tl.load(resid_ptr + offs, mask=m, other=0).to(tl.int32)
    if HAS_PRED:
        p = tl.load(pred_ptr + offs, mask=m, other=0)
        c = tl.load(cnt_ptr + offs, mask=m, other=0)
        p = tl.where(c == 2, (p + 1) >> 1, p)
        t = (p + t).to(tl.int16).to(tl.int32)     # wraps, as the reference
    t = tl.minimum(tl.maximum(t, 0), maxv)
    tl.store(out_ptr + offs, t.to(tl.int16), mask=m)


def _jit():
    global tl, _KERNEL
    if _KERNEL is None:
        import triton
        import triton.language
        tl = triton.language
        _KERNEL = triton.jit(_recon_kernel)
    return _KERNEL


def launch_recon(resid, out, bd, pred=None, cnt=None):
    recon_k = _jit()
    n = resid.numel()
    grid = ((n + RECON_BLOCK - 1) // RECON_BLOCK,)
    has_pred = pred is not None
    recon_k[grid](resid, pred if has_pred else resid,
                  cnt if has_pred else resid, out, n, (1 << bd) - 1,
                  HAS_PRED=has_pred, BLOCK=RECON_BLOCK, num_warps=4)


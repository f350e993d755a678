"""CLI decoder on the PyTorch backend, with the flags of xevd_tpu/app.py
plus --device.

Usage: python -m xevd_tpu_torch.app -i in.evc -o out.yuv
           [--output-bit-depth 10] [--device cuda|cpu] [-m N] [-s] [-v N]
"""
from __future__ import annotations

import argparse
import sys
import time

from .host import NAL_UNIT_LENGTH_BYTE, Decoder, info
from .host.utils.yuv import YuvWriter

from .ops.pipeline import TorchPixelBackend

LOOKAHEAD_DEPTH = 4  # decoded frames pending write (device work pipelines)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="xevd_tpu_torch")
    ap.add_argument("-i", "--input", required=True, help="input .evc")
    ap.add_argument("-o", "--output", help="output YUV/Y4M file")
    ap.add_argument("-m", "--threads", type=int, default=1)
    ap.add_argument("-s", "--signature", action="store_true",
                    help="verify picture signature SEI")
    ap.add_argument("-v", "--verbose", type=int, default=1)
    ap.add_argument("-f", "--frames", type=int, default=0,
                    help="max frames to decode (0=all)")
    ap.add_argument("--output-bit-depth", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: hand-written kernels; cpu: plain PyTorch")
    ap.add_argument("--trace", help="write a syntax-element trace "
                    "(CU/split events; forces the Python entropy engine)")
    ap.add_argument("--trace-bins", action="store_true",
                    help="also trace every SBAC bin")
    args = ap.parse_args(argv)

    if args.trace:
        from .host import trace as _trace
        _trace.init(args.trace, bins=args.trace_bins)

    dec = Decoder(threads=args.threads,
                  backend=TorchPixelBackend(device=args.device),
                  use_native_entropy=False if args.trace else None)
    dec.use_pic_signature = args.signature

    try:
        data = open(args.input, "rb").read()
    except OSError as e:
        print(f"ERR: cannot open '{args.input}': {e.strerror}", file=sys.stderr)
        return 1
    lookahead = []
    pos = 0
    writer = None
    n_out = 0
    t0 = time.time()
    bumping = False
    crc_fail = False

    try:
        while True:
            if not bumping:
                if pos + NAL_UNIT_LENGTH_BYTE > len(data):
                    bumping = True
                    continue
                nalu_len, _, _ = info(data[pos:pos + 6])
                if nalu_len <= 0:
                    print("Invalid bitstream size!", file=sys.stderr)
                    return 1
                pos += NAL_UNIT_LENGTH_BYTE
                nalu = data[pos:pos + nalu_len]
                pos += nalu_len
                if len(nalu) < nalu_len:
                    print("ERR: truncated NAL unit", file=sys.stderr)
                    return 1
                stat = dec.decode(nalu)
                if stat.crc_ok is False:
                    crc_fail = True
                have_frame = stat.fnum >= 0
            else:
                have_frame = True

            if have_frame:
                frame, _ = dec.pull()
                if frame is not None:
                    if writer is None and args.output:
                        writer = YuvWriter(args.output, frame.y.shape[1],
                                           frame.y.shape[0],
                                           args.output_bit_depth or 8,
                                           frame.chroma_format_idc,
                                           args.output.endswith(".y4m"))
                    lookahead.append(frame)
                    if writer and len(lookahead) > LOOKAHEAD_DEPTH:
                        # writing a frame may run its deferred device work
                        writer.write(lookahead.pop(0))
                    n_out += 1
                elif bumping:
                    break
            if args.frames and n_out >= args.frames:
                break
        if writer:
            for frame in lookahead:
                writer.write(frame)
    except Exception as e:  # boundary: report and fail, as xevd_tpu.app
        print(f"ERR: decoding failed: {e}", file=sys.stderr)
        return 1
    finally:
        if writer:
            writer.close()

    el = time.time() - t0
    if args.verbose:
        print(f"[xevd_tpu_torch] decoded frames: {n_out} "
              f"(device {dec.backend.device})")
        print(f"total decoding time   = {el*1000:.0f} msec")
        print(f"Average decoding time = {el*1000/max(n_out,1):.1f} msec/frame")
        print(f"Average decoding speed = {n_out/max(el,1e-9):.3f} frames/sec")
        if args.signature:
            print(f"signature check: {'FAIL' if crc_fail else 'OK'}")
    return 2 if crc_fail else 0


if __name__ == "__main__":
    sys.exit(main())

"""YUV / Y4M file output with bit-depth conversion
(behavioral parity with app/xevd_app_util.h writers)."""
from __future__ import annotations

import numpy as np


def conv_plane(plane: np.ndarray, src_bd: int, dst_bd: int) -> np.ndarray:
    if src_bd == dst_bd:
        return plane
    if src_bd > dst_bd:
        # rounding down-shift (ref: app/xevd_app_util.h imgb_conv_16b_to_8b)
        sh = src_bd - dst_bd
        add = 1 << (sh - 1)
        return np.clip((plane.astype(np.int32) + add) >> sh, 0,
                       (1 << dst_bd) - 1)
    return plane.astype(np.int32) << (dst_bd - src_bd)


def plane_bytes(plane: np.ndarray, bd: int) -> bytes:
    if bd == 8:
        return np.ascontiguousarray(plane.astype(np.uint8)).tobytes()
    return np.ascontiguousarray(plane.astype("<u2")).tobytes()


class YuvWriter:
    def __init__(self, path: str, w: int, h: int, out_bd: int,
                 chroma_format_idc: int = 1, y4m: bool = False, fps=30):
        self.f = open(path, "wb")
        self.w, self.h = w, h
        self.out_bd = out_bd
        self.cfi = chroma_format_idc
        self.y4m = y4m
        self.wrote_header = False
        self.fps = fps

    def _y4m_header(self):
        cs = {0: "mono", 1: "420", 2: "422", 3: "444"}[self.cfi]
        if self.out_bd > 8:
            cs += f"p{self.out_bd}"
        hdr = f"YUV4MPEG2 W{self.w} H{self.h} F{self.fps}:1 Ip A0:0 C{cs}\n"
        self.f.write(hdr.encode())

    def write(self, frame):
        """frame: OutFrame-like with y/u/v planes and bit_depth."""
        if self.y4m and not self.wrote_header:
            self._y4m_header()
            self.wrote_header = True
        if self.y4m:
            self.f.write(b"FRAME\n")
        bd = frame.bit_depth
        y = np.asarray(frame.y)
        self.f.write(plane_bytes(conv_plane(y, bd, self.out_bd), self.out_bd))
        if self.cfi:
            u = np.asarray(frame.u)
            v = np.asarray(frame.v)
            self.f.write(plane_bytes(conv_plane(u, bd, self.out_bd), self.out_bd))
            self.f.write(plane_bytes(conv_plane(v, bd, self.out_bd), self.out_bd))

    def close(self):
        self.f.close()

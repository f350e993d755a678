"""Bit-serial I/O for EVC bitstreams.

Reader semantics mirror the reference bit reader (ref: src_base/xevd_bsr.c):
MSB-first, 32-bit refill cache, exp-Golomb ue(v)/se(v).  This runs on the
host — it is intentionally simple Python; the hot entropy loop lives in the
SBAC engine (see sbac.py / native backend).
"""
from __future__ import annotations


class BitReader:
    """MSB-first bit reader with 32-bit cache (ref: src_base/xevd_bsr.c:39-97)."""

    __slots__ = ("buf", "size", "cur", "code", "leftbits")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.size = len(buf)
        self.cur = 0          # next byte offset to load
        self.code = 0         # 32-bit cache, MSB-aligned
        self.leftbits = 0

    def _flush(self, nbytes: int = 4) -> bool:
        """Refill cache with up to nbytes; returns False at stream end."""
        remained = self.size - self.cur
        if nbytes > remained:
            nbytes = remained
        if nbytes <= 0:
            self.code = 0
            self.leftbits = 0
            return False
        self.leftbits = nbytes << 3
        code = 0
        shift = 24
        for i in range(nbytes):
            code |= self.buf[self.cur + i] << shift
            shift -= 8
        self.cur += nbytes
        self.code = code
        return True

    def read(self, size: int) -> int:
        code = 0
        if self.leftbits < size:
            code = self.code >> (32 - size)
            size -= self.leftbits
            if not self._flush():
                return 0xFFFFFFFF
        code |= self.code >> (32 - size)
        if size == 32:
            self.code = 0
            self.leftbits = 0
        else:
            self.code = (self.code << size) & 0xFFFFFFFF
            self.leftbits -= size
        return code

    def read1(self) -> int:
        if self.leftbits == 0:
            if not self._flush():
                return 0
        code = self.code >> 31
        self.code = (self.code << 1) & 0xFFFFFFFF
        self.leftbits -= 1
        return code

    def read_ue(self) -> int:
        if (self.code >> 31) == 1:
            self.code = (self.code << 1) & 0xFFFFFFFF
            self.leftbits -= 1
            return 0
        clz = 0
        if self.code == 0:
            clz = self.leftbits
            self._flush()
        # count leading zeros of the 32-bit cache
        len_ = 32 if self.code == 0 else 32 - self.code.bit_length()
        clz += len_
        if clz == 0:
            self.code = (self.code << 1) & 0xFFFFFFFF
            self.leftbits -= 1
            return 0
        return self.read(len_ + clz + 1) - 1

    def read_se(self) -> int:
        v = self.read_ue()
        return (v + 1) >> 1 if (v & 1) else -(v >> 1)

    def is_byte_aligned(self) -> bool:
        return (self.leftbits & 0x7) == 0

    def align(self):
        while not self.is_byte_aligned():
            self.read1()

    def bytes_read(self) -> int:
        return self.cur - (self.leftbits >> 3)

    def at_end(self) -> bool:
        return self.cur >= self.size and self.leftbits == 0


class BitWriter:
    """MSB-first bit writer (used by the test-stream generator and tracing)."""

    def __init__(self):
        self.bits = []  # list of 0/1

    def write(self, val: int, size: int):
        for i in range(size - 1, -1, -1):
            self.bits.append((val >> i) & 1)

    def write1(self, val: int):
        self.bits.append(val & 1)

    def write_ue(self, val: int):
        v = val + 1
        n = v.bit_length()
        self.write(0, n - 1)
        self.write(v, n)

    def write_se(self, val: int):
        self.write_ue(2 * val - 1 if val > 0 else -2 * val)

    def align(self, bit: int = 0):
        while len(self.bits) % 8:
            self.bits.append(bit)

    def num_bits(self) -> int:
        return len(self.bits)

    def to_bytes(self) -> bytes:
        assert len(self.bits) % 8 == 0
        out = bytearray()
        for i in range(0, len(self.bits), 8):
            b = 0
            for j in range(8):
                b = (b << 1) | self.bits[i + j]
            out.append(b)
        return bytes(out)

"""Decoded-picture buffer: sliding-window marking, ref-list construction and
bumping output (ref: src_base/xevd_picman.c).

Pictures hold their planes as backend arrays (numpy or jax device arrays in
HBM) plus the per-SCU motion field needed for temporal MVP.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from . import tables as T


@dataclass
class Picture:
    poc: int = 0
    temporal_id: int = 0
    is_ref: bool = False
    need_for_out: bool = False
    # planes are padded by PIC_PAD on every side (luma); chroma by PIC_PAD/2
    y: object = None
    u: object = None
    v: object = None
    pad_l: int = T.PIC_PAD_SIZE_L
    pad_c: int = T.PIC_PAD_SIZE_C
    w: int = 0
    h: int = 0
    map_mv: np.ndarray = None    # int16 [h_scu, w_scu, 2, 2]
    map_refi: np.ndarray = None  # int8  [h_scu, w_scu, 2]
    list_poc: np.ndarray = None  # int32 [MAX_NUM_REF_PICS]
    sei: list = field(default_factory=list)
    dts: int = 0
    pts: int = 0


class RefPicView:
    """Reference-picture view used by motion derivation: poc + motion field."""

    __slots__ = ("pic", "poc", "map_mv", "map_refi", "list_poc")

    def __init__(self, pic: Picture):
        self.pic = pic
        self.poc = pic.poc
        self.map_mv = pic.map_mv
        self.map_refi = pic.map_refi
        self.list_poc = pic.list_poc


class PictureManager:
    """Sliding-window DPB (no RPL), Baseline
    (ref: src_base/xevd_picman.c:68-584)."""

    def __init__(self, max_num_ref_pics: int):
        self.pic: List[Optional[Picture]] = [None] * T.MAX_PB_SIZE
        self.pic_ref: List[Picture] = []
        self.cur_num_ref_pics = 0
        self.max_num_ref_pics = max_num_ref_pics
        self.poc_next_output = 0
        self.poc_increase = 1
        self.num_refp = [0, 0]

    # -- internals ------------------------------------------------------
    def _move_pic(self, frm: int, to: int):
        p = self.pic[frm]
        for i in range(frm, to):
            self.pic[i] = self.pic[i + 1]
        self.pic[to] = p

    def _marking_no_rpl(self, ref_pic_gap_length: int):
        """(ref: src_base/xevd_picman.c:68-110)"""
        i = 0
        while i < T.MAX_PB_SIZE:
            p = self.pic[i]
            if p and p.is_ref and (
                    p.temporal_id > 0 or
                    (i > 0 and ref_pic_gap_length > 0 and
                     p.poc % ref_pic_gap_length != 0)):
                p.is_ref = False
                self._move_pic(i, T.MAX_PB_SIZE - 1)
                if self.cur_num_ref_pics > 0:
                    self.cur_num_ref_pics -= 1
                continue  # re-check same index
            i += 1
        while self.cur_num_ref_pics >= T.MAX_NUM_ACTIVE_REF_FRAME:
            for i in range(T.MAX_PB_SIZE):
                p = self.pic[i]
                if p and p.is_ref:
                    p.is_ref = False
                    self._move_pic(i, T.MAX_PB_SIZE - 1)
                    self.cur_num_ref_pics -= 1
                    break

    def _flush(self):
        """IDR flush with POC rebase (ref: src_base/xevd_picman.c:112-156)."""
        i = 0
        while i < T.MAX_PB_SIZE:
            p = self.pic[i]
            if p and p.is_ref:
                p.is_ref = False
                self._move_pic(i, T.MAX_PB_SIZE - 1)
                continue
            i += 1
        max_poc = 0
        for p in self.pic:
            if p and p.need_for_out and p.poc != 0 and p.poc > max_poc:
                max_poc = p.poc
        if max_poc:
            max_poc += 1
        reordered_min = None
        for p in self.pic:
            if p and p.need_for_out and p.poc != 0:
                p.is_ref = False
                p.poc -= max_poc
                if reordered_min is None or p.poc < reordered_min:
                    reordered_min = p.poc
        self.poc_next_output = 0 if max_poc == 0 else reordered_min
        self.cur_num_ref_pics = 0

    def _update_pic_ref(self):
        refs = [p for p in self.pic if p and p.is_ref]
        refs.sort(key=lambda p: -p.poc)
        self.pic_ref = refs

    # -- API ------------------------------------------------------------
    def refp_init(self, slice_type: int, poc: int, layer_id: int,
                  last_intra: int):
        """Build L0/L1 lists; returns refp[ridx][lidx] views or raises
        (ref: src_base/xevd_picman.c:291-425)."""
        refp = [[None, None] for _ in range(T.MAX_NUM_REF_PICS)]
        self.num_refp = [0, 0]
        if slice_type == T.SLICE_I:
            return refp
        self._update_pic_ref()
        if self.cur_num_ref_pics <= 0:
            raise ValueError("no reference pictures available")
        max_num = self.max_num_ref_pics
        pr = self.pic_ref
        cnt = 0
        if slice_type == T.SLICE_P:
            if layer_id > 0:
                for p in pr:
                    if cnt >= max_num:
                        break
                    if layer_id == 1:
                        if p.poc < poc and p.temporal_id <= layer_id:
                            refp[cnt][0] = RefPicView(p)
                            cnt += 1
                    elif p.poc < poc and cnt == 0:
                        refp[cnt][0] = RefPicView(p)
                        cnt += 1
                    elif cnt != 0 and p.poc < poc and p.temporal_id <= 1:
                        refp[cnt][0] = RefPicView(p)
                        cnt += 1
            else:
                for p in pr:
                    if cnt >= max_num:
                        break
                    if poc >= last_intra and p.poc < last_intra:
                        continue
                    if p.poc < poc:
                        refp[cnt][0] = RefPicView(p)
                        cnt += 1
        else:  # SLICE_B
            next_layer = max(layer_id - 1, 0)
            for p in pr:
                if cnt >= max_num:
                    break
                if poc >= last_intra and p.poc < last_intra:
                    continue
                if p.poc < poc and p.temporal_id <= next_layer:
                    refp[cnt][0] = RefPicView(p)
                    cnt += 1
                    next_layer = max(p.temporal_id - 1, 0)
            if cnt < max_num:
                next_layer = max(layer_id - 1, 0)
                for p in reversed(pr):
                    if cnt >= max_num:
                        break
                    if poc >= last_intra and p.poc < last_intra:
                        continue
                    if p.poc > poc and p.temporal_id <= next_layer:
                        refp[cnt][0] = RefPicView(p)
                        cnt += 1
                        next_layer = max(p.temporal_id - 1, 0)
        if cnt == 0:
            raise ValueError("empty L0")
        self.num_refp[0] = cnt

        if slice_type == T.SLICE_B:
            cnt = 0
            next_layer = max(layer_id - 1, 0)
            for p in reversed(pr):
                if cnt >= max_num:
                    break
                if poc >= last_intra and p.poc < last_intra:
                    continue
                if p.poc > poc and p.temporal_id <= next_layer:
                    refp[cnt][1] = RefPicView(p)
                    cnt += 1
                    next_layer = max(p.temporal_id - 1, 0)
            if cnt < max_num:
                next_layer = max(layer_id - 1, 0)
                for p in pr:
                    if cnt >= max_num:
                        break
                    if poc >= last_intra and p.poc < last_intra:
                        continue
                    if p.poc < poc and p.temporal_id <= next_layer:
                        refp[cnt][1] = RefPicView(p)
                        cnt += 1
                        next_layer = max(p.temporal_id - 1, 0)
            if cnt == 0:
                raise ValueError("empty L1")
            self.num_refp[1] = cnt
        return refp

    def refpic_marking_rpl(self, sh, poc_val: int):
        """RPL-based reference marking: unmark any DPB reference picture
        not listed in either RPL (ref: src_main/xevdm_picman.c:542-594)."""
        self._update_pic_ref()
        keep = {poc_val - d for d in sh.rpl_l0.ref_pics} | \
               {poc_val - d for d in sh.rpl_l1.ref_pics} \
               if sh.rpl_l0 is not None else set()
        n_check = self.cur_num_ref_pics
        i = 0
        while i < n_check:
            p = self.pic[i]
            if p is not None and p.is_ref and p.poc not in keep:
                p.is_ref = False
                self._move_pic(i, T.MAX_PB_SIZE - 1)
                self.cur_num_ref_pics -= 1
                n_check -= 1
                continue
            i += 1

    def refp_init_rpl(self, sh, poc_val: int):
        """Explicit reference lists from the signalled RPLs
        (ref: src_main/xevdm_picman.c:315-369)."""
        refp = [[None, None] for _ in range(T.MAX_NUM_REF_PICS)]
        self.num_refp = [0, 0]
        if sh.slice_type == T.SLICE_I:
            return refp
        self._update_pic_ref()
        if self.cur_num_ref_pics <= 0:
            raise ValueError("no reference pictures available")

        def find(target_poc):
            for p in self.pic_ref:
                if p.poc == target_poc:
                    return p
            raise ValueError(f"RPL references POC {target_poc} "
                             "not in the DPB")

        for i in range(min(sh.rpl_l0.ref_pic_active_num,
                           len(sh.rpl_l0.ref_pics))):
            refp[i][0] = RefPicView(find(poc_val - sh.rpl_l0.ref_pics[i]))
            self.num_refp[0] += 1
        if sh.slice_type == T.SLICE_P:
            return refp
        for i in range(min(sh.rpl_l1.ref_pic_active_num,
                           len(sh.rpl_l1.ref_pics))):
            refp[i][1] = RefPicView(find(poc_val - sh.rpl_l1.ref_pics[i]))
            self.num_refp[1] += 1
        return refp

    def get_empty_slot(self) -> int:
        """Index into self.pic of a recyclable picture or -1."""
        for i, p in enumerate(self.pic):
            if p is not None and not p.is_ref and not p.need_for_out:
                return i
        return -1

    def remove_pic(self, pos: int) -> Picture:
        p = self.pic[pos]
        for i in range(pos, T.MAX_PB_SIZE - 1):
            self.pic[i] = self.pic[i + 1]
        self.pic[T.MAX_PB_SIZE - 1] = None
        return p

    def put_pic(self, pic: Picture, is_idr: bool, poc: int, temporal_id: int,
                need_for_output: bool, refp, slice_ref_flag: bool,
                ref_pic_gap_length: int, tool_rpl: bool = False):
        """(ref: src_base/xevd_picman.c:462-510; rpl gate
        src_main/xevdm_picman.c:600-616)"""
        if is_idr:
            self._flush()
        elif not tool_rpl and temporal_id == 0:
            self._marking_no_rpl(ref_pic_gap_length)

        pic.is_ref = bool(slice_ref_flag)
        pic.temporal_id = temporal_id
        pic.poc = poc
        pic.need_for_out = need_for_output
        pic.list_poc = np.zeros(T.MAX_NUM_REF_PICS, dtype=np.int64)
        for i in range(self.num_refp[0]):
            pic.list_poc[i] = refp[i][0].poc

        if pic.is_ref:
            pos = self.cur_num_ref_pics
            assert self.pic[pos] is None, "DPB slot invariant violated"
            self.pic[pos] = pic
            self.cur_num_ref_pics += 1
        else:
            for i in range(T.MAX_PB_SIZE - 1, -1, -1):
                if self.pic[i] is None:
                    self.pic[i] = pic
                    break

    def peek_out_pic(self):
        """The picture out_pic() would bump next, without mutating."""
        for p in self.pic:
            if p is not None and p.need_for_out and \
                    p.poc <= self.poc_next_output:
                return p
        return None

    def out_pic(self):
        """Bump next output picture or (None, delayed?) — returns
        (pic | None, 'ok'|'delayed'|'empty')
        (ref: src_base/xevd_picman.c:512-546)."""
        any_need = False
        for p in self.pic:
            if p is not None and p.need_for_out:
                any_need = True
                if p.poc <= self.poc_next_output:
                    p.need_for_out = False
                    self.poc_next_output = p.poc + self.poc_increase
                    return p, "ok"
        return None, ("delayed" if any_need else "empty")

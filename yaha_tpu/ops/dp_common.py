"""Backend-independent DP constants and host-side backtrack decodes.

Shared by the XLA (sw_batch), numpy (sw_numpy), Pallas (sw_pallas), and
native C++ backends; importing this module must stay jax-free so the
host-only paths (oracle, native, numpy) never pay the jax import cost.
"""
from __future__ import annotations

DP_WORST = -(0x7FFFFF00)

# Op codes (int8) for the device arrays; mapping to the reference op chars.
OP_UNKNOWN = 0
OP_MATCH = 1
OP_REPLACE = 2
OP_INSERT = 3
OP_DELETE = 4
OP_CHARS = ["U", "M", "R", "I", "D"]


def traceback_extension(eo, idc, maxi, maxj, score, bw2, reverse):
    """Host run-length decode of one problem's backtrack arrays.

    Mirrors the banded backtrack (SW.cpp:1137-1195): Delete moves left in
    the band, Insert moves up-right, M/R up.  Returns (items, added_q,
    added_r) with items in final list order.
    """
    if score <= 0:
        return [], 0, 0
    x = int(maxj)
    y = int(maxi)
    prev = int(eo[y][x])
    op_len = 0
    items = []
    while True:
        code = int(eo[y][x])
        if code == OP_UNKNOWN:
            break
        length = int(idc[y][x])
        if code == OP_DELETE:
            x -= length
        elif code == OP_INSERT:
            x += length
            y -= length
        else:
            y -= 1
            length = 1
        if prev != code:
            if reverse:
                items.append([OP_CHARS[prev], op_len])
            else:
                items.insert(0, [OP_CHARS[prev], op_len])
            prev = code
            op_len = length
        else:
            op_len += length
    if reverse:
        items.append([OP_CHARS[prev], op_len])
    else:
        items.insert(0, [OP_CHARS[prev], op_len])
    added_q = int(maxi)
    added_r = int(maxi) + (int(maxj) - bw2)
    return items, added_q, added_r


# Packed-backtrack bit layout (sw_pallas kernels): op in bits 0-2,
# "delete run continues one cell left" in bit 3, "insert run continues up
# the chain" in bit 4.  Run lengths are recovered by chasing the bits, so
# the walkers below decode exactly the runs the unpacked (eo, idc)
# walkers above do.
BT_OP = 7
BT_CD = 8
BT_CF = 16


def traceback_extension_packed(bt, maxi, maxj, score, bw2, reverse):
    """Packed-plane twin of traceback_extension (band coordinates:
    delete chases left along the row, insert chases up-right)."""
    if score <= 0:
        return [], 0, 0
    x = int(maxj)
    y = int(maxi)
    prev = int(bt[y][x]) & BT_OP
    op_len = 0
    items = []
    while True:
        b = int(bt[y][x])
        code = b & BT_OP
        if code == OP_UNKNOWN:
            break
        if code == OP_DELETE:
            length = 1
            xx = x
            while int(bt[y][xx]) & BT_CD:
                length += 1
                xx -= 1
            x -= length
        elif code == OP_INSERT:
            length = 1
            yy, xx = y, x
            while int(bt[yy][xx]) & BT_CF:
                length += 1
                yy -= 1
                xx += 1
            x += length
            y -= length
        else:
            y -= 1
            length = 1
        if prev != code:
            if reverse:
                items.append([OP_CHARS[prev], op_len])
            else:
                items.insert(0, [OP_CHARS[prev], op_len])
            prev = code
            op_len = length
        else:
            op_len += length
    if reverse:
        items.append([OP_CHARS[prev], op_len])
    else:
        items.insert(0, [OP_CHARS[prev], op_len])
    added_q = int(maxi)
    added_r = int(maxi) + (int(maxj) - bw2)
    return items, added_q, added_r


def traceback_anchored_banded_packed(bt_b, lbw, qlen, rlen):
    """Anchored packed-plane decode in band-relative layout (column
    o = j - i + lbw: delete chases left, insert chases (y-1, o+1))."""
    y = int(qlen)
    o = int(rlen) - y + int(lbw)
    prev = int(bt_b[y][o]) & BT_OP
    op_len = 0
    items = []
    while True:
        b = int(bt_b[y][o])
        code = b & BT_OP
        if code == OP_UNKNOWN:
            break
        if code == OP_DELETE:
            length = 1
            oo = o
            while int(bt_b[y][oo]) & BT_CD:
                length += 1
                oo -= 1
            o -= length
        elif code == OP_INSERT:
            length = 1
            yy, oo = y, o
            while int(bt_b[yy][oo]) & BT_CF:
                length += 1
                yy -= 1
                oo += 1
            y -= length
            o += length
        else:
            y -= 1
            length = 1
        if prev != code:
            items.insert(0, [OP_CHARS[prev], op_len])
            prev = code
            op_len = length
        else:
            op_len += length
    items.insert(0, [OP_CHARS[prev], op_len])
    return items


def traceback_anchored(eo, idc, qlen, rlen):
    """Host run-length decode for anchored problems (full coordinates).

    Mirrors the non-banded backtrack arm (SW.cpp:1172-1178); banded
    problems computed by batched_anchored_forward land on the same cells
    in full coordinates.
    """
    x = int(rlen)
    y = int(qlen)
    prev = int(eo[y][x])
    op_len = 0
    items = []
    while True:
        code = int(eo[y][x])
        if code == OP_UNKNOWN:
            break
        length = int(idc[y][x])
        if code == OP_DELETE:
            x -= length
        elif code == OP_INSERT:
            y -= length
        else:
            x -= 1
            y -= 1
            length = 1
        if prev != code:
            items.insert(0, [OP_CHARS[prev], op_len])
            prev = code
            op_len = length
        else:
            op_len += length
    items.insert(0, [OP_CHARS[prev], op_len])
    return items

"""Per-byte context state: rolling hashes, words, byte classes, brackets.

Port of cmix_tpu/contexts/hashes.py (same constants, same update rule),
batched over blocks.  Every u32 leaf is an int64 tensor holding the u32
value (see ``u32``).  The WRT codeword tracker runs at the gate value
``wrtw`` given to ``update_ctx_state_batched`` (the JAX package reads a
module global): at 0 its leaves only carry through, at 1 a completed
codeword latches its byte hash as the last word and stem, at 2 and above
the dictionary's ``build_wrtw_tables`` identities where it has them.
"""

import numpy as np
import torch

from portbench.reference.u32 import M32, PHI32, mix32

MAX_ORDER = 24          # rolling hashes maintained for orders 1..MAX_ORDER
# WRTW >= 2: per-codeword-id tables of the word and stem hashes the letter
# tracker computes for the word's lowercase spelling (ids past the list
# are 0 rows: the codeword's byte hash stands in)
WRTW_TAB_N = 32768
# the codeword layout of preprocess/wrt.py (Dictionary._emit_code)
_CW_N1, _CW_N2 = 64, 48 * 256


def build_wrtw_tables(words):
    """words: lowercase spellings in codeword-id order -> (word_hash,
    stem_hash) uint32 arrays of WRTW_TAB_N rows (copy of
    cmix_tpu/contexts/hashes.py)."""
    wt = np.zeros(WRTW_TAB_N, np.uint32)
    st = np.zeros(WRTW_TAB_N, np.uint32)

    def _mix(h, x):
        h = ((h ^ x) * PHI32) & M32
        return h ^ (h >> 15)

    for i, w in enumerate(words[:WRTW_TAB_N]):
        h = 0
        hist = [h]                      # hist[k] = hash of first k letters
        for ch in w:
            h = _mix(h, ord(ch))
            hist.append(h)
        n = len(w)
        # the suffix rules of update_ctx_state_batched's m3/m2/m1 (its
        # wordlen cap at 63 is beyond a dictionary word's length)
        if n >= 5 and w[-3:] in ("ing", "ion"):
            s = hist[n - 3]
        elif n >= 4 and w[-2:] in ("ed", "er", "es", "ly", "al"):
            s = hist[n - 2]
        elif n >= 3 and w[-1] == "s" and w[-2] != "s":
            s = hist[n - 1]
        else:
            s = h
        wt[i], st[i] = h, s
    return wt, st


def byte_class_map():
    """256 -> 16 byte classes (format constant)."""
    cls = np.zeros(256, dtype=np.int64)
    for b in range(256):
        c = chr(b) if b < 128 else None
        if b in (9, 11, 12):
            v = 1
        elif b in (10, 13):
            v = 2
        elif b == 32:
            v = 3
        elif c is not None and c.isdigit():
            v = 4
        elif c is not None and "a" <= c <= "z":
            v = 5 if c in "aeiou" else 6
        elif c is not None and "A" <= c <= "Z":
            v = 7
        elif c is not None and c in ".,;:!?":
            v = 8
        elif c is not None and c in "'\"`":
            v = 9
        elif c is not None and c in "()[]{}<>":
            v = 10
        elif c is not None and c in "+-*/=%&|^~":
            v = 11
        elif c is not None and c in "_#@$\\":
            v = 12
        elif b < 32:
            v = 0
        elif b < 128:
            v = 13
        elif b < 192:
            v = 14
        else:
            v = 15
        cls[b] = v
    return cls


BYTE_CLASS = byte_class_map()
LOWER_MAP = np.arange(256, dtype=np.int64)
LOWER_MAP[65:91] += 32
IS_LETTER = np.zeros(256, dtype=np.int64)
IS_LETTER[65:91] = 1
IS_LETTER[97:123] = 1
BR_OPEN = np.zeros(256, dtype=np.int64)
BR_CLOSE = np.zeros(256, dtype=np.int64)
for _o, _c, _i in ((40, 41, 1), (91, 93, 2), (123, 125, 3), (60, 62, 4)):
    BR_OPEN[_o] = _i
    BR_CLOSE[_c] = _i
for _q, _i in ((34, 5), (39, 6), (96, 7)):
    BR_OPEN[_q] = _i
    BR_CLOSE[_q] = _i
BRK_DEPTH = 16
LINE_W = 64
CELL_W = 32
CLS2 = np.full(256, 3, dtype=np.int64)
CLS2[65:91] = 0
CLS2[97:123] = 0
CLS2[48:58] = 1
for _b in (9, 10, 13, 32):
    CLS2[_b] = 2
IS_SENT_END = np.zeros(256, dtype=np.int64)
for _b in (46, 33, 63):
    IS_SENT_END[_b] = 1

# (B,) scalar leaves of the context state, all zero at init
_SCALARS = ("last4", "last8", "tag", "tagacc", "tagdepth", "word",
            "last_word", "last_word2", "word_pfx", "wordlen", "wq1", "wq2",
            "wq3", "wtail", "last_stem", "clsreg", "cls2reg", "sentpos",
            "linepos", "brk_depth", "bytecnt", "plen", "cellidx", "cellpos",
            "listdepth", "listchar", "lml", "cwacc", "cwrem", "cwid")

_LUTS = {}


def _lut(name, device):
    """Format-constant byte tables as int64 tensors on ``device``."""
    key = (name, str(device))
    if key not in _LUTS:
        _LUTS[key] = torch.as_tensor(globals()[name], device=device)
    return _LUTS[key]


def init_ctx_state(B, device):
    """Context state for B blocks (batched; u32 leaves as int64)."""
    z = lambda *s: torch.zeros((B,) + s, dtype=torch.int64, device=device)
    cs = {k: z() for k in _SCALARS}
    cs["lsflag"] = torch.ones(B, dtype=torch.int64, device=device)
    cs["ohash"] = z(MAX_ORDER + 1)
    cs["brk_stack"] = z(BRK_DEPTH)
    cs["lbuf"] = z(LINE_W)
    cs["plbuf"] = torch.full((B, LINE_W), 0xFFFF, dtype=torch.int64,
                             device=device)
    cs["cellbuf"] = torch.full((B, CELL_W), 0xFFFF, dtype=torch.int64,
                               device=device)
    cs["pcellbuf"] = torch.full((B, CELL_W), 0xFFFF, dtype=torch.int64,
                                device=device)
    return cs


def line_expected(cs):
    """(expected, alive): the previous-line byte at the current column."""
    cpos = torch.clamp(cs["linepos"], max=LINE_W - 1)
    above = torch.gather(cs["plbuf"], 1, cpos[:, None])[:, 0]
    exp = torch.where(
        (cs["linepos"] < cs["plen"]) & (cs["linepos"] < LINE_W), above,
        torch.where(cs["linepos"] == cs["plen"], 10, 0x1FF))
    alive = (cs["lml"] == cs["linepos"]) & (exp < 256) & (cs["plen"] > 0)
    return exp, alive


def bracket_ctx(cs):
    """Top bracket id * 64 + capped distance since it opened."""
    depth = cs["brk_depth"]
    idx = torch.clamp(depth - 1, 0, BRK_DEPTH - 1)
    top = torch.gather(cs["brk_stack"], 1, idx[:, None])[:, 0]
    tid = torch.where(depth > 0, top >> 24, 0)
    dist = torch.where(
        depth > 0,
        torch.clamp((cs["bytecnt"] - (top & 0xFFFFFF)) & M32, max=63), 0)
    return tid * 64 + dist


def _brk_step(stack, depth, pos, b):
    dev = b.device
    open_id = _lut("BR_OPEN", dev)[b]
    close_id = _lut("BR_CLOSE", dev)[b]
    idx = torch.clamp(depth - 1, 0, BRK_DEPTH - 1)
    top = torch.gather(stack, 1, idx[:, None])[:, 0]
    top_id = torch.where(depth > 0, top >> 24, 0)
    do_pop = (close_id > 0) & (top_id == close_id)
    do_push = (open_id > 0) & ~do_pop
    entry = (open_id << 24) | (pos & 0xFFFFFF)
    pidx = torch.clamp(depth, max=BRK_DEPTH - 1)
    lane = torch.arange(BRK_DEPTH, device=dev)
    sel = do_push[:, None] & (lane[None, :] == pidx[:, None])
    stack = torch.where(sel, entry[:, None], stack)
    depth = torch.where(do_pop, torch.clamp(depth, min=1) - 1,
                        torch.where(do_push,
                                    torch.clamp(depth + 1, max=BRK_DEPTH),
                                    depth))
    return stack, depth


def _cc(*chars):
    v = 0
    for ch in chars:
        v = (v << 8) | ord(ch)
    return v


def _wrtw_step(cs, b, wrtw, wrtw_tab, last_word, last_word2, last_stem):
    """The WRT codeword tracker (gate WRTW >= 1): a codeword's lead
    (0x80-0xBF one byte, 0xC0-0xEF two, 0xF0-0xFF three) starts a byte
    hash ``cwacc``, ``cwrem`` counts its bytes still to come (15: an ESC
    was seen, the next byte is a literal) and at WRTW >= 2 ``cwid`` builds
    the codeword id; a completed codeword becomes the last word and stem.
    -> (cwacc, cwrem, cwid, last_word, last_word2, last_stem)."""
    esc_pend = cs["cwrem"] == 15
    track = (cs["cwrem"] == 0) & ~esc_pend
    is_esc = track & (b == 0x04)
    lead = track & (b >= 0x80) & ~is_esc
    rem_new = torch.where(
        lead, torch.where(b >= 0xF0, 2, torch.where(b >= 0xC0, 1, 0)),
        torch.clamp(cs["cwrem"], min=1) - 1)
    cont = (cs["cwrem"] > 0) & ~esc_pend
    in_cw = lead | cont
    cwacc = torch.where(lead, mix32(b, 0x051ED270),
                        torch.where(cont, mix32(cs["cwacc"], b),
                                    cs["cwacc"]))
    cw_done = in_cw & (rem_new == 0)
    cwrem = torch.where(is_esc, 15, torch.where(in_cw, rem_new, 0))
    cwid = cs["cwid"]
    if wrtw >= 2:
        lead_id = torch.where(
            b >= 0xF0, _CW_N1 + _CW_N2 + ((b - 0xF0) << 16),
            torch.where(b >= 0xC0, _CW_N1 + ((b - 0xC0) << 8), b - 0x80))
        # rem_new is 0 or 1 on a continuation byte (the clamp only keeps
        # the discarded lanes' shift in range)
        shift = 8 * torch.clamp(rem_new, max=2)
        cwid = torch.where(lead, lead_id,
                           torch.where(cont, (cwid + (b << shift)) & M32,
                                       cwid))
    last_word2 = torch.where(cw_done, last_word, last_word2)
    tw = ts = cwacc
    if wrtw >= 2 and wrtw_tab is not None:
        wi = torch.clamp(cwid, max=WRTW_TAB_N - 1)
        tw, ts = wrtw_tab[0][wi], wrtw_tab[1][wi]
        tw = torch.where(tw != 0, tw, cwacc)
        ts = torch.where(ts != 0, ts, cwacc)
    return (cwacc, cwrem, cwid, torch.where(cw_done, tw, last_word),
            last_word2, torch.where(cw_done, ts, last_stem))


def update_ctx_state_batched(cs, b, wrtw=0, wrtw_tab=None):
    """Advance the context state by one byte per block; b int64 (B,).
    ``wrtw``: the WRTW gate value; ``wrtw_tab``: (word, stem) int64 u32
    tables of WRTW_TAB_N rows (WRTW >= 2; None keeps the byte hash)."""
    dev = b.device
    ohash = cs["ohash"]
    new_ohash = torch.cat(
        [torch.zeros_like(ohash[:, :1]), mix32(ohash[:, :-1], b[:, None])],
        dim=1)
    last8 = ((cs["last8"] << 8) & M32) | (cs["last4"] >> 24)
    last4 = ((cs["last4"] << 8) & M32) | b
    is_lt = b == 60
    is_gt = b == 62
    is_sp = b == 32
    is_slash = b == 47
    acc_w = cs["tagacc"]
    close_f = acc_w >> 31
    acc = acc_w & 0x7FFFFFFF
    armed = acc_w != 0
    lower = _lut("LOWER_MAP", dev)[b]
    is_letter = _lut("IS_LETTER", dev)[b]
    letter = is_letter == 1
    latch = armed & (is_gt | is_sp) & (acc > 1)
    tagacc = torch.where(
        is_lt, 1,
        torch.where(armed & is_slash & (acc == 1), acc_w | 0x80000000,
                    torch.where(armed & letter,
                                (close_f << 31)
                                | mix32(torch.clamp(acc, min=2), lower),
                                torch.where(armed & (is_gt | is_sp), 0,
                                            acc_w))))
    tag = torch.where(latch, acc, cs["tag"])
    tagdepth = torch.where(
        latch & (close_f == 1), torch.clamp(cs["tagdepth"], min=1) - 1,
        torch.where(latch & (close_f == 0),
                    torch.clamp(cs["tagdepth"] + 1, max=15), cs["tagdepth"]))
    word = torch.where(letter, mix32(cs["word"], lower), 0)
    ended = (~letter) & (cs["word"] != 0)
    wq1 = torch.where(letter, cs["word"], 0)
    wq2 = torch.where(letter, cs["wq1"], 0)
    wq3 = torch.where(letter, cs["wq2"], 0)
    wtail = torch.where(letter, ((cs["wtail"] << 8) & M32) | lower, 0)
    t1 = cs["wtail"] & 0xFF
    t2 = (cs["wtail"] >> 8) & 0xFF
    t3 = (cs["wtail"] >> 16) & 0xFF
    wl = cs["wordlen"]
    pair = (t2 << 8) | t1
    trip = (t3 << 16) | pair
    m3 = ((trip == _cc("i", "n", "g")) | (trip == _cc("i", "o", "n"))) \
        & (wl >= 5)
    m2 = ((pair == _cc("e", "d")) | (pair == _cc("e", "r"))
          | (pair == _cc("e", "s")) | (pair == _cc("l", "y"))
          | (pair == _cc("a", "l"))) & (wl >= 4)
    m1 = (t1 == _cc("s")) & (t2 != _cc("s")) & (wl >= 3)
    stem = torch.where(m3, cs["wq3"],
                       torch.where(m2, cs["wq2"],
                                   torch.where(m1, cs["wq1"], cs["word"])))
    last_stem = torch.where(ended, stem, cs["last_stem"])
    last_word = torch.where(ended, cs["word"], cs["last_word"])
    last_word2 = torch.where(ended, cs["last_word"], cs["last_word2"])
    if wrtw:
        cwacc, cwrem, cwid, last_word, last_word2, last_stem = _wrtw_step(
            cs, b, wrtw, wrtw_tab, last_word, last_word2, last_stem)
    else:
        cwacc, cwrem, cwid = cs["cwacc"], cs["cwrem"], cs["cwid"]
    wordlen = torch.where(letter, torch.clamp(cs["wordlen"] + 1, max=63), 0)
    word_pfx = torch.where(~letter, 0,
                           torch.where(cs["wordlen"] < 4,
                                       mix32(cs["word_pfx"], lower),
                                       cs["word_pfx"]))
    clsreg = ((cs["clsreg"] << 4) & M32) | _lut("BYTE_CLASS", dev)[b]
    cls2reg = ((cs["cls2reg"] << 2) & M32) | _lut("CLS2", dev)[b]
    sentpos = torch.where(_lut("IS_SENT_END", dev)[b] == 1, 0,
                          torch.clamp(cs["sentpos"] + 1, max=1023))
    linepos = torch.where(b == 10, 0, torch.clamp(cs["linepos"] + 1,
                                                  max=8191))
    stack, depth = _brk_step(cs["brk_stack"], cs["brk_depth"],
                             cs["bytecnt"], b)
    is_nl = b == 10
    lane = torch.arange(LINE_W, device=dev)
    wsel = (lane[None, :] == cs["linepos"][:, None]) & (~is_nl)[:, None]
    lbuf_w = torch.where(wsel, b[:, None], cs["lbuf"])
    plbuf = torch.where(is_nl[:, None], lbuf_w, cs["plbuf"])
    lbuf = torch.where(is_nl[:, None], 0xFFFF, lbuf_w)
    plen = torch.where(is_nl, cs["linepos"], cs["plen"])
    vexp, valive = line_expected(cs)
    lml = torch.where(is_nl, 0, torch.where(valive & (b == vexp),
                                            cs["lml"] + 1, cs["lml"]))
    is_sep = (b == 124) | (b == 9)
    cellidx = torch.where(
        is_nl, 0, torch.where(is_sep, torch.clamp(cs["cellidx"] + 1,
                                                  max=CELL_W - 1),
                              cs["cellidx"]))
    cellpos = torch.where(is_nl | is_sep, 0,
                          torch.clamp(cs["cellpos"] + 1, max=63))
    clane = torch.arange(CELL_W, device=dev)
    first_of_cell = (cs["cellpos"] == 0) & (~is_nl) & (~is_sep)
    cw = (clane[None, :] == cs["cellidx"][:, None]) & first_of_cell[:, None]
    cellbuf_w = torch.where(cw, b[:, None], cs["cellbuf"])
    pcellbuf = torch.where(is_nl[:, None], cellbuf_w, cs["pcellbuf"])
    cellbuf = torch.where(is_nl[:, None], 0xFFFF, cellbuf_w)
    is_listc = (b == 58) | (b == 42) | (b == 35) | (b == 59) | (b == 32)
    lsflag = torch.where(is_nl, 1, cs["lsflag"] & is_listc.long())
    grow = (cs["lsflag"] == 1) & is_listc & (~is_nl)
    listdepth = torch.where(
        is_nl, 0, torch.where(grow, torch.clamp(cs["listdepth"] + 1,
                                                max=15), cs["listdepth"]))
    listchar = torch.where(is_nl, 0, torch.where(grow, b, cs["listchar"]))
    return {"ohash": new_ohash, "last4": last4, "last8": last8,
            "tag": tag, "tagacc": tagacc, "tagdepth": tagdepth,
            "word": word, "last_word": last_word, "last_word2": last_word2,
            "word_pfx": word_pfx, "wordlen": wordlen,
            "wq1": wq1, "wq2": wq2, "wq3": wq3, "wtail": wtail,
            "last_stem": last_stem, "clsreg": clsreg, "cls2reg": cls2reg,
            "sentpos": sentpos, "linepos": linepos,
            "brk_stack": stack, "brk_depth": depth,
            "bytecnt": (cs["bytecnt"] + 1) & M32,
            "lbuf": lbuf, "plbuf": plbuf, "plen": plen, "lml": lml,
            "cwacc": cwacc, "cwrem": cwrem, "cwid": cwid,
            "cellidx": cellidx, "cellpos": cellpos, "cellbuf": cellbuf,
            "pcellbuf": pcellbuf, "listdepth": listdepth,
            "listchar": listchar, "lsflag": lsflag}

"""Content detection, the per-segment transforms and the segment table.

Copy of cmix_tpu/preprocess/wrt.py: the same chunk classifier and x86 score
(the JAX package's pure-Python rules, vectorized with numpy; its native
twin computes the same counts), the same segment types, the same merge of
adjacent detection chunks, and the transforms ``transform`` applies to
them: the WRT word dictionary on text where it shrinks the segment
(``Dictionary``, the JAX package's Python twin; its native library codes
the same bytes), the EXE E8/E9 absolutization (the Python twin
``_exe_py``, which is bit-identical to the JAX package's native library by
design), the 24-bit color decorrelation (``media.img24_encode``) and the
JPEG recoder (``jpeg.jpeg_recode``).  ``block_strides``,
``block_jpeg_coords`` and ``block_kinds`` derive the engine's per-block
fields from the segment table, so encode and decode agree.  Without a
dictionary text is recorded as a raw segment.  ``CMIX_JPEGC=0`` in the
environment turns JPEG recoding off, as in the JAX package: ``transform``
reads it on each call and then keeps every JPEG span as a pass-through
``SEG_JPEG`` entry.
"""

import os

import numpy as np

SEG_RAW, SEG_TEXT, SEG_EXE = 0, 1, 2
SEG_IMG24, SEG_IMG8, SEG_AUDIO = 3, 4, 5
# JPEG spans the recoder cannot invert exactly pass through as SEG_JPEG;
# recoded ones are SEG_JPEGC, whose table entry carries the plane geometry
SEG_JPEG, SEG_JPEGC = 6, 7
_MEDIA_SEGS = (SEG_IMG24, SEG_IMG8, SEG_AUDIO)
# segments whose meta entry carries a 4th field (record stride hint)
_STRIDE_SEGS = _MEDIA_SEGS + (SEG_JPEGC,)
_DETECT_CHUNK = 1 << 16

# WRT codewords: ESC escapes a literal byte >= 0x80 (and the three marks
# themselves), CAP/UPR mark a capitalized/upper-case word; ids < N1 take
# one byte (0x80+id), the next N2 two (lead 0xC0-0xEF), the rest three
ESC, CAP, UPR = 0x04, 0x05, 0x06
N1, N2 = 64, 48 * 256


class Dictionary:
    """Word dictionary for the WRT transform: a frequency-ordered word
    list, one word per line (the reference's english.dic asset); a word's
    id is its first line, its codeword is ``_emit_code``'s."""

    def __init__(self, path):
        self.path = path
        self.words = []
        self.ids = {}
        with open(path, "rb") as f:
            for line in f:
                w = line.strip().decode("latin-1")
                if w and w not in self.ids:
                    self.ids[w] = len(self.words)
                    self.words.append(w)

    def _emit_code(self, o, i):
        if i < N1:
            o.append(0x80 + i)
        elif i < N1 + N2:
            v = i - N1
            o += bytes([0xC0 + (v >> 8), v & 0xFF])
        else:
            v = i - N1 - N2
            o += bytes([0xF0 + (v >> 16), (v >> 8) & 0xFF, v & 0xFF])

    def encode(self, data: bytes) -> bytes:
        """Each maximal run of ASCII letters that is a dictionary word in
        lower case, capitalized (CAP) or upper case of two or more letters
        (UPR) becomes its codeword; bytes >= 0x80 and the marks are
        escaped; everything else passes."""
        o = bytearray()
        i, n = 0, len(data)
        while i < n:
            c = data[i]
            if (65 <= c <= 90) or (97 <= c <= 122):
                j = i
                while j < n and (65 <= data[j] <= 90 or 97 <= data[j] <= 122):
                    j += 1
                w = data[i:j].decode("latin-1")
                lw = w.lower()
                wid = self.ids.get(lw)
                is_lower = w == lw
                is_cap = w[0].isupper() and w[1:] == lw[1:]
                is_upper = w.isupper() and len(w) > 1
                if wid is not None and (is_lower or is_cap or is_upper):
                    if is_upper:
                        o.append(UPR)
                    elif is_cap:
                        o.append(CAP)
                    self._emit_code(o, wid)
                else:
                    o += data[i:j]
                i = j
            elif c >= 0x80 or c in (ESC, CAP, UPR):
                o += bytes([ESC, c])
                i += 1
            else:
                o.append(c)
                i += 1
        return bytes(o)

    def decode(self, data: bytes) -> bytes:
        """The inverse of ``encode`` (a truncated codeword passes as its
        lead byte, an id past the list decodes to nothing)."""
        o = bytearray()
        i, n = 0, len(data)
        capmode = 0
        while i < n:
            c = data[i]
            if c == ESC and i + 1 < n:
                o.append(data[i + 1])
                i += 2
                capmode = 0
                continue
            if c == CAP:
                capmode = 1
                i += 1
                continue
            if c == UPR:
                capmode = 2
                i += 1
                continue
            if c < 0x80:
                o.append(c)
                i += 1
                capmode = 0
                continue
            if c < 0xC0:
                wid = c - 0x80
                i += 1
            elif c < 0xF0:
                if i + 1 >= n:
                    o.append(c)
                    i += 1
                    continue
                wid = N1 + ((c - 0xC0) << 8 | data[i + 1])
                i += 2
            else:
                if i + 2 >= n:
                    o.append(c)
                    i += 1
                    continue
                wid = N1 + N2 + ((c - 0xF0) << 16
                                 | data[i + 1] << 8 | data[i + 2])
                i += 3
            if 0 <= wid < len(self.words):
                w = self.words[wid]
                if capmode == 1:
                    w = w[0].upper() + w[1:]
                elif capmode == 2:
                    w = w.upper()
                o += w.encode("latin-1")
            capmode = 0
        return bytes(o)


def detect_text_chunks(data: bytes, chunk: int = 4096):
    """Per-chunk text/binary classification (1 = text): at least 90% of
    the chunk's bytes are TAB, LF, CR or printable ASCII."""
    arr = np.frombuffer(data, dtype=np.uint8)
    nc = max(1, -(-len(data) // chunk))
    types = np.zeros(nc, dtype=np.uint8)
    ok = (arr == 9) | (arr == 10) | (arr == 13) | ((arr >= 32) & (arr < 127))
    for c in range(nc):
        seg = ok[c * chunk:(c + 1) * chunk]
        types[c] = 1 if int(seg.sum()) * 100 >= len(seg) * 90 else 0
    return types


def exe_score(data: bytes) -> int:
    """Count of E8/E9 opcodes whose little-endian rel32 operand lies in
    (-2^22, 2^22) -- the x86 call/jmp signature."""
    arr = np.frombuffer(data, dtype=np.uint8)
    n = len(arr) - 4
    if n <= 0:
        return 0
    op = (arr[:n] == 0xE8) | (arr[:n] == 0xE9)
    y = (arr[1:n + 1].astype(np.int64) | (arr[2:n + 2].astype(np.int64) << 8)
         | (arr[3:n + 3].astype(np.int64) << 16)
         | (arr[4:n + 4].astype(np.int64) << 24))
    y = np.where(y >= 1 << 31, y - (1 << 32), y)
    return int((op & (y > -(1 << 22)) & (y < (1 << 22))).sum())


def segments(data: bytes):
    """Detected content segments [(type, lo, hi, stride)] in stream order:
    media spans first (find_media_spans), then 64 KiB detection chunks of
    the gaps classified text / EXE / raw and merged when adjacent chunks
    agree (cmix_tpu/preprocess/wrt.py transform)."""
    from portbench.reference.preprocess.media import find_media_spans
    n = len(data)
    segs = []

    def _detect_region(lo_r, hi_r):
        offs = list(range(lo_r, hi_r, _DETECT_CHUNK))
        types = []
        for lo in offs:
            chunk = data[lo:min(lo + _DETECT_CHUNK, hi_r)]
            tt = detect_text_chunks(chunk, chunk=len(chunk) or 1)
            if tt.mean() >= 0.9:
                types.append(SEG_TEXT)
            elif exe_score(chunk) * 400 >= len(chunk):
                types.append(SEG_EXE)
            else:
                types.append(SEG_RAW)
        start = 0
        for i in range(1, len(types) + 1):
            if i == len(types) or types[i] != types[start]:
                segs.append((types[start], offs[start],
                             min(offs[start] + (i - start) * _DETECT_CHUNK,
                                 hi_r), 0))
                start = i

    pos = 0
    for sp in find_media_spans(data):
        if sp.data_off > pos:
            _detect_region(pos, sp.data_off)
        kind = {"img24": SEG_IMG24, "img8": SEG_IMG8,
                "audio": SEG_AUDIO, "jpeg": SEG_JPEG}[sp.kind]
        segs.append((kind, sp.data_off, sp.data_off + sp.data_len,
                     sp.stride))
        pos = sp.data_off + sp.data_len
    if pos < n:
        _detect_region(pos, n)
    return segs


# ------------------------------------------------------- EXE x86 transform


def _sext25(v):
    v &= 0x1FFFFFF
    return v - 0x2000000 if v & 0x1000000 else v


def _exe_cond(out, j, n):
    if j + 4 >= n or out[j + 4] not in (0x00, 0xFF):
        return False
    return (out[j] in (0xE8, 0xE9)
            or (j >= 1 and out[j - 1] == 0x0F and out[j] & 0xF0 == 0x80))


def _exe_py(data: bytes, enc: bool) -> bytes:
    """E8/E9 (and 0F 8x) rel32 <-> absolute, mod 2^25 sign-extended.  The
    condition -- top operand byte in {0x00, 0xFF} -- is invariant under the
    transform, so encode and decode agree on which operands were
    transformed; backward encode + forward decode invert overlapping
    matches LIFO."""
    out = bytearray(data)
    n = len(data)
    rng = range(n - 5, -1, -1) if enc else range(0, max(n - 4, 0))
    for j in rng:
        if not _exe_cond(out, j, n):
            continue
        if enc:
            rel = (out[j + 1] | out[j + 2] << 8 | out[j + 3] << 16
                   | out[j + 4] << 24)
            a = _sext25(rel + j + 5)
            out[j + 1] = (a & 0xFF) ^ 0xB0
            out[j + 2] = ((a >> 8) & 0xFF) ^ 0xB0
            out[j + 3] = ((a >> 16) & 0xFF) ^ 0xB0
            out[j + 4] = (a >> 24) & 0xFF
        else:
            a = ((out[j + 1] ^ 0xB0) | (out[j + 2] ^ 0xB0) << 8
                 | (out[j + 3] ^ 0xB0) << 16 | out[j + 4] << 24)
            rel = _sext25(a - j - 5)
            out[j + 1] = rel & 0xFF
            out[j + 2] = (rel >> 8) & 0xFF
            out[j + 3] = (rel >> 16) & 0xFF
            out[j + 4] = (rel >> 24) & 0xFF
    return bytes(out)


def exe_encode(data: bytes) -> bytes:
    """E8/E9 rel32 -> absolute transform (inverse: ``exe_decode``)."""
    return _exe_py(data, True)


def exe_decode(data: bytes) -> bytes:
    return _exe_py(data, False)


# ------------------------------------------------- segmented preprocessing


def transform(data: bytes, dictionary=None):
    """Detect content types and apply per-segment transforms ->
    (payload, meta): text is WRT-coded where ``dictionary`` (a
    ``Dictionary``) shrinks it; meta entries are (type, enc_len, raw_len),
    media entries add the record stride, recoded-JPEG entries also the body
    offset and the per-component plane lengths.  JPEG spans are recoded
    unless ``CMIX_JPEGC`` is "0" in the environment."""
    if not data:
        return data, [(SEG_RAW, 0, 0)]
    from portbench.reference.preprocess.jpeg import (
        jpeg_recode, jpeg_stride, recoded_geometry)
    from portbench.reference.preprocess.media import img24_encode
    payload = bytearray()
    meta = []
    for typ, lo, hi, stride in segments(data):
        raw = data[lo:hi]
        enc = (dictionary.encode(raw)
               if typ == SEG_TEXT and dictionary is not None else raw)
        if len(enc) < len(raw):
            payload += enc
            meta.append((SEG_TEXT, len(enc), len(raw)))
        elif typ == SEG_EXE:
            enc = exe_encode(raw)
            payload += enc
            meta.append((SEG_EXE, len(enc), len(raw)))
        elif typ == SEG_IMG24:
            payload += img24_encode(raw, stride)
            meta.append((SEG_IMG24, len(raw), len(raw), stride))
        elif typ in (SEG_IMG8, SEG_AUDIO):   # pass-through + stride hint
            payload += raw
            meta.append((typ, len(raw), len(raw), stride))
        elif typ == SEG_JPEG:
            enc = (jpeg_recode(raw)          # None unless exact inverse
                   if os.environ.get("CMIX_JPEGC", "1") != "0" else None)
            if enc is None:
                payload += raw
                meta.append((SEG_JPEG, len(raw), len(raw)))
            else:
                body_off, clens = recoded_geometry(enc) or (0, [])
                payload += enc
                meta.append((SEG_JPEGC, len(enc), len(raw),
                             jpeg_stride(raw), body_off, tuple(clens[:4])))
        else:                                # raw, or text WRT cannot shrink
            payload += raw
            meta.append((SEG_RAW, len(raw), len(raw)))
    return bytes(payload), meta


def untransform(payload: bytes, meta, dictionary=None) -> bytes:
    """The inverse of ``transform``; a WRT text segment needs the
    dictionary that coded it (FormatError without one)."""
    from portbench.reference.engine import FormatError
    from portbench.reference.preprocess.jpeg import jpeg_unrecode
    from portbench.reference.preprocess.media import img24_decode
    out = bytearray()
    off = 0
    for entry in meta:
        typ, enc_len = entry[0], entry[1]
        seg = payload[off:off + enc_len]
        off += enc_len
        if typ == SEG_TEXT:
            if dictionary is None:
                raise FormatError("a WRT text segment needs the dictionary "
                                  "it was coded with")
            out += dictionary.decode(seg)
        elif typ == SEG_EXE:
            out += exe_decode(seg)
        elif typ == SEG_IMG24:
            out += img24_decode(seg, entry[3])
        elif typ == SEG_JPEGC:
            out += jpeg_unrecode(seg)
        else:
            out += seg
    return bytes(out)


def _covered(meta, n_blocks, block_size):
    """(entry, block, bytes of the block the entry covers), in table
    order, for every entry with a nonzero length."""
    off = 0
    for entry in meta:
        enc_len = entry[1]
        if enc_len:
            b0 = off // block_size
            b1 = min((off + enc_len - 1) // block_size, n_blocks - 1)
            for b in range(b0, b1 + 1):
                lo = max(off, b * block_size)
                hi = min(off + enc_len, (b + 1) * block_size)
                yield entry, off, b, hi - lo
        off += enc_len


def block_strides(meta, n_blocks, block_size):
    """Per-block forced record length from the media segments' strides:
    a stride engages for a block where its segment covers more of the
    block than any other strided segment and at least a quarter of it."""
    cover = np.zeros(n_blocks, dtype=np.int64)
    forced = np.zeros(n_blocks, dtype=np.int32)
    for entry, _, b, c in _covered(meta, n_blocks, block_size):
        if (entry[0] in _STRIDE_SEGS and len(entry) > 3
                and 2 <= entry[3] < 4096 and c > cover[b]
                and c * 4 >= block_size):
            cover[b] = c
            forced[b] = entry[3]
    return forced


def block_jpeg_coords(meta, n_blocks, block_size):
    """Per-block JPEGX addressing: (rel0 (nb,) int32, clen (nb, 4) int32).
    For a block whose dominant coverage is a recoded-JPEG segment, rel0 + t
    is the byte's offset into that segment's coefficient planes (negative
    while still in the verbatim header) and clen holds the per-component
    plane lengths; rel0 = INT32_MIN marks blocks with no JPEG coverage."""
    rel0 = np.full(n_blocks, np.iinfo(np.int32).min, dtype=np.int32)
    clen = np.zeros((n_blocks, 4), dtype=np.int32)
    cover = np.zeros(n_blocks, dtype=np.int64)
    for entry, off, b, c in _covered(meta, n_blocks, block_size):
        if (entry[0] == SEG_JPEGC and len(entry) > 5 and entry[5]
                and c > cover[b] and c * 4 >= block_size):
            cover[b] = c
            rel0[b] = b * block_size - off - entry[4]
            clen[b] = 0
            for i, cl in enumerate(entry[5][:4]):
                clen[b, i] = cl
    return rel0, clen


def block_kinds(meta, n_blocks, block_size):
    """Per-block dominant content kind (the SEG_* id with the most
    coverage; ties go to the lower id)."""
    cover = np.zeros((n_blocks, 8), dtype=np.int64)
    for entry, _, b, c in _covered(meta, n_blocks, block_size):
        if 0 <= entry[0] < 8:
            cover[b, entry[0]] += c
    return np.argmax(cover, axis=1).astype(np.int32)

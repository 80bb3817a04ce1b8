"""Reversible JPEG scan recoding: Huffman bits -> coefficient stream.

Copy of cmix_tpu/preprocess/jpeg.py (pure Python plus ``struct``), kept
in the port so that it imports nothing of the JAX package;
tests/test_torch_transform.py holds the two equal.  The original's
notes follow.

The reference models JPEG by decoding the entropy-coded scan in lockstep
with prediction (paq8's jpegModel, src/models/paq8.cpp:5386-5804 class of
capability).  That design is inherently bit-serial; the TPU-native
equivalent moves the Huffman decode to the HOST as a reversible
preprocessing transform (the packJPG/lepton recipe): the scan becomes a
structured DCT-coefficient byte stream that the shared context-mixing
engine models far better than opaque Huffman bits, with MIX_KIND routing
the mixer by segment type.

Scope: baseline sequential DCT (SOF0), one scan, standard Huffman,
optional restart intervals -- the overwhelmingly common case.  Anything
else (progressive, arithmetic, 12-bit) returns None and the span passes
through unchanged.  ``jpeg_recode`` self-checks by re-encoding and
comparing bytes, so a non-canonical encoder (odd padding bits, trailing
ZRL before EOB) can never corrupt an archive: it just falls back.

Serialized format (all little-endian) -- FIXED-WIDTH PLANES: the
coefficients are grouped by (component, zigzag position) into planes of
exactly one byte per block (lepton's organizing idea, shaped so the
geometry is STATIC):
  u32 header_len | header bytes (SOI..end of SOS header, verbatim)
  then for each scan component c, for each zigzag position k = 0..63:
    one byte per block of c in decode order: value+128 for values in
    [-127, 126] (k = 0 is the stored DC DIFF); 0xFF escapes to the side
    stream.  Then a trailing side stream of zigzag-LEB128 varints, one
    per escape, in plane order.
Fixed width means (a) every plane is block-count bytes, so each zigzag
position's distribution is a contiguous stationary region, and (b) the
segment's record stride can be set to the image's blocks-per-row,
engaging the engine's record-grid W/N/NW contexts as 2D neighbor-block
contexts within each plane (the im*bitModel idea applied to DCT space).
Counts per component derive from the SOF dims, so the streams are
self-delimiting.  Re-encode with the file's own Huffman tables
reproduces the scan bit-for-bit (canonical run/EOB coding assumed; the
self-check falls back on any non-canonical encoder).
"""

import struct

ZIGZAG = [
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]


def _build_huff(bits, vals):
    """Canonical Huffman: (code, length) per symbol + a decode dict."""
    code = 0
    dec = {}
    enc = {}
    k = 0
    for ln in range(1, 17):
        for _ in range(bits[ln - 1]):
            dec[(ln, code)] = vals[k]
            enc[vals[k]] = (code, ln)
            code += 1
            k += 1
        code <<= 1
    return enc, dec


class _BitReader:
    """MSB-first scan bit reader with FF00 unstuffing; stops at markers."""

    def __init__(self, data, pos):
        self.d = data
        self.p = pos
        self.acc = 0
        self.n = 0

    def read(self, nbits):
        while self.n < nbits:
            if self.p >= len(self.d):
                raise ValueError("scan overrun")
            b = self.d[self.p]
            if b == 0xFF:
                nxt = self.d[self.p + 1] if self.p + 1 < len(self.d) else 0
                if nxt != 0x00:
                    raise ValueError("marker inside scan read")
                self.p += 2
            else:
                self.p += 1
            self.acc = (self.acc << 8) | b
            self.n += 8
        self.n -= nbits
        v = (self.acc >> self.n) & ((1 << nbits) - 1)
        self.acc &= (1 << self.n) - 1
        return v

    def align_restart(self, expect_n):
        """Byte-align (pad bits must be 1s) and consume RSTn."""
        if self.n:
            pad = self.acc & ((1 << self.n) - 1)
            if pad != (1 << self.n) - 1:
                raise ValueError("non-1 padding at restart")
            self.acc = 0
            self.n = 0
        if self.p + 2 > len(self.d) or self.d[self.p] != 0xFF or \
                self.d[self.p + 1] != 0xD0 + expect_n:
            raise ValueError("missing restart marker")
        self.p += 2

    def finish(self):
        """Byte-align at scan end (1-padding) -> final position."""
        if self.n:
            pad = self.acc & ((1 << self.n) - 1)
            if pad != (1 << self.n) - 1:
                raise ValueError("non-1 padding at scan end")
        return self.p


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def write(self, val, nbits):
        self.acc = (self.acc << nbits) | (val & ((1 << nbits) - 1))
        self.n += nbits
        while self.n >= 8:
            self.n -= 8
            b = (self.acc >> self.n) & 0xFF
            self.out.append(b)
            if b == 0xFF:
                self.out.append(0x00)
            self.acc &= (1 << self.n) - 1

    def pad_align(self):
        if self.n:
            self.write((1 << (8 - self.n)) - 1, 8 - self.n)


def _zz(v):
    return (v << 1) ^ (v >> 31) if v >= 0 else ((-v) << 1) - 1


def _varint(out, v):
    u = (v << 1) if v >= 0 else (((-v) << 1) - 1)
    while u >= 0x80:
        out.append(0x80 | (u & 0x7F))
        u >>= 7
    out.append(u)


def _unvarint(buf, p):
    u = 0
    sh = 0
    while True:
        b = buf[p]
        p += 1
        u |= (b & 0x7F) << sh
        if b < 0x80:
            break
        sh += 7
    return (u >> 1) if (u & 1) == 0 else -((u + 1) >> 1), p


def _mag_cat(v):
    """JPEG magnitude category + extra bits for a nonzero value."""
    a = v if v >= 0 else -v
    s = a.bit_length()
    extra = v if v >= 0 else v + (1 << s) - 1
    return s, extra


def _parse_tables(data):
    """Walk markers up to and including SOS; return parse dict or None."""
    n = len(data)
    if data[:2] != b"\xFF\xD8":
        return None
    j = 2
    huff = {}                      # (class, id) -> (enc, dec)
    frame = None
    dri = 0
    while j + 4 <= n:
        if data[j] != 0xFF:
            return None
        m = data[j + 1]
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            j += 2
            continue
        (seglen,) = struct.unpack_from(">H", data, j + 2)
        body = data[j + 4:j + 2 + seglen]
        if m == 0xC4:                                        # DHT
            p = 0
            while p + 17 <= len(body):
                tc, th = body[p] >> 4, body[p] & 15
                bits = list(body[p + 1:p + 17])
                cnt = sum(bits)
                vals = list(body[p + 17:p + 17 + cnt])
                if len(vals) < cnt:
                    return None
                huff[(tc, th)] = _build_huff(bits, vals)
                p += 17 + cnt
        elif m == 0xC0:                                      # SOF0 baseline
            prec, h, w, nc = body[0], struct.unpack_from(">H", body, 1)[0], \
                struct.unpack_from(">H", body, 3)[0], body[5]
            if prec != 8 or nc not in (1, 3, 4):
                return None
            comps = []
            for c in range(nc):
                cid, hv, tq = body[6 + 3 * c], body[7 + 3 * c], \
                    body[8 + 3 * c]
                comps.append((cid, hv >> 4, hv & 15, tq))
            frame = (w, h, comps)
        elif 0xC1 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            return None                                      # not baseline
        elif m == 0xDD:                                      # DRI
            dri = struct.unpack_from(">H", body, 0)[0]
        elif m == 0xDA:                                      # SOS
            if frame is None or not huff:
                return None
            ns = body[0]
            smap = []
            for c in range(ns):
                cs, td_ta = body[1 + 2 * c], body[2 + 2 * c]
                smap.append((cs, td_ta >> 4, td_ta & 15))
            if len(smap) != len(frame[2]):
                return None                                  # partial scan
            return dict(huff=huff, frame=frame, dri=dri, smap=smap,
                        scan_start=j + 2 + seglen, hdr_end=j + 2 + seglen)
        j += 2 + seglen
    return None


def _mcu_layout(frame):
    w, h, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcux = (w + 8 * hmax - 1) // (8 * hmax)
    mcuy = (h + 8 * vmax - 1) // (8 * vmax)
    return mcux * mcuy, [(ci, c[1] * c[2]) for ci, c in enumerate(comps)]


def _rowmajor_order(frame):
    """Per component: (bw, bh, perm) where perm[row_major_i] = the
    decode-order block index.  Planes are serialized row-major so a
    fixed per-plane stride (bw) makes the byte directly above the
    vertical neighbor block."""
    w, h, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    mcux = (w + 8 * hmax - 1) // (8 * hmax)
    out = []
    for cid, ch, cv, tq in comps:
        bw, bh = mcux * ch, \
            ((h + 8 * vmax - 1) // (8 * vmax)) * cv
        perm = []
        for r in range(bh):
            for c in range(bw):
                mcu = (r // cv) * mcux + (c // ch)
                within = (r % cv) * ch + (c % ch)
                perm.append(mcu * ch * cv + within)
        out.append((bw, bh, perm))
    return out


def jpeg_recode(data: bytes):
    """bytes of one SOI..EOI JPEG -> coefficient payload, or None.

    Self-checks: returns None unless jpeg_unrecode(payload) == data.
    """
    try:
        payload = _recode_inner(data)
        if payload is None:
            return None
        if jpeg_unrecode(payload) != data:
            return None
        return payload
    except Exception:
        return None


def _recode_inner(data):
    tb = _parse_tables(data)
    if tb is None:
        return None
    frame = tb["frame"]
    comps = frame[2]
    n_mcu, blocks_per = _mcu_layout(frame)
    dec_tabs = []
    for cs, td, ta in tb["smap"]:
        if (0, td) not in tb["huff"] or (1, ta) not in tb["huff"]:
            return None
        dec_tabs.append((tb["huff"][(0, td)][1], tb["huff"][(1, ta)][1]))

    br = _BitReader(data, tb["scan_start"])
    dri = tb["dri"]

    def huff_dec(dec):
        code = 0
        for ln in range(1, 17):
            code = (code << 1) | br.read(1)
            if (ln, code) in dec:
                return dec[(ln, code)]
        raise ValueError("bad huffman code")

    def recv_extend(s):
        if s == 0:
            return 0
        v = br.read(s)
        return v if v >= (1 << (s - 1)) else v - (1 << s) + 1

    coefs = [[] for _ in blocks_per]        # per component: list of (64,)
    rst_n = 0
    for mcu in range(n_mcu):
        if dri and mcu and mcu % dri == 0:
            br.align_restart(rst_n)
            rst_n = (rst_n + 1) & 7
        for ci, nblk in blocks_per:
            dc_dec, ac_dec = dec_tabs[ci]
            for _ in range(nblk):
                co = [0] * 64
                s = huff_dec(dc_dec)
                if s > 11:
                    raise ValueError("bad DC size")
                co[0] = recv_extend(s)                       # stored diff
                k = 1
                while k < 64:
                    rs = huff_dec(ac_dec)
                    r, s = rs >> 4, rs & 15
                    if s == 0:
                        if r == 15:                          # ZRL
                            k += 16
                            continue
                        break                                # EOB
                    k += r
                    if k > 63:
                        raise ValueError("AC overrun")
                    co[k] = recv_extend(s)
                    k += 1
                coefs[ci].append(co)
    end = br.finish()
    if data[end:end + 2] != b"\xFF\xD9" or end + 2 != len(data):
        return None                 # trailing garbage: keep pass-through
    hdr = data[:tb["hdr_end"]]
    out = bytearray(struct.pack("<I", len(hdr)) + hdr)
    esc = bytearray()
    for ci, (bw, bh, perm) in enumerate(_rowmajor_order(frame)):
        blks = coefs[ci]
        if len(blks) != len(perm):
            return None
        for k in range(64):
            for idx in perm:
                v = blks[idx][k]
                if -127 <= v <= 126:
                    out.append(v + 128)
                else:
                    out.append(0xFF)
                    _varint(esc, v)
    return bytes(out) + bytes(esc)


def jpeg_stride(data: bytes):
    """Block-row width of the scan's first (dominant) component -- the
    record stride that makes each plane byte vertically adjacent to the
    block directly above in the image.  0 if unparsable."""
    tb = _parse_tables(data)
    if tb is None:
        return 0
    return _rowmajor_order(tb["frame"])[0][0]


def recoded_geometry(payload: bytes):
    """(body_off, [plane_len per component]) of a recoded payload.

    body_off is where the fixed-width planes start; component ci's
    planes occupy [coff_ci, coff_ci + 64*plane_len_ci) with
    coff = body_off + cumulative.  This is the addressing the engine's
    JPEGX contexts use to recover (component, zigzag index) per byte --
    the coordinate system of the reference jpegModel's coefficient
    contexts (src/models/paq8.cpp:5871-6589).  Returns None if the
    payload header does not parse."""
    try:
        (hlen,) = struct.unpack_from("<I", payload, 0)
        hdr = payload[4:4 + hlen]
        tb = _parse_tables(hdr + b"\xFF\xD9")
        if tb is None:
            return None
        n_mcu, blocks_per = _mcu_layout(tb["frame"])
        return 4 + hlen, [n_mcu * nblk for _, nblk in blocks_per]
    except (struct.error, Exception):
        return None


def jpeg_unrecode(payload: bytes) -> bytes:
    """Exact inverse of _recode_inner: planar payload -> JPEG."""
    (hlen,) = struct.unpack_from("<I", payload, 0)
    hdr = payload[4:4 + hlen]
    tb = _parse_tables(hdr + b"\xFF\xD9")     # header parses standalone
    if tb is None:
        raise ValueError("bad recoded header")
    frame = tb["frame"]
    n_mcu, blocks_per = _mcu_layout(frame)
    enc_tabs = []
    for cs, td, ta in tb["smap"]:
        enc_tabs.append((tb["huff"][(0, td)][0], tb["huff"][(1, ta)][0]))

    # parse the fixed-width planes back into per-component coefficient
    # lists (decode order); escapes resolve from the trailing stream
    p = 4 + hlen
    orders = _rowmajor_order(frame)
    esc_at = []                               # (ci, decode_idx, k) queue
    coefs = []
    for ci, nblk in blocks_per:
        nb = n_mcu * nblk
        bw, bh, perm = orders[ci]
        if len(perm) != nb:
            raise ValueError("geometry mismatch")
        arr = [[0] * 64 for _ in range(nb)]
        for k in range(64):
            for idx in perm:
                b = payload[p]
                p += 1
                if b == 0xFF:
                    esc_at.append((arr, idx, k))
                else:
                    arr[idx][k] = b - 128
        coefs.append(arr)
    for arr, idx, k in esc_at:
        arr[idx][k], p = _unvarint(payload, p)

    bw = _BitWriter()
    dri = tb["dri"]
    rst_n = 0
    cur = [0] * len(blocks_per)               # next block index per comp
    for mcu in range(n_mcu):
        if dri and mcu and mcu % dri == 0:
            bw.pad_align()
            bw.out += bytes((0xFF, 0xD0 + rst_n))
            rst_n = (rst_n + 1) & 7
        for ci, nblk in blocks_per:
            dc_enc, ac_enc = enc_tabs[ci]
            for _ in range(nblk):
                co = coefs[ci][cur[ci]]
                cur[ci] += 1
                diff = co[0]
                s, extra = (0, 0) if diff == 0 else _mag_cat(diff)
                code, ln = dc_enc[s]
                bw.write(code, ln)
                if s:
                    bw.write(extra, s)
                # canonical run/EOB coding of the 63 AC coefficients
                last_nz = 0
                for k in range(63, 0, -1):
                    if co[k]:
                        last_nz = k
                        break
                k = 1
                run = 0
                while k <= last_nz:
                    v = co[k]
                    if v == 0:
                        run += 1
                    else:
                        while run > 15:
                            code, ln = ac_enc[0xF0]          # ZRL
                            bw.write(code, ln)
                            run -= 16
                        s, extra = _mag_cat(v)
                        code, ln = ac_enc[(run << 4) | s]
                        bw.write(code, ln)
                        bw.write(extra, s)
                        run = 0
                    k += 1
                if last_nz < 63:
                    code, ln = ac_enc[0x00]                  # EOB
                    bw.write(code, ln)
    bw.pad_align()
    return bytes(hdr) + bytes(bw.out) + b"\xFF\xD9"

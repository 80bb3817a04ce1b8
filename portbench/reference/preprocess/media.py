"""Image/audio container detection + reversible pixel transforms.

(Copy of cmix_tpu/preprocess/media.py, kept in the port so that it imports
nothing of the JAX package; tests/test_torch_preprocess.py and
tests/test_torch_transform.py hold the two equal.)

Capability parity with the reference's media handling:

* filetype detection from headers -- BMP / PGM / PPM / WAV, the
  header-parsing side of paq8's imgModel/audioModel routing
  (src/models/paq8.cpp:5386-5804, :5806-5869) and the preprocessor's
  BMP/PBM-PGM-PPM detectors (src/preprocess/preprocessor.cpp:177-289).
* a reversible 24-bit color decorrelation (G, B-G, R-G) -- the
  capability class of encode_bmp's G, G-R, G-B planar delta
  (src/preprocess/preprocessor.cpp:302-375), kept interleaved here so
  the block-parallel engine sees a spatially local stream.

Detected spans carry (stride, cell): row length in bytes and bytes per
pixel/sample-frame.  The runner threads these into per-block state so the
engine's grid contexts (engine._grid_ctx_vals) can address the W/N/NW/NE
pixel neighborhood -- the TPU-native form of paq8's im8/im24 models
(src/models/paq8.cpp:4743-5385).
"""

import struct


class MediaSpan:
    """A detected media region: data_off/data_len address the PIXEL DATA
    (headers stay raw), kind in {'img8','img24','audio'}."""

    __slots__ = ("kind", "data_off", "data_len", "stride", "cell")

    def __init__(self, kind, data_off, data_len, stride, cell):
        self.kind = kind
        self.data_off = data_off
        self.data_len = data_len
        self.stride = stride
        self.cell = cell

    def __repr__(self):
        return (f"MediaSpan({self.kind}, off={self.data_off}, "
                f"len={self.data_len}, stride={self.stride}, "
                f"cell={self.cell})")


def _parse_bmp(data, i):
    """BMP at offset i -> MediaSpan or None (cf. detect() BMP branch,
    src/preprocess/preprocessor.cpp:177-220)."""
    if i + 54 > len(data) or data[i:i + 2] != b"BM":
        return None
    try:
        data_off, hdr_size = struct.unpack_from("<II", data, i + 10)
        if hdr_size < 40:
            return None
        w, h = struct.unpack_from("<ii", data, i + 18)
        planes, bpp = struct.unpack_from("<HH", data, i + 26)
        (comp,) = struct.unpack_from("<I", data, i + 30)
    except struct.error:
        return None
    if planes != 1 or comp != 0 or bpp not in (8, 24, 32):
        return None
    if not (0 < w < 0x40000 and 0 < abs(h) < 0x40000):
        return None
    rowbytes = ((w * bpp // 8) + 3) & ~3
    n = rowbytes * abs(h)
    if data_off < 26 or i + data_off + n > len(data) or n < 256:
        return None
    kind = "img8" if bpp == 8 else "img24"
    cell = bpp // 8
    return MediaSpan(kind, i + data_off, n, rowbytes, cell)


def _parse_pnm(data, i):
    """Binary PGM (P5) / PPM (P6) at offset i."""
    if i + 2 > len(data) or data[i] != 0x50 or data[i + 1] not in (0x35,
                                                                   0x36):
        return None
    is_ppm = data[i + 1] == 0x36
    j = i + 2
    fields = []
    while len(fields) < 3 and j < min(len(data), i + 256):
        c = data[j]
        if c in b" \t\r\n":
            j += 1
        elif c == 0x23:                       # '#' comment to EOL
            while j < len(data) and data[j] != 0x0A:
                j += 1
        elif 0x30 <= c <= 0x39:
            v = 0
            while j < len(data) and 0x30 <= data[j] <= 0x39:
                v = v * 10 + data[j] - 0x30
                j += 1
            fields.append(v)
        else:
            return None
    if len(fields) < 3 or j >= len(data) or data[j] not in b" \t\r\n":
        return None
    j += 1                                    # single whitespace after maxval
    w, h, maxval = fields
    if not (0 < w < 0x40000 and 0 < h < 0x40000 and 0 < maxval < 256):
        return None
    cell = 3 if is_ppm else 1
    n = w * h * cell
    if j + n > len(data) or n < 256:
        return None
    return MediaSpan("img24" if is_ppm else "img8", j, n, w * cell, cell)


def _parse_pbm(data, i):
    """Binary PBM (P4) at offset i: 1-bit packed bitmap.  The engine has
    no dedicated 1-bit model (reference: im1bitModel, paq8.cpp:4634);
    the span routes the packed rows to the stride-addressed grid
    contexts as an 8bpp-class region (row stride = ceil(w/8))."""
    if i + 2 > len(data) or data[i] != 0x50 or data[i + 1] != 0x34:
        return None
    j = i + 2
    fields = []
    while len(fields) < 2 and j < min(len(data), i + 256):
        c = data[j]
        if c in b" \t\r\n":
            j += 1
        elif c == 0x23:                       # '#' comment to EOL
            while j < len(data) and data[j] != 0x0A:
                j += 1
        elif 0x30 <= c <= 0x39:
            v = 0
            while j < len(data) and 0x30 <= data[j] <= 0x39:
                v = v * 10 + data[j] - 0x30
                j += 1
            fields.append(v)
        else:
            return None
    if len(fields) < 2 or j >= len(data) or data[j] not in b" \t\r\n":
        return None
    j += 1
    w, h = fields
    if not (0 < w < 0x40000 and 0 < h < 0x40000):
        return None
    rowbytes = (w + 7) // 8
    n = rowbytes * h
    if j + n > len(data) or n < 256:
        return None
    return MediaSpan("img8", j, n, rowbytes, 1)


def _parse_pam(data, i):
    """PAM (P7) at offset i (cf. the reference's PAM branch of detect(),
    src/preprocess/preprocessor.cpp:221-289): token header up to ENDHDR,
    then raw samples."""
    if data[i:i + 3] != b"P7\n":
        return None
    end = data.find(b"ENDHDR\n", i, i + 512)
    if end == -1:
        return None
    w = h = depth = maxval = None
    for line in data[i + 3:end].split(b"\n"):
        parts = line.split()
        if len(parts) != 2:
            continue
        key, val = parts
        if not val.isdigit():
            continue
        v = int(val)
        if key == b"WIDTH":
            w = v
        elif key == b"HEIGHT":
            h = v
        elif key == b"DEPTH":
            depth = v
        elif key == b"MAXVAL":
            maxval = v
    if None in (w, h, depth, maxval):
        return None
    if not (0 < w < 0x40000 and 0 < h < 0x40000 and depth in (1, 3)
            and 0 < maxval < 256):
        return None
    j = end + 7
    n = w * h * depth
    if j + n > len(data) or n < 256:
        return None
    kind = "img24" if depth == 3 else "img8"
    return MediaSpan(kind, j, n, w * depth, depth)


def _parse_tga(data, i):
    """Uncompressed truecolor/grayscale TGA at offset i.  TGA has no
    magic; like the reference's detector (the TGA branch of detect(),
    src/preprocess/preprocessor.cpp:221-260) this matches only the
    common fixed header forms: no image id, no colormap, origin (0,0),
    image type 2 (truecolor 24/32bpp) or 3 (grayscale 8bpp)."""
    if i + 18 > len(data):
        return None
    idlen, cmap, itype = data[i], data[i + 1], data[i + 2]
    if idlen != 0 or cmap != 0 or itype not in (2, 3):
        return None
    if data[i + 3:i + 8] != b"\x00" * 5:      # colormap spec empty
        return None
    xo, yo, w, h = struct.unpack_from("<HHHH", data, i + 8)
    bpp = data[i + 16]
    if xo != 0 or yo != 0:
        return None
    if not (0 < w < 0x10000 and 0 < h < 0x10000):
        return None
    if itype == 2 and bpp not in (24, 32):
        return None
    if itype == 3 and bpp != 8:
        return None
    cell = bpp // 8
    n = w * h * cell
    if i + 18 + n > len(data) or n < 1024:
        return None
    kind = "img8" if cell == 1 else "img24"
    return MediaSpan(kind, i + 18, n, w * cell, cell)


def _parse_tiff(data, i):
    """Uncompressed single-strip TIFF at offset i (cf. the reference's
    TIFF branch of detect(), src/preprocess/preprocessor.cpp:261-289):
    walks IFD0's tags and accepts compression=1 with 8-bit samples,
    1 (gray) or 3 (RGB) samples/pixel, one strip covering the image."""
    le = data[i:i + 4] == b"II*\x00"
    be = data[i:i + 4] == b"MM\x00*"
    if not (le or be) or i + 8 > len(data):
        return None
    endian = "<" if le else ">"
    try:
        (ifd_off,) = struct.unpack_from(endian + "I", data, i + 4)
        j = i + ifd_off
        (n_tags,) = struct.unpack_from(endian + "H", data, j)
        if n_tags == 0 or n_tags > 512:
            return None
        w = h = spp = comp = strip_off = strip_cnt = None
        bits_ok = True
        for k in range(n_tags):
            e = j + 2 + 12 * k
            tag, typ, cnt = struct.unpack_from(endian + "HHI", data, e)
            (val,) = struct.unpack_from(
                endian + ("H" if typ == 3 else "I"), data, e + 8)
            if tag == 256:
                w = val
            elif tag == 257:
                h = val
            elif tag == 258:
                # inline only when count==1; multi-sample BitsPerSample
                # points elsewhere -- accept (8,8,8) via samples check
                if cnt == 1 and val != 8:
                    bits_ok = False
            elif tag == 259:
                comp = val
            elif tag == 273 and cnt == 1:
                strip_off = val
            elif tag == 277:
                spp = val
            elif tag == 279 and cnt == 1:
                strip_cnt = val
    except struct.error:
        return None
    if not bits_ok or comp != 1 or spp not in (None, 1, 3):
        return None
    if None in (w, h, strip_off, strip_cnt):
        return None
    spp = spp or 1
    if not (0 < w < 0x40000 and 0 < h < 0x40000):
        return None
    n = w * h * spp
    if strip_cnt != n or i + strip_off + n > len(data) or n < 256:
        return None
    kind = "img24" if spp == 3 else "img8"
    return MediaSpan(kind, i + strip_off, n, w * spp, spp)


def _parse_wav(data, i):
    """RIFF/WAVE PCM at offset i -> MediaSpan over the data chunk."""
    if i + 44 > len(data) or data[i:i + 4] != b"RIFF" \
            or data[i + 8:i + 12] != b"WAVE":
        return None
    j = i + 12
    fmt = None
    while j + 8 <= len(data):
        cid = data[j:j + 4]
        (clen,) = struct.unpack_from("<I", data, j + 4)
        if cid == b"fmt " and clen >= 16:
            tag, ch, _, _, align, bits = struct.unpack_from(
                "<HHIIHH", data, j + 8)
            if tag != 1 or ch not in (1, 2) or bits not in (8, 16):
                return None
            fmt = (ch, bits, align)
        elif cid == b"data":
            if fmt is None:
                return None
            ch, bits, align = fmt
            n = min(clen, len(data) - j - 8)
            if n < 1024:
                return None
            cell = max(1, align)              # frame = ch * bits/8 bytes
            # stride = 2 frames: N taps the sample TWO frames back, so
            # the grid gradient W + N - NW is a linear extrapolation in
            # sample space (the reference's LPC idea, paq8.cpp:5806-5869)
            return MediaSpan("audio", j + 8, n, 2 * cell, cell)
        j += 8 + clen + (clen & 1)
    return None


def _parse_jpeg(data, i):
    """Baseline/progressive JPEG at offset i -> MediaSpan over the whole
    SOI..EOI stream (cf. the reference's JPEG detector scanning
    SOI/SOF/SOS markers, src/preprocess/preprocessor.cpp:112-124).

    The span is pass-through (no pixel transform): its purpose is (a) to
    keep the entropy-coded scan out of the text/EXE detectors and the WRT
    transform, and (b) to flag the region for JPEG-aware model routing.
    Walks the marker structure strictly; returns None on any violation so
    random FFD8 bytes in binary data do not produce false spans."""
    n = len(data)
    if i + 4 > n or data[i:i + 2] != b"\xFF\xD8" or data[i + 2] != 0xFF:
        return None
    j = i + 2
    saw_sof = saw_sos = False
    while j + 4 <= n:
        if data[j] != 0xFF:
            return None
        m = data[j + 1]
        if m == 0xD8 or m == 0x01 or 0xD0 <= m <= 0xD7:
            j += 2
            continue
        if m == 0xD9:                         # EOI before SOS: header only
            return None
        (seglen,) = struct.unpack_from(">H", data, j + 2)
        if seglen < 2 or j + 2 + seglen > n:
            return None
        if 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC):
            saw_sof = True
        body_end = j + 2 + seglen
        if m == 0xDA:                         # SOS: walk the coded scan
            if not saw_sof:
                return None
            saw_sos = True
            k = body_end
            while k + 1 < n:
                if data[k] != 0xFF:
                    k += 1
                elif data[k + 1] == 0x00 or 0xD0 <= data[k + 1] <= 0xD7:
                    k += 2                    # stuffed FF / restart marker
                elif data[k + 1] == 0xD9:     # EOI
                    if k + 2 - i < 1024:
                        return None
                    return MediaSpan("jpeg", i, k + 2 - i, 0, 0)
                else:
                    break                     # next marker (e.g. next scan)
            if k + 1 >= n:
                return None
            j = k
            continue
        j = body_end
    return None


_MAGIC_PARSERS = (
    (b"BM", _parse_bmp),
    (b"P4", _parse_pbm),
    (b"P5", _parse_pnm),
    (b"P6", _parse_pnm),
    (b"P7\n", _parse_pam),
    (b"II*\x00", _parse_tiff),
    (b"MM\x00*", _parse_tiff),
    (b"RIFF", _parse_wav),
    (b"\xFF\xD8\xFF", _parse_jpeg),
    # TGA has no magic: match the two fixed no-id/no-colormap header
    # forms (type 2 truecolor, type 3 grayscale)
    (b"\x00\x00\x02\x00\x00\x00\x00\x00", _parse_tga),
    (b"\x00\x00\x03\x00\x00\x00\x00\x00", _parse_tga),
)


def find_media_spans(data: bytes):
    """Scan for embedded media; returns non-overlapping MediaSpans in
    ascending offset order (first match wins, scan resumes after span).

    Tracks the next occurrence of each FULL magic string, so scan cost
    is proportional to candidate hits, not to file size (zero-prefixed
    magics like TGA's would otherwise crawl through every zero run)."""
    spans = []
    n = len(data)
    nxt = {}
    for magic, parser in _MAGIC_PARSERS:
        k = data.find(magic, 0, n - 64)
        if k != -1:
            nxt.setdefault(k, []).append((magic, parser))
    while nxt:
        i = min(nxt)
        cands = nxt.pop(i)
        hit = None
        for magic, parser in cands:
            if hit is None:
                hit = parser(data, i)
            # schedule this magic's next occurrence past the match
            skip = (hit.data_off + hit.data_len) if hit is not None \
                else i + 1
            k = data.find(magic, skip, n - 64)
            if k != -1:
                nxt.setdefault(k, []).append((magic, parser))
        if hit is not None:
            end = hit.data_off + hit.data_len
            spans.append(hit)
            # drop any queued candidates inside the consumed span
            for pos in [p for p in nxt if p < end]:
                for magic, parser in nxt.pop(pos):
                    k = data.find(magic, end, n - 64)
                    if k != -1:
                        nxt.setdefault(k, []).append((magic, parser))
    return spans


# --------------------------------------------------- 24bpp color transform


def img24_encode(seg: bytes, stride: int = 0) -> bytes:
    """Interleaved color decorrelation for 3-byte pixels:
    (c0, c1, c2) -> (c1, c0-c1, c2-c1) mod 256.  For BMP's BGR order this
    is (G, B-G, R-G) -- same family as the reference's encode_bmp
    (src/preprocess/preprocessor.cpp:302-375).  ``stride`` > 0 restarts
    triple alignment at every row boundary (BMP rows are padded to 4
    bytes, so triples do not stay channel-aligned across rows); trailing
    non-triple bytes of each row pass through.  Vectorized (numpy)."""
    import numpy as np
    a = np.frombuffer(seg, dtype=np.uint8).copy()
    if stride <= 0:
        stride = len(a)
    rw = stride - stride % 3                  # transformable bytes per row
    nrows = -(-len(a) // stride) if stride else 0
    for r in range(nrows):
        lo = r * stride
        w = min(rw, max(0, len(a) - lo) - max(0, len(a) - lo) % 3)
        if w <= 0:
            continue
        px = a[lo:lo + w].reshape(-1, 3).astype(np.int16)
        g = px[:, 1]
        a[lo:lo + w] = np.stack(
            [g, (px[:, 0] - g) & 0xFF, (px[:, 2] - g) & 0xFF],
            axis=1).astype(np.uint8).reshape(-1)
    return a.tobytes()


def img24_decode(seg: bytes, stride: int = 0) -> bytes:
    import numpy as np
    a = np.frombuffer(seg, dtype=np.uint8).copy()
    if stride <= 0:
        stride = len(a)
    rw = stride - stride % 3
    nrows = -(-len(a) // stride) if stride else 0
    for r in range(nrows):
        lo = r * stride
        w = min(rw, max(0, len(a) - lo) - max(0, len(a) - lo) % 3)
        if w <= 0:
            continue
        px = a[lo:lo + w].reshape(-1, 3).astype(np.int16)
        g = px[:, 0]
        a[lo:lo + w] = np.stack(
            [(px[:, 1] + g) & 0xFF, g, (px[:, 2] + g) & 0xFF],
            axis=1).astype(np.uint8).reshape(-1)
    return a.tobytes()

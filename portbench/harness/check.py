"""The comparison that decides ``correct``.

Two numbers, each with its limit:

* ``roundtrip_bad_bytes``: over every job of the window, the bytes that
  the program's ``decompress`` gives back different from the input the
  benchmark made (positions that differ, plus the difference in length).
  Limit 0: the coder is lossless.  This check is independent of the
  program: the input is the benchmark's own.
* ``archive_bad_bytes``: for one job drawn from the seed, the bytes of
  the program's archive that differ from the archive the reference
  (``portbench/reference``) writes for the same input, configuration and
  gates.  Limit 0: the predictor is the format.  An archive decodes only
  with the model that wrote it, so any change to one predicted
  probability is a change of format, and the reference holds the archive
  as a whole: header, gate record, segment table, block lengths and
  every lane's range-coded stream.  The reference is a frozen copy of
  the program with plain PyTorch in place of the DMC kernels
  (``reference/__init__.py``): the comparison checks ``dmc_fused``
  against a plain DMC and pins every other layer to the copy, and it
  cannot see a fault that the copy shares.

``parts`` names where two archives first differ, for the log.
``streams_sha256`` is the port's ``bench.py`` digest of a group's
streams (each stream cut to its length, then the lengths), copied.
"""

import hashlib
import struct

import numpy as np

LIMITS = {"roundtrip_bad_bytes": 0, "archive_bad_bytes": 0}


def diff_bytes(a: bytes, b: bytes) -> int:
    """Positions where ``a`` and ``b`` differ, plus their length gap."""
    n = min(len(a), len(b))
    x = np.frombuffer(a[:n], dtype=np.uint8)
    y = np.frombuffer(b[:n], dtype=np.uint8)
    return int((x != y).sum()) + abs(len(a) - len(b))


def header(archive: bytes):
    """The archive header's block size, exec batch (lanes a group codes)
    and block count."""
    from portbench.reference import runner as R
    f = struct.unpack(R._HDR, archive[4:4 + R._HDR_LEN])
    return {"block_size": 1 << f[2], "lanes": f[12], "blocks": f[15]}


def parts(archive: bytes):
    """[(name, start, end)] of an archive's parts: the header with its
    gate record, the segment table, the block lengths and each block's
    stream, by the reference's reading of the container."""
    from portbench.reference import runner as R
    off = 4 + R._HDR_LEN
    fields = struct.unpack(R._HDR, archive[4:off])
    flags, nb = fields[1], fields[15]
    (glen,) = struct.unpack("<H", archive[off:off + 2])
    out = [("header", 0, off + 2 + glen)]
    off += 2 + glen
    if flags & R._FLAG_WRT:
        _, end = R._read_seg_table(archive, off)
        out.append(("segment table", off, end))
        off = end
    lens = struct.unpack("<" + "I" * nb, archive[off:off + 4 * nb])
    out.append(("block lengths", off, off + 4 * nb))
    off += 4 * nb
    for i, n in enumerate(lens):
        n &= ~R._RAW_FLAG
        out.append((f"block {i} stream", off, off + n))
        off += n
    return out


def first_diff(a: bytes, b: bytes):
    """'<part> at byte <i>' where ``a`` first differs from ``b``, or None."""
    n = min(len(a), len(b))
    x = np.frombuffer(a[:n], dtype=np.uint8)
    y = np.frombuffer(b[:n], dtype=np.uint8)
    idx = np.flatnonzero(x != y)
    if len(idx) == 0:
        return None if len(a) == len(b) else f"length {len(a)} vs {len(b)}"
    i = int(idx[0])
    try:
        name = next(p for p, s, e in parts(b) if s <= i < e)
    except (StopIteration, struct.error, ValueError):
        name = "archive"
    return f"{name} at byte {i}"


def streams_sha256(streams):
    """bench.py's digest of streams (a list of bytes): the (n, longest)
    array of the streams, each cut to its length, then the lengths as
    little-endian int64."""
    out_len = np.array([len(s) for s in streams], dtype=np.int64)
    out = np.zeros((len(streams), max(1, int(out_len.max(initial=0)))),
                   dtype=np.uint8)
    for i, s in enumerate(streams):
        out[i, :len(s)] = np.frombuffer(s, dtype=np.uint8)
    keep = np.arange(out.shape[1])[None, :] < out_len[:, None]
    cut = np.where(keep, out, 0).astype(np.uint8)
    return hashlib.sha256(cut.tobytes()
                          + out_len.astype("<i8").tobytes()).hexdigest()


def archive_streams(archive: bytes):
    return [archive[s:e] for name, s, e in parts(archive)
            if name.endswith("stream")]


def verdict(values):
    """(correct, [(name, value, limit)]) for the compared numbers."""
    rows = [(k, values[k], LIMITS[k]) for k in LIMITS]
    return all(v <= lim for _, v, lim in rows), rows

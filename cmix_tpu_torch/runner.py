"""Archive container, compress/decompress entry points and CLI (PyTorch port).

Port of cmix_tpu/runner.py: the same TCMX format-v19 container (header,
gate record, per-block length table, block streams) and the same coding
groups -- the input is cut into ``block_size`` blocks, coded ``exec_batch``
blocks at a time, the last group padded with dummy lanes, an
incompressible block stored raw, and a decode group re-feeding raw-stored
and padding lanes in encode mode so the shared model evolves exactly as it
did while encoding.

The port codes every gate set the JAX package codes (``engine.make_gates``),
in the fast profile and the portable integer profile (PORT=1,
``--portable``), on any content.  The CLI takes the model gates from the
environment, as the JAX package's does (``SSE2=1 python -m
cmix_tpu_torch.runner c ...``; the archive's gate record pins them for
decode), and so does ``compress`` when it is given no ``gates``.
``compress`` runs the content transforms (``preprocess/wrt.transform``:
E8/E9 on x86 code, the 24-bit color decorrelation, JPEG recoding unless
$CMIX_JPEGC is "0"), routes the content gates on top of the caller's
(X86X=2 for x86 code, GRID2=1 for strided media or a recoded JPEG, LMS=2
for media outside PORT, JPEGX=1 for a recoded JPEG, JVAL=$JVAL_ROUTE with
it: the JAX package's defaults) and writes the segment table;
``decompress`` reads it and inverts the transforms.  With
a dictionary (``--dict PATH``, or ``auto`` for the port's copy of the
shipped ``data/english.dic``) text is WRT-coded where that shrinks it,
WRTW ($WRTW_ROUTE, 1 by default) is routed with it, and every coding
group starts from the shared state pretrained on the dictionary
(``engine.make_pretrainer``, cached by ``utils/checkpoint.py``); the
header carries the dictionary's fingerprint, and decode needs the same
file.  A portable archive is byte-identical to the JAX package's and
decodes on either package and any device.  ``--resume JOURNAL`` keeps
the finished coding groups' streams in a journal, so that a rerun of an
interrupted compress skips them (``_resume_key`` says which journal a run
trusts).

On the card the segments run as a captured CUDA graph of the byte step
(``engine.make_segment_fn``), the port's ``jax.jit`` of the JAX package's
segment scan.

    python -m cmix_tpu_torch.runner c|d|t INPUT OUTPUT [--portable]
        [--dict PATH|auto] [--device cpu] [--resume JOURNAL] [--stats]
        [--profile DIR]

``--stats`` prints the Meter's one-line JSON report on stderr;
``--profile DIR`` writes a ``torch.profiler`` trace, ``DIR/trace.json``,
and the Meter's spans and device times beside it, ``DIR/spans.json``
(``utils/profiling.py``).
"""

import argparse
import hashlib
import os
import struct
import time

import numpy as np
import torch

from cmix_tpu_torch.version import FORMAT_VERSION, MAGIC
from cmix_tpu_torch.engine import (
    GATE_NAMES, EngineConfig, FormatError, MODE_DECODE, MODE_ENCODE,
    gates_from_blob, init_perblock, init_shared, make_gates, make_transcoder,
    no_span, resolve_device)
from cmix_tpu_torch.contexts.hashes import build_wrtw_tables
from cmix_tpu_torch.preprocess import wrt
from cmix_tpu_torch.utils.checkpoint import (
    cached_pretrained_state, clone_state, dict_fingerprint)

_RAW_FLAG = 0x80000000
_FLAG_WRT = 1
_FLAG_PRETRAIN = 2
# magic | u8 version | u8 flags | u8 log2(block_size) | u8 tbits | u8 mbits
# | u8 ibits | u8 pbits | u8 log2(dmc_nodes) (0 = off) | u8 log2(seg_size)
# | u8 lstm layers | u8 lstm horizon | u16 lstm_hidden | u16 exec_batch
# | u64 orig_len | u64 payload_len | u32 n_blocks | 8s dict fingerprint
# | 32s vocab bitmap, then u16 gates_len | gates; with flags bit 0 the
# segment table follows: u32 count, then per segment <BII (type, enc_len,
# raw_len), <BIII for media types 3-5 (+ record stride), or for a recoded
# JPEG <BIIIIB (+ stride, body offset, plane count) and u32 plane lengths
_HDR = "<BBBBBBBBBBBHHQQI8s32s"
_HDR_LEN = struct.calcsize(_HDR)
_NO_DICT = b"\0" * 8
# --dict auto: the port's copy of cmix_tpu/data/english.dic
AUTO_DICT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                         "english.dic")
# dummy lanes' JPEGX offset: off every plane (as the JAX runner pads)
_NO_JPEG = -(1 << 31) + 1


def _vocab_bitmap(data: bytes) -> bytes:
    """32-byte presence bitmap (byte 0 always present: block padding)."""
    present = np.zeros(256, dtype=bool)
    present[0] = True
    if data:
        present[np.unique(np.frombuffer(data, dtype=np.uint8))] = True
    return np.packbits(present).tobytes()


def _vocab_force(bitmap: bytes):
    """Per-tree-node forcing from the presence bitmap: 1 forces the node's
    bit to 0 (no present byte above the split), 2 forces it to 1."""
    present = np.unpackbits(np.frombuffer(bitmap, dtype=np.uint8)
                            ).astype(np.int64)
    cum = np.concatenate([[0], np.cumsum(present)])
    force = np.zeros(256, dtype=np.int64)
    for n in range(1, 256):
        lev = n.bit_length() - 1
        span = 256 >> lev
        lo = (n - (1 << lev)) * span
        mid, hi = lo + span // 2, lo + span
        left = cum[mid] - cum[lo]
        right = cum[hi] - cum[mid]
        if right == 0 and left > 0:
            force[n] = 1
        elif left == 0 and right > 0:
            force[n] = 2
    return force


def _split_blocks(data: bytes, n: int):
    nb = max(1, -(-len(data) // n))
    arr = np.zeros((nb, n), dtype=np.uint8)
    flat = np.frombuffer(data, dtype=np.uint8)
    for i in range(nb):
        chunk = flat[i * n:(i + 1) * n]
        arr[i, :len(chunk)] = chunk
    return arr


def _routed_gates(seg_meta, port, dictionary):
    """The content-routed gate values (cmix_tpu/runner.py compress): on
    exactly when the segment table holds the content they model; WRTW when
    the payload was transformed and a dictionary given (whatever the
    transform: an EXE-only input coded with a dictionary routes it too).
    As in the JAX package two environment variables set the routed values:
    WRTW_ROUTE (default 1) WRTW's, JVAL_ROUTE (default 0: off) JVAL's,
    routed with JPEGX."""
    types = {e[0] for e in seg_meta or ()}
    jpegx = int(wrt.SEG_JPEGC in types)
    return {"JPEGX": jpegx,
            "GRID2": int(bool(types & set(wrt._STRIDE_SEGS))),
            "X86X": 2 * (wrt.SEG_EXE in types),
            "JVAL": int(os.environ.get("JVAL_ROUTE", "0")) * jpegx,
            "WRTW": (int(os.environ.get("WRTW_ROUTE", "1"))
                     if seg_meta is not None and dictionary is not None
                     else 0),
            "LMS": 2 * (not port and any(3 <= e[0] <= 5 and e[1]
                                         for e in seg_meta or ()))}


def env_gates(environ=None):
    """The model gates set in the environment (``os.environ`` by default):
    {name: value} of every gate name present, as the JAX package's CLI
    reads them at import."""
    environ = os.environ if environ is None else environ
    return {n: environ[n] for n in GATE_NAMES if n in environ}


def _block_fields(seg_meta, nb, n):
    """Per-block engine fields from the segment table (None without one)."""
    if seg_meta is None:
        return None
    return (wrt.block_strides(seg_meta, nb, n),
            wrt.block_kinds(seg_meta, nb, n),
            *wrt.block_jpeg_coords(seg_meta, nb, n))


def _load_dictionary(path):
    """-> (Dictionary, its file's bytes, the header fingerprint, the WRTW
    codeword tables of its lowercase words); ``path`` "auto" is AUTO_DICT.
    A missing file raises."""
    path = AUTO_DICT if path == "auto" else path
    d = wrt.Dictionary(path)
    with open(path, "rb") as f:
        dict_bytes = f.read()
    return (d, dict_bytes, dict_fingerprint(dict_bytes),
            build_wrtw_tables([w.lower() for w in d.words]))


def _pretrained_base(cfg, g, device, dict_bytes, tables):
    """The dictionary's pretrained shared state: its bytes replayed with
    LF -> space, as the JAX runner (and the reference) replays them."""
    return cached_pretrained_state(cfg, g, device,
                                   dict_bytes.replace(b"\n", b" "), tables)


def _group_state(cfg, g, b, vforce, device, fields, lo, real, base=None):
    """(sh, pb) of one coding group of ``b`` lanes; the shared state a copy
    of the pretrained ``base`` (fresh without one); the ``real`` lanes from
    block ``lo`` on take their segment-table fields, dummy lanes the JAX
    runner's pads (no stride, raw kind, off every JPEG plane)."""
    sh = (init_shared(cfg, g, device) if base is None
          else clone_state(base))
    sh["vocab_force"] = torch.as_tensor(vforce, device=device)
    pb = init_perblock(cfg, g, b, device)
    if fields is not None:
        for key, a, pad in zip(("rec_forced", "blk_kind", "jpeg_rel0",
                                "jpeg_clen"), fields, (0, 0, _NO_JPEG, 0)):
            v = np.full((b,) + a.shape[1:], pad, dtype=np.int64)
            v[:real] = a[lo:lo + real]
            pb[key] = torch.as_tensor(v, device=device)
    return sh, pb


def _ticker(show, total):
    from cmix_tpu_torch.utils.profiling import Progress
    return Progress(total, "progress") if show else None


def _progress(ticker, done, frac=1.0):
    """The transcoder's progress callback for a group starting at ``done``
    bytes, whose real lanes are ``frac`` of its lanes (the JAX runner's
    count), or None without a ticker."""
    if ticker is None:
        return None
    return lambda d: ticker.update(done + int(d * frac))


def _seg_table(seg_meta):
    parts = [struct.pack("<I", len(seg_meta))]
    for e in seg_meta:
        if e[0] == wrt.SEG_JPEGC:
            parts.append(struct.pack("<BIIIIB", *e[:5], len(e[5])))
            parts.extend(struct.pack("<I", c) for c in e[5])
        elif len(e) > 3:
            parts.append(struct.pack("<BIII", *e))
        else:
            parts.append(struct.pack("<BII", *e))
    return b"".join(parts)


def _read_seg_table(archive, off):
    """-> (seg_meta, offset after the table); FormatError if truncated."""
    def take(fmt):
        nonlocal off
        size = struct.calcsize(fmt)
        if off + size > len(archive):
            raise FormatError("truncated archive (segment table)")
        off += size
        return struct.unpack(fmt, archive[off - size:off])

    (nseg,) = take("<I")
    seg_meta = []
    for _ in range(nseg):
        t = archive[off] if off < len(archive) else None
        if t == wrt.SEG_JPEGC:
            e = take("<BIIIIB")
            seg_meta.append(e[:5] + (take("<" + "I" * e[5]),))
        elif t in wrt._STRIDE_SEGS:
            seg_meta.append(take("<BIII"))
        else:
            seg_meta.append(take("<BII"))
    return seg_meta, off


def _resume_key(payload, cfg, eb, flags, g, device):
    """The journal's 16-byte key: the JAX package's fields (format version,
    config, exec batch, flags, payload), and beyond them the gate record
    and, in the fast profile, the device type the groups were coded on
    (``device``: a torch.device), whose archives decode only there."""
    h = hashlib.sha256()
    h.update(repr((FORMAT_VERSION, cfg, eb, flags)).encode())
    h.update(b"gates:" + g.blob())
    if not g.port:
        h.update(b"device:" + device.type.encode())
    h.update(payload)
    return h.digest()[:16]


def _resume_load(path, key):
    """The whole records of a journal written under ``key`` ([(raw,
    stream)]; a torn last record is dropped), or [] for a missing journal
    or one of another key."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return []
    if blob[:4] != b"TCMR" or blob[4:20] != key:
        return []
    streams, off = [], 20
    while off + 5 <= len(blob):
        raw, L = blob[off] != 0, struct.unpack_from("<I", blob, off + 1)[0]
        if off + 5 + L > len(blob):
            break
        streams.append((raw, blob[off + 5:off + 5 + L]))
        off += 5 + L
    return streams


def _resume_save(path, key, streams):
    """Rewrite the journal atomically: ``TCMR``, the key, then a record
    (u8 raw, u32 length, stream) per block (a temporary file renamed)."""
    parts = [b"TCMR", key]
    for raw, s in streams:
        parts += [struct.pack("<BI", 1 if raw else 0, len(s)), s]
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(b"".join(parts))
    os.replace(tmp, path)


def compress(data: bytes, cfg: EngineConfig = EngineConfig(),
             max_batch: int = 64, dictionary: str = None, gates=None,
             device="cuda", resume_path=None, meter=None,
             show_progress=False) -> bytes:
    """Compress ``data`` into a TCMX archive.

    dictionary: path of a word list ("auto": AUTO_DICT); enables the WRT
    text transform where it shrinks the payload, and pretraining.
    gates: mapping of gate name -> value (missing = default), any set
    ``engine.make_gates`` accepts; None (the default) takes the gates set
    in the environment (``env_gates``), as the JAX package's ``compress``
    codes with the gates its engine read from the environment.  A mapping
    given, ``{}`` included, is used as it is.  The content-routed gates
    (JVAL among them) are then set from the content and
    ``_routed_gates``'s environment variables, whatever the caller gave.
    resume_path: a journal of the finished coding groups' streams: each
    group's are saved once they are on the host, a run restarted with the
    same input, config, gates and (in the fast profile) device type skips
    the groups it holds, and the journal goes once the archive is whole
    (``_resume_key``: a journal of anything else is ignored, whole groups
    only are kept).
    meter: a ``utils.profiling.Meter`` the transcoder's phases feed, with
    the call's spans (``compress`` and those under it) and device times;
    show_progress: a percentage ticker on stderr."""
    gates = env_gates() if gates is None else gates
    if meter is None:
        return _compress(data, cfg, max_batch, dictionary, gates, device,
                         resume_path, None, show_progress)
    with meter.call("compress"):
        return _compress(data, cfg, max_batch, dictionary, gates, device,
                         resume_path, meter, show_progress)


def _compress(data, cfg, max_batch, dictionary, gates, device, resume_path,
              meter, show_progress):
    sp = meter.span if meter else no_span
    if cfg.dmc_nodes & (cfg.dmc_nodes - 1):
        raise FormatError(f"dmc_nodes={cfg.dmc_nodes} must be 0 or a power "
                          "of two (the archive header stores its log2)")
    # the caller's JVAL is replaced by the routed one: JVAL without JPEGX
    # is no error here
    g = make_gates({k: v for k, v in gates.items() if k != "JVAL"})
    dev = resolve_device(device)
    d, dict_bytes, fp, tables = (_load_dictionary(dictionary)
                                 if dictionary is not None
                                 else (None, b"", _NO_DICT, None))
    with sp("transform"):
        payload, seg_meta = wrt.transform(data, d)
    flags = _FLAG_PRETRAIN if d is not None else 0
    # text WRT does not shrink (all text, without a dictionary) is recorded
    # as a raw segment: an input of such text and raw bytes only keeps its
    # bytes and gets no segment table
    if len(payload) >= len(data) and all(e[0] == wrt.SEG_RAW
                                         for e in seg_meta):
        payload, seg_meta = data, None
    else:
        flags |= _FLAG_WRT
    with sp("route"):
        g = make_gates(dict(g.env, **_routed_gates(seg_meta, g.port, d)))
    # after the routing: the pretrained state is the routed ensemble's
    base = None
    if d is not None:
        with sp("pretrain"):
            base = _pretrained_base(cfg, g, dev, dict_bytes, tables)
    n = cfg.block_size
    blocks = _split_blocks(payload, n)
    nb = blocks.shape[0]
    eb = min(max_batch, nb)
    trans = make_transcoder(cfg, g, dev)
    vocab = _vocab_bitmap(payload)
    vforce = _vocab_force(vocab)
    fields = _block_fields(seg_meta, nb, n)
    ticker = _ticker(show_progress, nb * n)
    streams = []
    if resume_path is not None:
        rkey = _resume_key(payload, cfg, eb, flags, g, dev)
        streams = _resume_load(resume_path, rkey)[:nb]
        if len(streams) < nb:                # whole groups only
            streams = streams[:len(streams) // eb * eb]
    for lo in range(0, nb, eb):
        batch = blocks[lo:lo + eb]
        b = batch.shape[0]
        if lo + b <= len(streams):           # coded by an earlier run
            continue
        if b < eb:
            batch = np.concatenate(
                [batch, np.zeros((eb - b, n), dtype=np.uint8)], axis=0)
        with sp("group_state"):
            sh, pb = _group_state(cfg, g, eb, vforce, dev, fields, lo, b,
                                  base)
        _, out, out_len = trans(sh, pb, batch,
                                np.zeros((eb, cfg.comp_size), np.uint8),
                                MODE_ENCODE, meter=meter,
                                progress=_progress(ticker, lo * n, b / eb))
        for i in range(b):
            L = int(out_len[i])
            if L >= n:                       # incompressible: store raw
                streams.append((True, bytes(batch[i].tobytes())[
                    :min(n, len(payload) - (lo + i) * n)]))
            else:
                streams.append((False, bytes(out[i, :L].tobytes())))
        if resume_path is not None:
            _resume_save(resume_path, rkey, streams)
    with sp("container"):
        blob = g.blob()
        header = MAGIC + struct.pack(
            _HDR, FORMAT_VERSION, flags, cfg.block_size.bit_length() - 1,
            cfg.tbits, cfg.mbits, cfg.ibits, cfg.pbits,
            cfg.dmc_nodes.bit_length() - 1 if cfg.dmc_nodes else 0,
            cfg.seg_size.bit_length() - 1, cfg.lstm_layers,
            cfg.lstm_horizon, cfg.lstm_hidden, eb, len(data), len(payload),
            nb, fp, vocab) + struct.pack("<H", len(blob)) + blob
        segtbl = _seg_table(seg_meta) if flags & _FLAG_WRT else b""
        lens = b"".join(struct.pack("<I", len(s) | (_RAW_FLAG if raw
                                                     else 0))
                        for raw, s in streams)
    if resume_path is not None:              # the archive is whole
        try:
            os.remove(resume_path)
        except OSError:
            pass
    return header + segtbl + lens + b"".join(s for _, s in streams)


def decompress(archive: bytes, dictionary: str = None, device="cuda",
               meter=None, show_progress=False) -> bytes:
    """Decode a TCMX archive.  The archive's gate record and header pin
    the ensemble and the exec batch; malformed input raises FormatError,
    and so does an archive coded with a dictionary when ``dictionary`` is
    not that file (it is ignored for an archive coded without one).
    meter, show_progress: as for ``compress`` (the call's root span is
    ``decompress``; the gate record is parsed in its ``container`` span,
    and ``transform`` is ``wrt.untransform``)."""
    if meter is None:
        return _decompress(archive, dictionary, device, None, show_progress)
    with meter.call("decompress"):
        return _decompress(archive, dictionary, device, meter, show_progress)


def _decompress(archive, dictionary, device, meter, show_progress):
    sp = meter.span if meter else no_span
    with sp("container"):
        if len(archive) < 4 + _HDR_LEN + 2:
            raise FormatError("truncated archive (shorter than the header)")
        if archive[:4] != MAGIC:
            raise FormatError("bad magic: not a TCMX archive")
        (ver, flags, log_bs, tbits, mbits, ibits, pbits, dmc_log, log_seg,
         lstm_layers, lstm_horizon, lstm_hidden, eb, orig_len, payload_len,
         nb, fp, vocab) = struct.unpack(_HDR, archive[4:4 + _HDR_LEN])
        if ver != FORMAT_VERSION:
            raise FormatError(
                f"archive format version {ver}; this build reads only "
                f"{FORMAT_VERSION} (the predictor is the format)")
        off = 4 + _HDR_LEN
        (glen,) = struct.unpack("<H", archive[off:off + 2])
        blob = archive[off + 2:off + 2 + glen]
        if len(blob) != glen:
            raise FormatError("truncated archive (gate record)")
        off += 2 + glen
        d = tables = None
        if flags & _FLAG_PRETRAIN:
            if dictionary is None:
                raise FormatError("archive requires the dictionary it was "
                                  "compressed with (pass dictionary=...)")
            d, dict_bytes, fp2, tables = _load_dictionary(dictionary)
            if fp2 != fp:
                raise FormatError("dictionary fingerprint mismatch: not the "
                                  "dictionary this archive was coded with")
        seg_meta = None
        if flags & _FLAG_WRT:
            seg_meta, off = _read_seg_table(archive, off)
        g = gates_from_blob(blob)
        dev = resolve_device(device)
        cfg = EngineConfig(block_size=1 << log_bs, tbits=tbits, mbits=mbits,
                           ibits=ibits, pbits=pbits, lstm_hidden=lstm_hidden,
                           lstm_layers=lstm_layers, lstm_horizon=lstm_horizon,
                           dmc_nodes=(1 << dmc_log) if dmc_log else 0,
                           seg_size=1 << log_seg)
        if off + 4 * nb > len(archive):
            raise FormatError("truncated archive (block length table)")
        lens = struct.unpack("<" + "I" * nb, archive[off:off + 4 * nb])
        off += 4 * nb
        streams = []
        for L in lens:
            raw = bool(L & _RAW_FLAG)
            L &= ~_RAW_FLAG
            streams.append((raw, archive[off:off + L]))
            off += L
        if off > len(archive):
            raise FormatError("truncated archive (block streams end at "
                              f"{off}, archive is {len(archive)} bytes)")
    base = None
    if d is not None:
        with sp("pretrain"):
            base = _pretrained_base(cfg, g, dev, dict_bytes, tables)
    n = cfg.block_size
    trans = make_transcoder(cfg, g, dev)
    vforce = _vocab_force(vocab)
    fields = _block_fields(seg_meta, nb, n)
    ticker = _ticker(show_progress, nb * n)
    out_parts = [None] * nb
    for lo in range(0, nb, eb):
        group = streams[lo:lo + eb]
        comp = np.zeros((eb, cfg.comp_size), dtype=np.uint8)
        inp = np.zeros((eb, n), dtype=np.uint8)
        modes = np.full(eb, MODE_ENCODE, dtype=np.int64)
        for j, (raw, s) in enumerate(group):
            if raw:
                inp[j, :len(s)] = np.frombuffer(s, dtype=np.uint8)
            else:
                comp[j, :len(s)] = np.frombuffer(s, dtype=np.uint8)
                modes[j] = MODE_DECODE
        with sp("group_state"):
            sh, pb = _group_state(cfg, g, eb, vforce, dev, fields, lo,
                                  len(group), base)
        hist, _, _ = trans(sh, pb, inp, comp, modes, meter=meter,
                           progress=_progress(ticker, lo * n,
                                              len(group) / eb))
        for j, (raw, s) in enumerate(group):
            out_parts[lo + j] = s if raw else bytes(hist[j].tobytes())
    payload = b"".join(out_parts)[:payload_len]
    if seg_meta is not None:
        with sp("transform"):
            payload = wrt.untransform(payload, seg_meta, d)
    if len(payload) != orig_len:
        raise FormatError(
            f"decoded length {len(payload)} != {orig_len} (corrupt "
            "archive, or it was coded by a different executable)")
    return payload


# ----------------------------------------------------------------------- CLI


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="cmix_tpu_torch",
        description="context-mixing compressor (PyTorch/CUDA port of "
                    "tpu-cmix)")
    ap.add_argument("mode", choices=["c", "d", "t"],
                    help="c=compress d=decompress t=roundtrip-test")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--dict", dest="dictionary", default=None,
                    help="word dictionary (enables WRT + pretraining); "
                    "'auto' uses the port's copy of the shipped English "
                    "list (cmix_tpu_torch/data/english.dic)")
    ap.add_argument("--block-size", type=int, default=1 << 16)
    ap.add_argument("--tbits", type=int, default=18)
    ap.add_argument("--lstm", type=int, default=256)
    ap.add_argument("--horizon", default="auto",
                    help="LSTM truncated-BPTT window; 'auto' is 4 under "
                    "256 KiB of input, else 8 (header-carried)")
    ap.add_argument("--dmc", type=int, default=16384,
                    help="DMC node pool per block (0 disables)")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the model runs (cpu only when asked)")
    ap.add_argument("--resume", default=None, metavar="JOURNAL",
                    help="failure-recovery journal: finished coding groups "
                    "are kept there, and a rerun of the same command skips "
                    "them")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace (Chrome trace "
                    "format) to DIR/trace.json, and the call's spans and "
                    "device times (utils/profiling.Meter) to "
                    "DIR/spans.json")
    ap.add_argument("--stats", action="store_true",
                    help="print a JSON phase/throughput report to stderr")
    ap.add_argument("--portable", action="store_true",
                    help="portable profile (PORT=1): integer model math, "
                    "archives decode bit-exactly on any device and with "
                    "the JAX package")
    args = ap.parse_args(argv)
    from cmix_tpu_torch.utils.profiling import Meter, trace
    meter = Meter() if (args.stats or args.profile) else None
    with open(args.input, "rb") as f:
        data = f.read()
    t0 = time.time()
    # the model gates: the environment's (decode reads the archive's)
    gates = env_gates()
    if args.portable:
        gates["PORT"] = 1
    if args.mode in ("c", "t"):
        horizon = (int(args.horizon) if args.horizon != "auto"
                   else (4 if len(data) <= (256 << 10) else 8))
        cfg = EngineConfig(block_size=args.block_size, tbits=args.tbits,
                           lstm_hidden=args.lstm, dmc_nodes=args.dmc,
                           lstm_horizon=horizon)
        with trace(args.profile, meter):
            out = compress(data, cfg, max_batch=args.max_batch,
                           dictionary=args.dictionary,
                           gates=gates,
                           device=args.device, resume_path=args.resume,
                           meter=meter, show_progress=True)
        if meter:
            meter.out_bytes = len(out)
            meter.bytes = len(data)
            meter.print_report(mode="compress")
        if args.mode == "t":
            back = decompress(out, dictionary=args.dictionary,
                              device=args.device)
            assert back == data, "ROUNDTRIP FAILED"
        with open(args.output, "wb") as f:
            f.write(out)
        bpb = 8.0 * len(out) / max(1, len(data))
        print(f"{len(data)} bytes -> {len(out)} bytes in "
              f"{time.time() - t0:.2f} s")
        print(f"cross entropy: {bpb:.4f}")
    else:
        with trace(args.profile, meter):
            out = decompress(data, dictionary=args.dictionary,
                             device=args.device, meter=meter,
                             show_progress=True)
        if meter:
            meter.out_bytes = len(data)
            meter.bytes = len(out)
            meter.print_report(mode="decompress")
        with open(args.output, "wb") as f:
            f.write(out)
        print(f"{len(data)} bytes -> {len(out)} bytes in "
              f"{time.time() - t0:.2f} s")


if __name__ == "__main__":
    main()

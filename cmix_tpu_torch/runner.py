"""Archive container, compress/decompress entry points and CLI (PyTorch port).

Port of cmix_tpu/runner.py: the same TCMX format-v19 container (header,
gate record, per-block length table, block streams) and the same coding
groups -- the input is cut into ``block_size`` blocks, coded ``exec_batch``
blocks at a time, the last group padded with dummy lanes, an
incompressible block stored raw, and a decode group re-feeding raw-stored
and padding lanes in encode mode so the shared model evolves exactly as it
did while encoding.

The port codes the fast profile at two gate sets (the defaults and the
bench speed profile) and the portable integer profile (PORT=1 on top of
the defaults, ``--portable``), on inputs whose content detection finds only
text and raw segments.  A portable archive is byte-identical to the JAX
package's and decodes on either package and any device.  Everything else
raises NotImplementedError naming the ROADMAP.md item that will port it: a
dictionary (WRT + pretraining), ``--resume``, EXE/media/JPEG content
(content-routed gates and transforms), and archives that carry a segment
table.

    python -m cmix_tpu_torch.runner c|d|t INPUT OUTPUT [--portable]
        [--device cpu]
"""

import argparse
import struct
import time

import numpy as np
import torch

from cmix_tpu_torch.version import FORMAT_VERSION, MAGIC
from cmix_tpu_torch.engine import (
    EngineConfig, FormatError, MODE_DECODE, MODE_ENCODE, gates_from_blob,
    init_perblock, init_shared, make_gates, make_transcoder, resolve_device)
from cmix_tpu_torch.preprocess import wrt

_RAW_FLAG = 0x80000000
_FLAG_WRT = 1
_FLAG_PRETRAIN = 2
# magic | u8 version | u8 flags | u8 log2(block_size) | u8 tbits | u8 mbits
# | u8 ibits | u8 pbits | u8 log2(dmc_nodes) (0 = off) | u8 log2(seg_size)
# | u8 lstm layers | u8 lstm horizon | u16 lstm_hidden | u16 exec_batch
# | u64 orig_len | u64 payload_len | u32 n_blocks | 8s dict fingerprint
# | 32s vocab bitmap, then u16 gates_len | gates
_HDR = "<BBBBBBBBBBBHHQQI8s32s"
_HDR_LEN = struct.calcsize(_HDR)
_NO_DICT = b"\0" * 8
_LATER_DICT = "ROADMAP.md queue 1, item 12 (WRT and dictionary pretraining)"
_LATER_RESUME = "ROADMAP.md queue 1, item 13 (--resume journal)"
_LATER_CONTENT = {
    wrt.SEG_EXE: "item 11 (content-routed gates: X86X=2 and the EXE "
                 "transform)",
    wrt.SEG_IMG24: "item 11 (content-routed gates: media/GRID2/LMS)",
    wrt.SEG_IMG8: "item 11 (content-routed gates: media/GRID2/LMS)",
    wrt.SEG_AUDIO: "item 11 (content-routed gates: media/GRID2/LMS)",
    wrt.SEG_JPEG: "item 11 (content-routed gates: JPEGX)",
}


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


def _refuse_content(data: bytes):
    """NotImplementedError for content whose segments need a transform or
    a content-routed gate this slice does not port."""
    for typ, lo, hi, _ in wrt.segments(data):
        if typ in _LATER_CONTENT:
            raise NotImplementedError(
                f"{wrt.SEG_NAMES[typ]} content at bytes [{lo}, {hi}) is not "
                f"ported to cmix_tpu_torch yet (ROADMAP.md queue 1, "
                f"{_LATER_CONTENT[typ]})")


def _group_state(cfg, g, b, vforce, device):
    sh = init_shared(cfg, g, device)
    sh["vocab_force"] = torch.as_tensor(vforce, device=device)
    return sh, init_perblock(cfg, g, b, device)


def compress(data: bytes, cfg: EngineConfig = EngineConfig(),
             max_batch: int = 64, dictionary: str = None, gates=None,
             device="cuda", resume_path=None) -> bytes:
    """Compress ``data`` into a TCMX archive.

    gates: mapping of gate name -> value (missing = default); the port
    accepts the defaults, ``engine.BENCH_GATES``, and PORT=1 (with any
    ILSTM_LRX/ILSTM_ADAM) on top of the defaults."""
    if dictionary is not None:
        raise NotImplementedError(
            f"--dict is not ported to cmix_tpu_torch yet ({_LATER_DICT})")
    if resume_path is not None:
        raise NotImplementedError(
            f"--resume is not ported to cmix_tpu_torch yet ({_LATER_RESUME})")
    if cfg.dmc_nodes & (cfg.dmc_nodes - 1):
        raise FormatError(f"dmc_nodes={cfg.dmc_nodes} must be 0 or a power "
                          "of two (the archive header stores its log2)")
    g = make_gates(gates)
    dev = resolve_device(device)
    _refuse_content(data)
    # text without a dictionary is recorded as a raw segment, so the JAX
    # package's transform leaves the payload as it is and writes no
    # segment table: flags stay 0
    n = cfg.block_size
    blocks = _split_blocks(data, n)
    nb = blocks.shape[0]
    eb = min(max_batch, nb)
    trans = make_transcoder(cfg, g, dev)
    vocab = _vocab_bitmap(data)
    vforce = _vocab_force(vocab)
    streams = []
    for lo in range(0, nb, eb):
        batch = blocks[lo:lo + eb]
        b = batch.shape[0]
        if b < eb:
            batch = np.concatenate(
                [batch, np.zeros((eb - b, n), dtype=np.uint8)], axis=0)
        sh, pb = _group_state(cfg, g, eb, vforce, dev)
        _, out, out_len = trans(sh, pb, batch,
                                np.zeros((eb, cfg.comp_size), np.uint8),
                                MODE_ENCODE)
        for i in range(b):
            L = int(out_len[i])
            if L >= n:                       # incompressible: store raw
                streams.append((True, bytes(batch[i].tobytes())[
                    :min(n, len(data) - (lo + i) * n)]))
            else:
                streams.append((False, bytes(out[i, :L].tobytes())))
    blob = g.blob()
    header = MAGIC + struct.pack(
        _HDR, FORMAT_VERSION, 0, cfg.block_size.bit_length() - 1,
        cfg.tbits, cfg.mbits, cfg.ibits, cfg.pbits,
        cfg.dmc_nodes.bit_length() - 1 if cfg.dmc_nodes else 0,
        cfg.seg_size.bit_length() - 1, cfg.lstm_layers, cfg.lstm_horizon,
        cfg.lstm_hidden, eb, len(data), len(data), nb, _NO_DICT, vocab) \
        + struct.pack("<H", len(blob)) + blob
    lens = b"".join(struct.pack("<I", len(s) | (_RAW_FLAG if raw else 0))
                    for raw, s in streams)
    return header + lens + b"".join(s for _, s in streams)


def decompress(archive: bytes, dictionary: str = None,
               device="cuda") -> bytes:
    """Decode a TCMX archive.  The archive's gate record and header pin
    the ensemble and the exec batch; malformed input raises FormatError."""
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
    if dictionary is not None or flags & _FLAG_PRETRAIN:
        raise NotImplementedError(
            "dictionary-pretrained archives are not ported to "
            f"cmix_tpu_torch yet ({_LATER_DICT})")
    if flags & _FLAG_WRT:
        raise NotImplementedError(
            "archives with segmented preprocessing (WRT/EXE/media "
            "transforms) are not ported to cmix_tpu_torch yet (ROADMAP.md "
            "queue 1, items 11-12)")
    g = gates_from_blob(blob)
    dev = resolve_device(device)
    cfg = EngineConfig(block_size=1 << log_bs, tbits=tbits, mbits=mbits,
                       ibits=ibits, pbits=pbits, lstm_hidden=lstm_hidden,
                       lstm_layers=lstm_layers, lstm_horizon=lstm_horizon,
                       dmc_nodes=(1 << dmc_log) if dmc_log else 0,
                       seg_size=1 << log_seg)
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
    n = cfg.block_size
    trans = make_transcoder(cfg, g, dev)
    vforce = _vocab_force(vocab)
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
        sh, pb = _group_state(cfg, g, eb, vforce, dev)
        hist, _, _ = trans(sh, pb, inp, comp, modes)
        for j, (raw, s) in enumerate(group):
            out_parts[lo + j] = s if raw else bytes(hist[j].tobytes())
    payload = b"".join(out_parts)[:payload_len]
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
                    help="word dictionary (not ported yet: raises)")
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
                    help="failure-recovery journal (not ported yet: raises)")
    ap.add_argument("--portable", action="store_true",
                    help="portable profile (PORT=1): integer model math, "
                    "archives decode bit-exactly on any device and with "
                    "the JAX package")
    args = ap.parse_args(argv)
    with open(args.input, "rb") as f:
        data = f.read()
    t0 = time.time()
    if args.mode in ("c", "t"):
        horizon = (int(args.horizon) if args.horizon != "auto"
                   else (4 if len(data) <= (256 << 10) else 8))
        cfg = EngineConfig(block_size=args.block_size, tbits=args.tbits,
                           lstm_hidden=args.lstm, dmc_nodes=args.dmc,
                           lstm_horizon=horizon)
        out = compress(data, cfg, max_batch=args.max_batch,
                       dictionary=args.dictionary,
                       gates={"PORT": 1} if args.portable else None,
                       device=args.device, resume_path=args.resume)
        if args.mode == "t":
            back = decompress(out, device=args.device)
            assert back == data, "ROUNDTRIP FAILED"
        with open(args.output, "wb") as f:
            f.write(out)
        bpb = 8.0 * len(out) / max(1, len(data))
        print(f"{len(data)} bytes -> {len(out)} bytes in "
              f"{time.time() - t0:.2f} s")
        print(f"cross entropy: {bpb:.4f}")
    else:
        out = decompress(data, dictionary=args.dictionary,
                         device=args.device)
        with open(args.output, "wb") as f:
            f.write(out)
        print(f"{len(data)} bytes -> {len(out)} bytes in "
              f"{time.time() - t0:.2f} s")


if __name__ == "__main__":
    main()

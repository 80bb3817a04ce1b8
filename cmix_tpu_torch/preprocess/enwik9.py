"""enwik9 pipeline tool: article reorder + WIT-style header transform.

Host copy of cmix_tpu/preprocess/enwik9.py (no tensor code; the port keeps
its own copy, as it does of every host module): the same container, the
same orders and CLI, so each package decodes the other's output.

Capability parity with the reference's standalone enwik9-preproc
(src/enwik9-preproc/main.cpp:42-68): split the dump into intro / article
region / coda (misc.h:2-8), permute the ``<page>`` blocks by a semantic
order file with redirect-aware renumbering (article_reorder.h:92-164),
and move high-entropy header numerics (ids, timestamps) out of the text
stream (phda9_preprocess.h:148-333).  The inverse restores the original
byte stream exactly: pages are sorted back by their ``<id>`` like the
reference's bubble-sort restore (article_reorder.h:166-185).

This is a NEW container format (not the reference's): the transform is
self-describing and decode(encode(x)) == x for any input -- pages that
do not match the strict header pattern pass through untouched, and if
any page lacks an id the permutation is skipped entirely (flagged in the
header) so the inverse never guesses.

CLI (like ``enwik9-preproc c|d file``):
    python -m cmix_tpu_torch.preprocess.enwik9 c  IN OUT [--order FILE]
    python -m cmix_tpu_torch.preprocess.enwik9 d  IN OUT
    python -m cmix_tpu_torch.preprocess.enwik9 remap IN OUT   (order-file tool,
        capability of src/enwik9-preproc/article_remap.cpp: numbering
        that skips redirect articles)
"""

import argparse
import calendar
import re
import time

MAGIC = b"TCW9"
PAGE_OPEN = b"  <page>\n"
PAGE_CLOSE = b"  </page>\n"

_REDIRECT_PREFIXES = (
    b"      <text xml:space=\"preserve\">#REDIRECT",
    b"      <text xml:space=\"preserve\">#redirect",
    b"      <text xml:space=\"preserve\">#Redirect",
    b"      <text xml:space=\"preserve\">#REdirect",
    b"      <text xml:space=\"preserve\">{{softredirect",
)

_ID_RE = re.compile(rb"<id>(\d+)</id>")
_TS_RE = re.compile(
    rb"<timestamp>(\d{4}-\d{2}-\d{2}T\d{2}:\d{2}:\d{2})Z</timestamp>")

FLAG_REORDERED = 1


def _varint(n: int) -> bytes:
    assert n >= 0
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(data, off):
    n = shift = 0
    while True:
        b = data[off]
        off += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, off
        shift += 7


def _zigzag(n: int) -> int:
    return n << 1 if n >= 0 else ((-n) << 1) - 1


def _unzigzag(z: int) -> int:
    return (z >> 1) if (z & 1) == 0 else -((z + 1) >> 1)


def split_pages(data: bytes):
    """(intro, [page bytes...], coda); pages include their tags."""
    first = data.find(PAGE_OPEN)
    if first < 0:
        return data, [], b""
    intro = data[:first]
    pages = []
    pos = first
    while True:
        end = data.find(PAGE_CLOSE, pos)
        if end < 0:
            # unterminated page: treat the remainder as coda
            return intro, pages, data[pos:]
        end += len(PAGE_CLOSE)
        pages.append(data[pos:end])
        nxt = data.find(PAGE_OPEN, end)
        if nxt < 0 or nxt != end:
            # reference articles are contiguous; anything between
            # pages would break the split, so stop at the first gap
            return intro, pages, data[end:]
        pos = nxt


def is_redirect(page: bytes) -> bool:
    for line in page.split(b"\n"):
        for pre in _REDIRECT_PREFIXES:
            if line.startswith(pre):
                return True
    return False


def page_id(page: bytes):
    m = _ID_RE.search(page)
    return int(m.group(1)) if m else None


def load_order(path):
    with open(path, "rb") as f:
        return [int(x) for x in f.read().split()]


def make_remap_order(data: bytes):
    """Order-file numbering tool (article_remap.cpp capability): for each
    non-redirect article, its raw page index."""
    _, pages, _ = split_pages(data)
    return [i for i, p in enumerate(pages) if not is_redirect(p)]


_TITLE_RE = re.compile(rb"<title>([^<]*)</title>")
_CAT_RE = re.compile(rb"\[\[[Cc]ategory:([^\]|]+)")


def make_semantic_order(data: bytes):
    """Semantic article ordering (the role of the reference's
    new_article_order asset, article_reorder.h:92-164): cluster similar
    articles adjacently so the compressor's context models see related
    text consecutively.  The reference VENDORS a 172K-line ordering
    computed offline (STARLIT); this environment has no enwik9 and no
    network, so the framework ships the GENERATOR instead -- greedy
    category-then-title clustering over the dump's own index, computed
    once per dump and cacheable as an order file.  Entries index
    non-redirect articles in document order (same numbering as `remap`).

    Key per article: (first [[Category:...]] tag, title words reversed,
    title) -- reversing the title groups "List of X", "History of X"
    with their subject X's cluster.
    """
    _, pages, _ = split_pages(data)
    arts = []
    seq = 0
    for p in pages:
        if is_redirect(p):
            continue
        mt = _TITLE_RE.search(p)
        title = mt.group(1).lower() if mt else b""
        mc = _CAT_RE.search(p)
        cat = mc.group(1).strip().lower() if mc else b"\xff"
        words = title.split()
        arts.append((cat, tuple(reversed(words)), title, seq))
        seq += 1
    arts.sort()
    return [a[3] for a in arts]


def _strip_numerics(page: bytes):
    """Remove id digits + timestamp strings; return (text, ids, stamps).

    Every match is removed so the inverse is purely positional: decode
    refills the k-th empty tag from the k-th recorded value.
    """
    ids = [int(m.group(1)) for m in _ID_RE.finditer(page)]
    stamps = []

    def ts_sub(m):
        stamps.append(calendar.timegm(
            time.strptime(m.group(1).decode(), "%Y-%m-%dT%H:%M:%S")))
        return b"<timestamp>Z</timestamp>"

    text = _ID_RE.sub(b"<id></id>", page)
    text = _TS_RE.sub(ts_sub, text)
    return text, ids, stamps


def _restore_numerics(text: bytes, ids, stamps):
    it_id = iter(ids)
    it_ts = iter(stamps)
    text = re.sub(rb"<id></id>",
                  lambda m: b"<id>%d</id>" % next(it_id), text)
    text = re.sub(
        rb"<timestamp>Z</timestamp>",
        lambda m: b"<timestamp>%sZ</timestamp>" % time.strftime(
            "%Y-%m-%dT%H:%M:%S", time.gmtime(next(it_ts))).encode(),
        text)
    return text


def encode(data: bytes, order=None) -> bytes:
    intro, pages, coda = split_pages(data)
    n = len(pages)
    flags = 0
    perm = list(range(n))
    ids = [page_id(p) for p in pages]
    if order and n and all(i is not None for i in ids):
        # redirect-aware remap: order entries count non-redirect
        # articles only (article_reorder.h:100-123)
        remap = [i for i, p in enumerate(pages) if not is_redirect(p)]
        used = [False] * n
        perm = []
        for o in order:
            if 0 <= o < len(remap) and not used[remap[o]]:
                perm.append(remap[o])
                used[remap[o]] = True
        perm.extend(i for i in range(n) if not used[i])
        flags |= FLAG_REORDERED

    out = bytearray()
    out += MAGIC
    out.append(flags)
    out += _varint(len(intro)) + intro
    out += _varint(n)
    tail = bytearray()
    prev_id = 0
    prev_ts = 0
    for pi in perm:
        text, pids, stamps = _strip_numerics(pages[pi])
        out += _varint(len(text)) + text
        tail += _varint(len(pids))
        for v in pids:
            tail += _varint(_zigzag(v - prev_id))
            prev_id = v
        tail += _varint(len(stamps))
        for v in stamps:
            tail += _varint(_zigzag(v - prev_ts))
            prev_ts = v
    out += _varint(len(coda)) + coda
    out += tail
    return bytes(out)


def decode(blob: bytes) -> bytes:
    assert blob[:4] == MAGIC, "bad enwik9-preproc magic"
    flags = blob[4]
    off = 5
    ln, off = _read_varint(blob, off)
    intro = blob[off:off + ln]
    off += ln
    n, off = _read_varint(blob, off)
    texts = []
    for _ in range(n):
        ln, off = _read_varint(blob, off)
        texts.append(blob[off:off + ln])
        off += ln
    ln, off = _read_varint(blob, off)
    coda = blob[off:off + ln]
    off += ln
    prev_id = 0
    prev_ts = 0
    pages = []
    for text in texts:
        k, off = _read_varint(blob, off)
        pids = []
        for _ in range(k):
            z, off = _read_varint(blob, off)
            prev_id += _unzigzag(z)
            pids.append(prev_id)
        k, off = _read_varint(blob, off)
        stamps = []
        for _ in range(k):
            z, off = _read_varint(blob, off)
            prev_ts += _unzigzag(z)
            stamps.append(prev_ts)
        pages.append(_restore_numerics(text, pids, stamps))
    if flags & FLAG_REORDERED:
        # restore original order by page id (article_reorder.h:166-185)
        pages.sort(key=lambda p: page_id(p))
    return intro + b"".join(pages) + coda


def main(argv=None):
    ap = argparse.ArgumentParser(prog="enwik9-preproc")
    ap.add_argument("mode", choices=["c", "d", "remap", "order"])
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--order", default=None,
                    help="semantic article order file (one int per "
                    "line); 'auto' derives one from the dump itself "
                    "(make_semantic_order)")
    args = ap.parse_args(argv)
    with open(args.input, "rb") as f:
        data = f.read()
    if args.mode == "c":
        if args.order == "auto":
            order = make_semantic_order(data)
        else:
            order = load_order(args.order) if args.order else None
        out = encode(data, order)
    elif args.mode == "d":
        out = decode(data)
    elif args.mode == "order":
        out = b"".join(b"%d\n" % i for i in make_semantic_order(data))
    else:
        out = b"".join(b"%d\n" % i for i in make_remap_order(data))
    with open(args.output, "wb") as f:
        f.write(out)
    print(f"{len(data)} bytes -> {len(out)} bytes")


if __name__ == "__main__":
    main()

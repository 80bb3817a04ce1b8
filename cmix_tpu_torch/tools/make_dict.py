"""Dictionary builder: frequency-ordered word list from a training corpus.

Host copy of cmix_tpu/tools/make_dict.py (what tools/rebuild_dict.py
runs): the same counts, order and head, so both packages build the same
word list from the same corpus.  Its CLI writes the list as
tools/rebuild_dict.py does (the original's CLI fails on its own words).

The reference ships a fixed asset (`dictionary/english.dic`, 44,515
frequency-ordered lowercase words, SURVEY.md C35) that its WRT transform
and pretraining consume.  This framework instead ships the *builder*: any
corpus in the target domain yields a compatible dictionary (one lowercase
word per line, most frequent first), and any existing cmix-style word
list also loads directly (`cmix_tpu_torch.preprocess.wrt.Dictionary`).

Frequency ordering matters: the WRT codeword space is tiered (1-byte
codes for the first 64 ids, 2-byte for the next ~12K, 3-byte beyond --
native/preproc.cpp), so putting common words first minimizes codeword
bytes; the same property drives the reference's asset
(src/preprocess/dictionary.cpp:46-73).

Usage:
    python -m cmix_tpu_torch.tools.make_dict OUT.dic CORPUS [CORPUS...] \
        [--max-words N] [--min-count N] [--min-len N]
"""

import argparse
import collections
import re

_WORD_RE = re.compile(rb"[a-zA-Z]+")


def count_words(blobs, min_len=2):
    """Case-folded word frequencies over an iterable of byte strings."""
    counts = collections.Counter()
    for blob in blobs:
        for m in _WORD_RE.finditer(blob):
            w = m.group().lower()
            if len(w) >= min_len:
                counts[w] += 1
    return counts


def build_dictionary(blobs, max_words=44514, min_count=2, min_len=2,
                     core=True, min_docs=1):
    """Frequency-ordered word list (ties broken alphabetically so the
    output is deterministic across runs and platforms).

    core=True prepends the hand-curated common-English head
    (core_words.py) so the 1-byte/early-2-byte codeword bands go to
    genuinely common words even when the only local corpora are source
    trees (ADVICE.md round 2: a license/source-boilerplate head
    underperforms on ordinary English).  min_docs > 1 drops words seen
    in fewer than that many distinct input blobs (filters file-local
    identifiers like qopenglfunctions)."""
    counts = collections.Counter()
    docs = collections.Counter()
    for blob in blobs:
        c = count_words([blob], min_len=min_len)
        counts.update(c)
        docs.update(c.keys())
    ranked = sorted(counts.items(), key=lambda kv: (-kv[1], kv[0]))
    head = []
    if core:
        from cmix_tpu_torch.tools.core_words import core_list
        head = core_list()
    seen = set(head)
    out = list(head)
    for w, c in ranked:
        if len(out) >= max_words:
            break
        ws = w.decode("ascii") if isinstance(w, bytes) else w
        if c < min_count or docs[w] < min_docs or ws in seen:
            continue
        if len(ws) > 20:
            continue
        seen.add(ws)
        out.append(ws)
    return out[:max_words]


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="make_dict",
        description="Build a frequency-ordered WRT dictionary from a "
                    "training corpus")
    ap.add_argument("output", help="output .dic path (one word per line)")
    ap.add_argument("corpus", nargs="+", help="input files to count")
    ap.add_argument("--max-words", type=int, default=44514)
    ap.add_argument("--min-count", type=int, default=2)
    ap.add_argument("--min-len", type=int, default=2)
    ap.add_argument("--min-docs", type=int, default=1,
                    help="drop words seen in fewer distinct input files")
    ap.add_argument("--no-core", action="store_true",
                    help="skip the curated common-English head")
    args = ap.parse_args(argv)

    def blobs():
        for p in args.corpus:
            with open(p, "rb") as f:
                yield f.read()

    words = build_dictionary(blobs(), max_words=args.max_words,
                             min_count=args.min_count,
                             min_len=args.min_len,
                             core=not args.no_core,
                             min_docs=args.min_docs)
    # the words are str (the JAX package's CLI joins them as bytes and
    # raises TypeError: ROADMAP.md section 3); written as
    # tools/rebuild_dict.py writes them
    with open(args.output, "wb") as f:
        f.write(("\n".join(words) + "\n").encode())
    print(f"{args.output}: {len(words)} words")


if __name__ == "__main__":
    main()

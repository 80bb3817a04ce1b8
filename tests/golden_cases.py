"""The reader of the JAX package's goldens (testdata/jax_goldens.json).

It imports neither JAX nor torch: tests/torch_parity.py reads the table
through it on the CPU, and chip_smoke.py on the card, where there is no JAX.
"""

import hashlib
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = os.path.join(ROOT, "testdata", "jax_goldens.json")


def sha256(data):
    return hashlib.sha256(data).hexdigest()


def goldens():
    with open(GOLDENS) as f:
        return json.load(f)


def read_parts(parts):
    """The bytes of an entry's input: its [path, start, stop] slices of
    committed files (``stop`` null: to the end), joined."""
    out = []
    for path, start, stop in parts:
        with open(os.path.join(ROOT, path), "rb") as f:
            out.append(f.read()[start:stop])
    return b"".join(out)


def archive(e):
    """The committed archive of entry ``e``; raises unless it has the
    entry's sha256 and length."""
    with open(os.path.join(ROOT, e["file"]), "rb") as f:
        arc = f.read()
    if (sha256(arc), len(arc)) != (e["sha256"], e["length"]):
        raise AssertionError(f"{e['file']}: not the archive of its entry")
    return arc


def read_case(name):
    """Golden case ``name`` -> (its entry, its input bytes, the path of its
    dictionary or None, the JAX package's archive); raises unless the input
    has the entry's sha256, the archive is the entry's, and the dictionary
    is one whole committed file."""
    e = goldens()["cases"][name]
    data = read_parts(e["input"])
    if sha256(data) != e["input_sha256"]:
        raise AssertionError(f"{name}: the input is not the entry's")
    dic = e["dictionary"]
    if dic is not None:
        (path, start, stop), = dic
        if (start, stop) != (0, None):
            raise ValueError(f"{name}: the dictionary is a slice of {path}")
        dic = os.path.join(ROOT, path)
    return e, data, dic, archive(e)

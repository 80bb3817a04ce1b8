"""The reference that ``archive_bad_bytes`` holds the program's archive
against.

A frozen copy of the port (``cmix_tpu_torch``) at archive format version
19: its engine, contexts, mixers, preprocessing and container, with the
imports renamed; it imports nothing of the program.  It is not an
independent implementation.  The one part it computes on its own is the
DMC: its two kernels are plain PyTorch here (``models/dmc.py``), where
the program runs ``csrc/dmc_fused.cu``.  Everything else is the
program's own code as it was frozen, so the comparison pins the archive:
a change in the bytes the program writes for an input shows (a changed
rounding order, a lower precision, a fault brought in after the copy),
and a fault that the program already had when it was copied does not.
The independent check of a run is its round trip
(``roundtrip_bad_bytes``: the bytes ``decompress`` gives back against the
input the benchmark made).
"""

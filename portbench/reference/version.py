"""Format versioning (copy of cmix_tpu/version.py's constants).

The archive format is defined by the exact numeric behavior of the model
ensemble; the port writes the same container (magic, version, header,
gate record, segment table) as the JAX package.
"""

FORMAT_VERSION = 19
MAGIC = b"TCMX"

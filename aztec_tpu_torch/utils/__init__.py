"""Utilities (ref: aztec_tpu/utils/): the fixture cache.  The reference's
XLA compile-cache plumbing (``jaxcache``, ``cpu_warm``) has no counterpart
here."""

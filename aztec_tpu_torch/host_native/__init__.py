"""Host C++ core of the port: the composer core and the crypto C ABI.

Port of aztec_tpu/native/: its C++ sources (``src/``, the port's own copy)
built with g++ on first use and bound through ctypes.  ``build`` compiles
each library into ``build/aztec_tpu_torch/`` at the root of the checkout,
under a file name that carries a hash of its sources; ``cbind`` is the
byte-buffer API (Pedersen, Blake2s, Keccak, Schnorr).  There is no Python
fallback: without g++ the loaders raise.  (``aztec_tpu_torch/native.py`` is
the CUDA kernels' loader.)
"""

from .build import load_composer_core  # noqa: F401

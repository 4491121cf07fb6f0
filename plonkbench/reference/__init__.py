"""The plain reference that decides ``correct``: plain Python integers only
(NumPy for one sort, ``hashlib`` for Blake2s).

It imports nothing of ``aztec_tpu_torch``, ``aztec_tpu`` or JAX.  The field,
curve, Keccak, Pedersen, transcript and verifier routines are frozen copies
of the published algorithms (barretenberg's Standard and Turbo PLONK with
the Keccak transcript, and unrolled Turbo with the Pedersen-Blake2s one), so
a later change to the program cannot move them.
"""

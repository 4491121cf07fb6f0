"""The plain reference that decides ``correct``: plain Python integers only.

It imports nothing of ``aztec_tpu_torch``, ``aztec_tpu`` or JAX.  The field,
curve, Keccak, transcript and verifier routines are frozen copies of the
published algorithms (barretenberg's Standard and Turbo PLONK with the
Keccak transcript), so a later change to the program cannot move them.
"""

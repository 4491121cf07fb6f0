"""Seconds of the proving key and the verification key in set-up (SRS,
selectors, sigmas, their commitments): the benchmark's span around
compute_proving_key() and compute_verification_key(), the device synchronised."""


def read(run):
    return run["setup"].get("key")

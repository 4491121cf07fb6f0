"""Seconds of the circuit's build in set-up (the tx, the stdlib's gates on the
composer): the benchmark's span around the configuration's builder."""


def read(run):
    return run["setup"].get("circuit_build")

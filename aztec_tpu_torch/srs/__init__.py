from .reference_string import (
    ProverReferenceString,
    VerifierReferenceString,
    FakeReferenceStringFactory,
    FileReferenceStringFactory,
    MemReferenceString,
    write_dev_srs,
)

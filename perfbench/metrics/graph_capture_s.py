"""Seconds the program spent capturing its CUDA graphs in set-up (the
step's, the ragged tail's and the validation forward's), summed from its
own counter, ``BoundBody.capture_seconds``."""


def read(run, cell):
    return run.capture_s if run.capture_s > 0 else None

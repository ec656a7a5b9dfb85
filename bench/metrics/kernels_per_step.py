"""Kernels that ran on the card per round of the traced window."""


def read(run):
    return run.kernels / run.rounds if run.rounds else None

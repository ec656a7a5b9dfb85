"""Host calls that put work on the card (kernel launches, graph launches,
asynchronous copies) per round of the traced window."""


def read(run):
    return run.host_launches / run.rounds if run.rounds else None

"""Device time of every other kernel (sampling, sorts, scatters, AdamW,
the merge, the write-back: the LocalUpdate's small kernels), per round.
Copies and memsets are not kernels and are left out."""


def read(run):
    return 1e3 * run.device_s.get("other", 0.0) / run.rounds if run.rounds else None

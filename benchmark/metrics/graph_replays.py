"""graph_replays, for every cell (``.bulk``, ``.request``, ...): mean number
of CUDA-graph replays of the codec's device steps a call (one
``encode_batch`` + ``decode_batch``): the program's ``*.replay`` spans
(``progspans.py``), one around each replay's launch.  Nothing to read in
an untraced run, nor where the program replayed no step (on the CPU, or a
program that captures none)."""

import progspans


def read(run):
    found = progspans.window(run)
    if found is None:
        return None
    replays = [s for s in found[1] if s[0].endswith(".replay")]
    return len(replays) / len(run.calls) if replays else None

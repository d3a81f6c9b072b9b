"""round_trips, for every cell (``.bulk``, ``.request``, ...): mean number
of times a call (one ``encode_batch`` + ``decode_batch``) waited for
device tensors to reach the host: the program's ``*.fetch`` spans
(``progspans.py``).  Nothing to read in an untraced run."""

import progspans


def read(run):
    found = progspans.window(run)
    if found is None:
        return None
    fetches = [s for s in found[1] if s[0].endswith(".fetch")]
    return len(fetches) / len(run.calls)

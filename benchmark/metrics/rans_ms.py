"""rans_ms, for every cell (``.bulk``, ``.request``, ...): mean host
milliseconds a call (one ``encode_batch`` + ``decode_batch``) spent in the
host rANS coder, ``native/rans.py``: the program's ``*.rans`` spans, each
around one fan-out of the coding over the codec's thread pool
(``progspans.py``).  Nothing to read in an untraced run."""

import progspans


def read(run):
    return progspans.per_call_ms(run, ("rans",))

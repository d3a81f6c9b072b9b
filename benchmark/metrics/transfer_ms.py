"""transfer_ms, for every cell (``.bulk``, ``.request``, ...): mean host
milliseconds a call (one ``encode_batch`` + ``decode_batch``) spent
waiting on copies between host and device: the program's ``*.fetch`` and
``*.upload`` spans (``progspans.py``).  Each copy is synchronous, so the
wait includes the device work queued before it.  Nothing to read in an
untraced run."""

import progspans


def read(run):
    return progspans.per_call_ms(run, ("fetch", "upload"))

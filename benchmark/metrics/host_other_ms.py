"""host_other_ms, for every cell (``.bulk``, ``.request``, ...): mean host
milliseconds a call (one ``encode_batch`` + ``decode_batch``) spent
outside its transfers and its host rANS: the program's root spans less
the leaves under them (Python, numpy, dispatch, packing;
``progspans.py``).  Nothing to read in an untraced run."""

import progspans


def read(run):
    found = progspans.window(run)
    if found is None:
        return None
    roots, leaves = found
    return (progspans.ms(roots) - progspans.ms(leaves)) / len(run.calls)

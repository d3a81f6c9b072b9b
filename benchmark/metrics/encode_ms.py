"""encode_ms, for every cell (``.bulk``, ``.request``, ...): mean host
milliseconds of one ``RGBAFileCodec.encode_batch`` call in the window
(the benchmark's own span around the call)."""


def read(run):
    return run.span_ms("encode")

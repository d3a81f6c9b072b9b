"""decode_ms, for every cell (``.bulk``, ``.request``, ...): mean host
milliseconds of one ``RGBAFileCodec.decode_batch`` call in the window
(the benchmark's own span around the call, the uint8 fetch included)."""


def read(run):
    return run.span_ms("decode")

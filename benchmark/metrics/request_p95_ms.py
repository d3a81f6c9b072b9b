"""request_p95_ms: the 95th percentile of the milliseconds of every
request in the window (encode and decode of one image), a failed request
counted as infinitely slow; linear between the order statistics."""

import math


def read(run):
    lat = sorted(run.latencies_ms())
    if not lat:
        return None
    pos = 0.95 * (len(lat) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(lat) - 1)
    if math.isinf(lat[hi]):
        return lat[hi]
    return lat[lo] + (lat[hi] - lat[lo]) * (pos - lo)

"""Ms per query in which the card ran nothing while the calling thread was
inside ``tpumatch.extract`` (the port's extraction, ``ops/reconstruct``):
the union of the spans' intervals less the union of the device events'
intervals, over the queries.  None where the trace holds no ``tpumatch.``
span, as a port without spans leaves it, or no device event, as a run
without a card leaves it."""


def _union(intervals) -> list:
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def read(view):
    if not (view.events and view.queries
            and any(h[0].startswith("tpumatch.") for h in view.host)):
        return None
    busy = _union((lo, hi) for _n, lo, hi in view.events)
    idle, j = 0.0, 0
    for lo, hi in _union((lo, hi) for name, lo, hi in view.host
                         if name == "tpumatch.extract"):
        while j < len(busy) and busy[j][1] <= lo:
            j += 1
        idle += hi - lo
        k = j
        while k < len(busy) and busy[k][0] < hi:
            idle -= min(hi, busy[k][1]) - max(lo, busy[k][0])
            k += 1
    return idle / 1e3 / view.queries

"""Host ms per query inside ``tpumatch.result.copy``: ``make_result``
copying each result's offsets from the card into page-locked host memory
and waiting for the copy.  None where the trace holds no
``tpumatch.result.copy`` span, as a port that copies results another way
leaves it, or no device event, as a run without a card leaves it."""


def read(view):
    spans = [hi - lo for name, lo, hi in view.host
             if name == "tpumatch.result.copy"]
    if not (view.events and view.queries and spans):
        return None
    return sum(spans) / 1e3 / view.queries

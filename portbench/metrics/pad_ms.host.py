"""Host ms per call inside ``tpumatch.stage.pad``: ``match`` padding the
caller's bytes into a fresh buffer before the copy to the card.  None
where the trace holds no ``tpumatch.`` span, as a port without spans
leaves it, or no device event, as a run without a card leaves it."""


def read(view):
    if not (view.events and view.queries
            and any(h[0].startswith("tpumatch.") for h in view.host)):
        return None
    return sum(hi - lo for name, lo, hi in view.host
               if name == "tpumatch.stage.pad") / 1e3 / view.queries

"""K2 rescans per query: ``tpumatch.rescan`` spans (``ops/reconstruct``'s
escalation to a full naive scan when a pattern's candidate chunks
outnumber the gather width).  None where the trace holds no
``tpumatch.`` span, as a port without spans leaves it, or no device event,
as a run without a card leaves it."""


def read(view):
    if not (view.events and view.queries
            and any(h[0].startswith("tpumatch.") for h in view.host)):
        return None
    return sum(h[0] == "tpumatch.rescan" for h in view.host) / view.queries

"""The host's waits for the card inside ``tpumatch.run`` (the port's
device pipeline), per query: CUDA runtime calls named in ``SYNCS`` whose
midpoint lies in a ``tpumatch.run`` span.

On the card (H100, torch 2.11) each of the pipeline's reads of a device
value waits in one of them: ``nonzero``, ``.item()`` / ``int()`` of a
device scalar and ``.cpu()`` each end in a ``cudaStreamSynchronize``.  The
results' copy to the host in ``tpumatch.result`` lies outside the span on
purpose: it is the closed loop's return, not a wait the pipeline chose.
None where the trace holds no ``tpumatch.`` span, as a port without spans
leaves it, or no device event, as a run without a card leaves it."""

import bisect

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


def read(view):
    if not (view.events and view.queries
            and any(h[0].startswith("tpumatch.") for h in view.host)):
        return None
    runs = []
    for lo, hi in sorted((lo, hi) for name, lo, hi in view.host
                         if name == "tpumatch.run"):
        if runs and lo <= runs[-1][1]:
            runs[-1][1] = max(runs[-1][1], hi)
        else:
            runs.append([lo, hi])
    starts = [lo for lo, _hi in runs]
    waits = 0
    for name, lo, hi in view.host:
        if name in SYNCS:
            mid = (lo + hi) / 2
            i = bisect.bisect_right(starts, mid) - 1
            waits += i >= 0 and mid < runs[i][1]
    return waits / view.queries

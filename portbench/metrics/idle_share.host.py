"""Share of the traced window in which no operation ran on the device:
1 - (union of the device events' intervals) / window."""


def read(view):
    return view.idle_share()

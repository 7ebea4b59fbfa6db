"""Summed device ms per query of every device event."""


def read(view):
    return view.per_query_ms(view.events)

"""Device events (kernels, copies, memsets) per query: what the pipeline
and extraction launch."""


def read(view):
    if not view.events or not view.queries:
        return None
    return len(view.events) / view.queries

"""Device ms per call of the host-to-device copies (``Matcher.match``'s
``to_device`` of the padded text): host staging."""


def read(view):
    return view.per_query_ms(view.named("HtoD"))

"""All the text bytes of the calls completed in the window, over it, in
GB/s."""


def value(window: dict) -> float:
    return window["queries"] * window["text_bytes"] / window["window_s"] / 1e9

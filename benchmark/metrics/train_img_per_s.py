"""Training images (synthetic batch and step) over the whole (plain) window."""


def read(run):
    return run["calls"] * run["images_per_call"] / run["window_s"]

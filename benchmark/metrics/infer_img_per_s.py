"""Images whose whole prediction is back, over the whole (plain) window."""


def read(run):
    return run["calls"] * run["images_per_call"] / run["window_s"]

"""Host-clock ms of a training step (`make_train_step`'s step, ending in a
device synchronise), averaged over the traced window."""


def read(run):
    return run["spans"].mean_ms("train_step_ms")

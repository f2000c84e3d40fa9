"""Host-clock ms of the synthetic-data batch (`make_synth_data_fn`'s
function, ending in a device synchronise), averaged over the traced
window's spans."""


def read(run):
    return run["spans"].mean_ms("synth_ms")

"""Kernel K2's forward (`smpl_verts_kernel`) against its roofline, in %: the
sum over the profiled launches of each launch's bound
(benchmark/roofline/k2_fwd.py) over the sum of their device times.  A
prediction launches it at B rows (point estimate), B (T-pose) and B·N
(samples), in that order; a trace with another count of launches gives
nothing."""

from benchmark.harness.cell import roofline


def read(run):
    t = run["trace"]
    if t is None:
        return None
    us = t.kernel_us(lambda name: "smpl_verts_kernel" in name)
    traffic, smpl = run["cell"].traffic, run["cell"].config["SMPL"]
    b, n = traffic["batch"], traffic["num_samples"]
    rows = [b, b, b * n] * t.calls
    if not us or len(us) != len(rows):
        return None
    k2 = roofline("k2_fwd")
    bound = sum(k2.launch_bound_s(r, smpl["NUM_VERTS"], smpl["NUM_BETAS"]) for r in rows)
    return 100.0 * bound / (sum(us) / 1e6)

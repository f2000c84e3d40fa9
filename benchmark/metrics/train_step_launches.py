"""The CUDA runtime's launch calls a step inside the program's span
`train_step` (forward, backward from any thread, check, Adam), over the
profiled calls of a traced run (benchmark/harness/program_spans.py);
nothing where the program has no such span or the trace no kernel."""

from benchmark.harness.program_spans import span_launches


def read(run):
    return span_launches(run["trace"], "train_step")

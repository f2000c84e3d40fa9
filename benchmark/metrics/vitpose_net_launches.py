"""The CUDA runtime's launch calls a call inside the program's span
`vitpose.net` (the normalisation, the ViT and the deconvolution head), over
the profiled calls of a traced run (benchmark/harness/program_spans.py);
nothing where the program has no such span or the trace no kernel."""

from benchmark.harness.program_spans import span_launches


def read(run):
    return span_launches(run["trace"], "vitpose.net")

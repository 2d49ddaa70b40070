"""step.capture_s: seconds of set-up the graphed step spends on its eager
warm-up steps (cuDNN's algorithm choice, allocator growth, the kernels'
first loads) and its capture: the program's ``graph.warmup`` and
``graph.capture`` spans (train/graph.py ``GraphedStep``) between the
process's start and the window's, each less its ``kernels.build`` children
(ops/cuda_build.py: a checkout's first run compiles the fused norm inside
the first warm-up step), so a run that builds reads as one that loads. A
part of ``setup_s``. Read from the program's span ring (host clock); nothing
where the program records no spans or its ring no longer reaches the
process's start.
"""

from benchmark.core import program_spans


def read(run):
    t1 = run.window.t0
    records = program_spans.ring(t1 - run.setup_s, t1)
    if records is None:
        return None
    secs, n = program_spans.seconds_within(records, ("graph.warmup", "graph.capture"),
                                           t1 - run.setup_s, t1)
    return secs if n else None

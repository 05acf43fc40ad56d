"""A closed loop over a backlog: the seeded scans, in turn, fed lazily to
the program's serving stream (``VolumeEvaluator.predict_volumes_pipelined``
at the workload's depth) until the window ends; the stream then drains.

Rate: the volumes whose labels reached the host, over the whole window
(from the first dispatch to the last fetch), under the end-to-end metric
that the workload's ``rate_metric`` names. The check compares a sample of
them, drawn from the seed, with the reference.
"""

from __future__ import annotations

import time

from benchmark import serving
from benchmark.core import Window


def setup(ctx):
    st = serving.setup(ctx)
    warm = st.volumes[:ctx.workload["warmup_volumes"]]
    st.evaluator.predict_volumes_pipelined(iter(warm), seed=0,
                                           pipeline_depth=ctx.workload["pipeline_depth"])
    return st


def window(ctx, st):
    n = len(st.volumes)
    t0 = time.perf_counter()
    end = t0 + ctx.seconds

    def feed():
        i = 0
        while True:
            ctx.tracer.tick()
            if time.perf_counter() >= end:
                return
            yield st.volumes[i % n]
            i += 1

    labels = st.evaluator.predict_volumes_pipelined(
        feed(), seed=st.stream_seed, pipeline_depth=ctx.workload["pipeline_depth"])
    window_s = time.perf_counter() - t0
    done = len(labels)
    return Window(attempted=done, failed=0, e2e={ctx.workload["rate_metric"]: done / window_s},
                  counts={"volumes": done, "window_s": window_s}, outputs=labels)


def check(ctx, st, win):
    picked = serving.sample(ctx, len(win.outputs))
    labels = {i: win.outputs[i] for i in picked}
    win.outputs = None
    return serving.check(ctx, st, labels)

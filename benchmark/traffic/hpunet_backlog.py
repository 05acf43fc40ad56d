"""The backlog of ``backlog.py`` served by the Hierarchical Probabilistic
U-Net: the same closed loop over the seeded scans and the same window
(``backlog.window``), with the hpunet's set-up and check
(``hpunet_serving``): the program's task built first, the published
initializers, the control's float8 convs, the fault the workload's ``fault``
key names (null: none), and the reference of ``reference/hpunet.py``."""

from __future__ import annotations

from benchmark import hpunet_serving, serving
from benchmark.core import HERE, load_module

_backlog = load_module(HERE / "traffic" / "backlog.py", "bench_traffic_backlog")
window = _backlog.window


def setup(ctx):
    st = hpunet_serving.setup(ctx)
    warm = st.volumes[:ctx.workload["warmup_volumes"]]
    st.evaluator.predict_volumes_pipelined(iter(warm), seed=0,
                                           pipeline_depth=ctx.workload["pipeline_depth"])
    return st


def check(ctx, st, win):
    picked = serving.sample(ctx, len(win.outputs))
    labels = {i: win.outputs[i] for i in picked}
    win.outputs = None
    return hpunet_serving.check(ctx, st, labels)

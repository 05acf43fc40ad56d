"""The ranks of a CPU world (gloo) for the port's multi-process tests
(``tests/test_torch_parallel.py``, ``tests/test_torch_hostdata.py``,
``tests/test_torch_eval_parallel.py``, ``tests/test_torch_rss_world.py``,
``tests/test_torch_tensor_parallel.py``).

    python -m tests.torch_dist_worker WORLD IODIR

``IODIR/cases.pkl`` holds a list of cases (dicts with a ``kind``). WORLD
processes, started by ``pmpu_tpu_torch.parallel.spawn_world`` on a free
port, join one world and run the cases in order; rank r writes
``IODIR/rank{r}.pkl``, one result a case. Imports torch and the port only.
"""

import contextlib
import os
import pickle
import subprocess
import sys

import torch


def _task(case):
    from pmpu_tpu_torch.train.tasks import make_task

    task = make_task(case["name"], **case["kw"], device="cpu", train=True, seed=0)
    if "state_dict" in case:
        task.net.load_state_dict({k: torch.from_numpy(v) for k, v in case["state_dict"].items()})
    return task


def _state_np(net):
    return {k: v.detach().numpy().copy() for k, v in net.state_dict().items()}


def _block(a, rank, size):
    n = len(a) // size
    return a[rank * n:(rank + 1) * n]


def run_step(case, rank, size):
    """Train steps of mode ``dp``, ``hostlocal`` or ``plain`` (the
    one-process step) from a state_dict; per step its metrics, then the
    state_dict and the momentum buffers."""
    from pmpu_tpu_torch.data import sampler as sm
    from pmpu_tpu_torch.data.augment import AugmentConfig
    from pmpu_tpu_torch.parallel import make_dp_train_step, make_hostlocal_dp_train_step, make_mesh
    from pmpu_tpu_torch.train import steps

    task = _task(case)
    state = steps.create_train_state(task, momentum=0.9, seed=case.get("seed", 0))
    sampler = sm.sample_batch_vt if case.get("layout") == "vt" else sm.sample_batch
    aug = AugmentConfig(elastic_alpha=4.0) if case.get("augment") else None
    mode, acc = case["mode"], case["acc"]
    images, labels = case["images"], case["labels"]
    if mode == "dp":
        step = make_dp_train_step(task, make_mesh(), acc_steps=acc, sampler=sampler, augment=aug)
    elif mode == "hostlocal":
        step = make_hostlocal_dp_train_step(task, make_mesh(), acc_steps=acc, augment=aug)
        images, labels = _block(images, rank, size), _block(labels, rank, size)
    else:
        step = steps.make_train_step(task, acc_steps=acc, sampler=sampler, augment=aug)
    ti, tl = torch.from_numpy(images), torch.from_numpy(labels)
    metrics = []
    for k, lr in enumerate(case["lrs"]):
        triples = case["triples"][k]
        eps = case["eps"][k] if case.get("eps") is not None else None
        if mode == "hostlocal":
            triples = _block(triples, rank, size)
            eps = None if eps is None else eps[rank]
        state, m = step(state, ti, tl, torch.from_numpy(triples), lr,
                        None if eps is None else torch.from_numpy(eps))
        metrics.append({key: float(v) for key, v in m.items()})
    return {"metrics": metrics, **_whole_state_np(state),
            "generator": state.generator.get_state().numpy()}


@contextlib.contextmanager
def _pre_clip_grads(state):
    """Inside: the step's gradients before its clip, by parameter name, are
    copied into the dict yielded (the first clip's)."""
    names = {p: n for n, p in state.net.named_parameters()}
    clip, seen = torch.nn.utils.clip_grad_value_, {}

    def spy(params, value):
        if not seen:
            seen.update({names[p]: p.grad.detach().clone() for p in params
                         if p.grad is not None})
        return clip(params, value)

    torch.nn.utils.clip_grad_value_ = spy
    try:
        yield seen
    finally:
        torch.nn.utils.clip_grad_value_ = clip


def _whole_state_np(state):
    """A whole ``TrainState``'s state_dict and momentum buffers as numpy."""
    names = {p: n for n, p in state.net.named_parameters()}
    return {"state": _state_np(state.net),
            "momentum": {names[p]: s["momentum_buffer"].numpy().copy()
                         for p, s in state.optimizer.state.items()}}


def run_tp_step(case, rank, size):
    """Train steps of the data-parallel step on a ``case["mesh"]`` (data,
    model) mesh with the state channel-sharded at ``case["min_channels"]``,
    from a state_dict, eps injected. Per step its metrics; then this rank's
    tensors (``local``), the gathered whole state, the first step's
    gradients before the clip (gathered), the generator; the whole state
    again after ``shard_state`` and ``gather_state`` of it
    (``round_trip``); with ``case["resume"]`` (``{"eps": the eps of one
    more step at the last rows, or None}``) that step from the state as it
    is (``next``) and from the gathered state through a checkpoint file,
    restored and sharded (``resumed``)."""
    from pmpu_tpu_torch.data import sampler as sm
    from pmpu_tpu_torch.parallel import (
        gather_state,
        make_dp_train_step,
        make_mesh,
        make_state_shardings,
        shard_state,
    )
    from pmpu_tpu_torch.parallel.tensor import gather_dim0
    from pmpu_tpu_torch.train import checkpoint as ckpt
    from pmpu_tpu_torch.train import steps

    sampler = sm.sample_batch_vt if case.get("layout") == "vt" else sm.sample_batch
    mesh = make_mesh(*case["mesh"])
    ti, tl = torch.from_numpy(case["images"]), torch.from_numpy(case["labels"])

    def sharded_state(path=None):
        """The case's state (restored from ``path``), sharded, and its step."""
        task = _task(case)
        state = steps.create_train_state(task, momentum=0.9, seed=case.get("seed", 0))
        if path is not None:
            ckpt.restore_train_state(path, state)
        sh = make_state_shardings(state, mesh, case["min_channels"])
        shard_state(state, sh)
        step = make_dp_train_step(task, mesh, acc_steps=case["acc"], sampler=sampler)
        return state, sh, step

    def run(state, step, k, eps):
        _, m = step(state, ti, tl, torch.from_numpy(case["triples"][k]), case["lrs"][k],
                    None if eps is None else torch.from_numpy(eps))
        return {key: float(v) for key, v in m.items()}

    state, sh, step = sharded_state()
    eps = [None] * len(case["lrs"]) if case.get("eps") is None else case["eps"]
    with _pre_clip_grads(state) as grads:
        metrics = [run(state, step, 0, eps[0])]
    metrics += [run(state, step, k, eps[k]) for k in range(1, len(case["lrs"]))]
    out = {"metrics": metrics, "local": _state_np(state.net),
           "grads": {k: (gather_dim0(g, mesh) if sh.net[k] else g).numpy()
                     for k, g in grads.items()},
           "specs": {k: v for k, v in sh.net.items() if v},
           "generator": state.generator.get_state().numpy()}
    whole = gather_state(state, sh)
    out.update(_whole_state_np(whole))
    out["round_trip"] = _whole_state_np(gather_state(shard_state(whole, sh), sh))
    if "resume" in case:
        path = os.path.join(case["cwd"], f"rank{rank}.pkl")
        os.makedirs(case["cwd"], exist_ok=True)
        ckpt.save_checkpoint(path, gather_state(state, sh))
        k = len(case["lrs"]) - 1
        for key, (st, stp) in (("next", (state, step)), ("resumed", sharded_state(path)[::2])):
            m = run(st, stp, k, case["resume"]["eps"])
            out[key] = {"metrics": m, "step": st.step,
                        **_whole_state_np(gather_state(st, sh))}
    return out


def run_eval(case, rank, size):
    """The host-local eval step on this rank's block; eps the pair of this
    rank (probunet)."""
    from pmpu_tpu_torch.parallel import make_hostlocal_eval_step, make_mesh
    from pmpu_tpu_torch.train import steps

    task = _task(case)
    state = steps.create_train_state(task)
    step = make_hostlocal_eval_step(task, make_mesh())
    eps = case.get("eps")
    eps = None if eps is None else tuple(torch.from_numpy(e) for e in eps[rank])
    loss, dice, preds, _, _ = step(
        state, torch.from_numpy(_block(case["images"], rank, size)),
        torch.from_numpy(_block(case["labels"], rank, size)),
        torch.from_numpy(_block(case["triples"], rank, size)), case["weights"][rank], eps)
    return {"loss": float(loss), "dice": dice.numpy(), "preds": preds.numpy()}


def run_train_net(case, rank, size):
    """``train_net`` on the arrays of the case in its working directory:
    the history, the steps run, the final variables (flax layout) and the
    checkpoint paths this rank wrote; or the error or interrupt it
    raised. ``interrupt``: (rank, n) sets that rank's interrupt flag from
    its n-th poll on."""
    from pmpu_tpu_torch.config import Config
    from pmpu_tpu_torch.data.volumes import VolumeStore
    from pmpu_tpu_torch.train import checkpoint as ckpt
    from pmpu_tpu_torch.train import loop, steps

    os.makedirs(case["cwd"], exist_ok=True)
    os.chdir(case["cwd"])
    written, polls, steps_run = [], [0], [0]
    save = ckpt.save_checkpoint

    def recording_save(path, *a, **kw):
        written.append(path)
        return save(path, *a, **kw)

    make = steps.make_train_step

    def counting_make(*a, **kw):
        step = make(*a, **kw)

        def counted(*sa, **skw):
            steps_run[0] += 1
            return step(*sa, **skw)

        return counted

    flag = None
    if case.get("interrupt") is not None and case["interrupt"][0] == rank:
        def flag():
            polls[0] += 1
            return polls[0] >= case["interrupt"][1]

    ckpt.save_checkpoint, steps.make_train_step = recording_save, counting_make
    # the factories of parallel/sharding.py and of the loop call make_train_step
    # through these module attributes
    import pmpu_tpu_torch.parallel.sharding as sharding

    sharding.make_train_step, loop.make_train_step = counting_make, counting_make
    out = {"written": written}
    try:
        _, task, history = loop.train_net(Config(**case["cfg"]),
                                          VolumeStore.from_arrays(*case["data"]),
                                          interrupt_flag=flag, device="cpu")
        out.update(history=history, variables=ckpt.flax_variables(task.net))
    except KeyboardInterrupt:
        out["interrupted"] = True
    except (ValueError, NotImplementedError) as e:
        out["error"] = f"{type(e).__name__}: {e}"
    finally:
        ckpt.save_checkpoint = save
        steps.make_train_step = sharding.make_train_step = loop.make_train_step = make
    out["steps"] = steps_run[0]
    return out


def run_evaluator(case, rank, size):
    """The slice-parallel ``VolumeEvaluator`` (a mesh of every rank, or
    ``case["mesh"]`` (data, model)) from a state_dict: each op of
    ``case["ops"]`` in order, its result as numpy.
    Exports and the int8 scale file go under ``case["cwd"]``, the same
    paths on every rank (rank 0 alone writes)."""
    from pmpu_tpu_torch.data.volumes import VolumeStore
    from pmpu_tpu_torch.inference.engine import VolumeEvaluator
    from pmpu_tpu_torch.parallel import make_mesh
    from pmpu_tpu_torch.train.tasks import make_task

    os.makedirs(case["cwd"], exist_ok=True)
    task = make_task(case["name"], **case["kw"], device="cpu")
    task.net.load_state_dict({k: torch.from_numpy(v) for k, v in case["state_dict"].items()})
    kw = dict(case.get("ev", {}))
    if "calibration" in kw:
        kw["calibration"] = os.path.join(case["cwd"], kw["calibration"])
    ev = VolumeEvaluator(task, device="cpu", mesh=make_mesh(*case.get("mesh", ())), **kw)
    out = []
    for op, args in case["ops"]:
        if op == "volume":
            r = ev.evaluate_volume(*args)
            out.append({"fused": r["fused"].numpy(), "argmax": r["argmax"], "dice": r.get("dice"),
                        "views": [v.numpy() for v in r["views"]]})
        elif op in ("store", "batched"):
            imgs, lbls, seed, save, unc = args
            dirs = [None if d is None else os.path.join(case["cwd"], d) for d in (save, unc)]
            store = VolumeStore.from_arrays(imgs, lbls)
            if op == "store":
                out.append(ev.evaluate_store(store, seed, *dirs))
            else:
                out.append(ev.evaluate_store_batched(store, seed, *dirs, volumes_per_batch=2))
        elif op == "ged":
            out.append(ev.ged_volume(*args))
        elif op == "stream":
            vols, seed = args
            out.append(ev.predict_volumes_pipelined(list(vols), seed, 2, want_entropy=True))
        else:
            raise ValueError(op)
    return out


def run_rss_decision(case, rank, size):
    """``train_net`` with ``--rss-limit-mb`` where only rank
    ``case["over"]`` reads an RSS over the limit: what each rank raised."""
    from pmpu_tpu_torch.config import Config
    from pmpu_tpu_torch.data.volumes import VolumeStore
    from pmpu_tpu_torch.train import loop

    os.makedirs(case["cwd"], exist_ok=True)
    os.chdir(case["cwd"])
    rss = loop.rss_mb
    loop.rss_mb = lambda *a: 1e12 if rank == case["over"] else 1.0
    try:
        loop.train_net(Config(**case["cfg"]), VolumeStore.from_arrays(*case["data"]),
                       device="cpu")
        return {"raised": None}
    except loop.RssLimitExceeded as e:
        return {"raised": "RssLimitExceeded", "epochs_done": e.epochs_done,
                "path": e.checkpoint_path, "files": sorted(os.listdir(case["cfg"]["checkpoint_dir"]))}
    finally:
        loop.rss_mb = rss


def run_global_batch(case, rank, size):
    from pmpu_tpu_torch.parallel import make_global_batch

    return make_global_batch(case["rows"][rank])


KINDS = {"step": run_step, "tp_step": run_tp_step, "eval": run_eval,
         "train_net": run_train_net,
         "global_batch": run_global_batch, "evaluator": run_evaluator,
         "rss_decision": run_rss_decision}


def run_world(world, cases, iodir, timeout=240):
    """Run ``cases`` in a CPU world of ``world`` ranks (a subprocess of this
    module, ended at ``timeout`` seconds); the ranks' result lists."""
    os.makedirs(iodir, exist_ok=True)
    with open(os.path.join(iodir, "cases.pkl"), "wb") as f:
        pickle.dump(cases, f)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.run([sys.executable, "-m", "tests.torch_dist_worker", str(world),
                           str(iodir)], cwd=root, env=env, capture_output=True, text=True,
                          timeout=timeout)
    assert proc.returncode == 0, proc.stderr[-6000:]
    out = []
    for r in range(world):
        with open(os.path.join(iodir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def run(iodir):
    import torch.distributed as dist

    from pmpu_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    sys.modules["torch.utils.tensorboard"] = None  # the writer's in-memory fallback
    rank, size = init_distributed("cpu")
    with open(os.path.join(iodir, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)
    results = [KINDS[c["kind"]](c, rank, size) for c in cases]
    with open(os.path.join(iodir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    from pmpu_tpu_torch.parallel import spawn_world

    spawn_world(run, int(sys.argv[1]), (os.path.abspath(sys.argv[2]),))

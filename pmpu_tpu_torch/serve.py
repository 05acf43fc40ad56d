"""Serving daemon of the port (counterpart of the JAX package's root
``serve.py``): watch a directory, segment volumes as they arrive.

    python -m pmpu_tpu_torch.serve -m probunet -f ckpt.pt --watch incoming/ \\
        --out segs/ [--uncertainty unc/] [--cube 128] [--poll 1.0] [--once]

New ``.nii[.gz]`` files in ``--watch`` are padded to one cube, segmented
by ``predict_volumes_pipelined`` (volume i+1 dispatched before volume i is
fetched) and written to ``--out`` (and their entropy to
``--uncertainty``) by a writer thread, cropped back to the source shape
with the source affine unless ``--identity-affine``. A file is picked up
when its size is the same on two scans (a half-written upload is left
alone); ``--once`` takes the directory as it is and exits, 1 when a
volume failed to load or was rejected.

Faults: a header that does not parse, or a payload that does not load, is
retried and quarantined at the third failure; an input larger than the
cube is rejected from its header at once. Both are re-inspected when the
file's size changes (a stalled upload resumed, a corrected file). With
``--cube 0`` the cube is fixed by the first volume that loads, never by a
header alone. Restarts are idempotent: inputs whose outputs exist and are
at least as new are skipped at startup; a newer upload under the same name
is served again.

``--rss-limit-mb M``: after a served batch with the host RSS above M MB,
the exports are drained and the process re-executes itself (``python -m
pmpu_tpu_torch.serve``, the arguments ``main`` was given) with SIGINT
blocked across the ``execv``; the new process unblocks it first thing. An
in-process caller of :func:`main` must not pass it: the ``execv`` replaces
the calling process. SIGINT in any phase exits 0 after the pending exports
are written.

Differences from the JAX daemon: the model is built at startup from
``--seed`` (random weights differ between the packages; parity is held
with a checkpoint), batch ``k`` takes ``seed=derive_seed(--seed, served)``
where JAX folds ``served`` into its key, and ``--compile-cache`` is
accepted and does nothing (PyTorch keeps no compilation cache). Runs on
the card; ``--device cpu`` runs the kernels' plain versions on the CPU.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import time

from pmpu_tpu_torch.config import Config, parse_num_filters
from pmpu_tpu_torch.data import nifti
from pmpu_tpu_torch.data.volumes import geom_from_header, pad_to_cube, restore_geometry
from pmpu_tpu_torch.utils.profiling import rss_mb


def get_args(argv=None):
    p = argparse.ArgumentParser(
        description="Serve segmentations for a directory of incoming volumes",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    p.add_argument("-f", "--load", dest="load", type=str, default=None, help="checkpoint")
    p.add_argument("-m", "--model", dest="net", type=str, default="probunet")
    p.add_argument("--watch", type=str, required=True, help="input directory to poll")
    p.add_argument("--out", type=str, required=True, help="segmentation output directory")
    p.add_argument("--uncertainty", type=str, default=None, help="entropy map directory")
    p.add_argument("--cube", type=int, default=0,
                   help="pad-to-cube size (0 = size of the first volume that loads); "
                   "inputs larger than this are rejected")
    p.add_argument("--poll", type=float, default=1.0, help="directory scan interval (s)")
    p.add_argument("--once", action="store_true", help="process current contents and exit")
    p.add_argument("--pipeline-depth", type=int, default=2)
    p.add_argument("--eval-samples", dest="eval_samples", type=int, default=5)
    p.add_argument("--eval-batch", dest="eval_batch", type=int, default=0)
    p.add_argument("--num-views", dest="num_views", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute + compact bf16 volume uploads")
    p.add_argument("--quantize", type=str, default=None, choices=["int8"],
                   help="post-training int8 inference")
    p.add_argument("--calibration", type=str, default=None,
                   help="int8 activation-scale JSON (load if present, save "
                   "after first-volume self-calibration otherwise)")
    p.add_argument("--input-dtype", dest="input_dtype", type=str, default=None,
                   choices=["float32", "bfloat16", "uint8"],
                   help="H2D volume wire dtype (default: bf16 iff --bf16); "
                   "uint8 halves bf16's upload bytes")
    p.add_argument("--compile-cache", dest="compile_cache", type=str, default=None,
                   help="accepted for the JAX daemon's command lines; does nothing "
                   "(PyTorch keeps no compilation cache)")
    p.add_argument("--identity-affine", dest="identity_affine", action="store_true",
                   help="strict reference-parity exports: padded cube + "
                   "identity affine (default: un-pad to the source shape "
                   "and carry the input scan's affine through)")
    p.add_argument("--n-classes", dest="n_classes", type=int, default=3,
                   help="output classes (needed for raw torch state_dict "
                   "checkpoints, which carry no architecture record)")
    p.add_argument("--num-filters", dest="num_filters", type=parse_num_filters,
                   default=(64, 128, 256, 512, 1024),
                   help="comma-separated encoder widths (torch checkpoints)")
    p.add_argument("--rss-limit-mb", dest="rss_limit_mb", type=float, default=0.0,
                   help="re-exec the daemon when its host RSS exceeds this "
                   "after a served batch (0 = off); restarts skip inputs whose "
                   "outputs are current. Use an explicit --cube so the "
                   "restarted daemon pads to the same cube")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda, or cpu for the kernels' plain versions")
    return p.parse_args(argv)


def _try_load(path):
    try:
        return nifti.load(path)
    except Exception as e:  # a corrupt or truncated upload: counted by the caller
        return e


def _stable_new_files(watch, seen, sizes):
    """Names whose size is unchanged since the previous scan (upload done).

    Names that have vanished from the directory are forgotten: bounded
    watcher state in high-churn directories, and a fixed re-upload of a
    previously quarantined/processed name is picked up again."""
    listing = sorted(filter(nifti.is_nifti_name, os.listdir(watch)))
    present = set(listing)
    seen.intersection_update(present)
    for gone in [n for n in sizes if n not in present]:
        del sizes[gone]
    ready = []
    for n in listing:
        if n in seen:
            continue
        try:
            sz = os.path.getsize(os.path.join(watch, n))
        except OSError:
            # deleted/renamed between listdir and stat — skip this poll
            sizes.pop(n, None)
            continue
        if sizes.get(n) == sz:
            ready.append(n)
        sizes[n] = sz
    return ready


def _served_and_current(args, n: str) -> bool:
    """True when ``n``'s output(s) already exist and are at least as new as
    the input: the startup gate that makes restarts (crash, redeploy,
    ``--rss-limit-mb`` re-exec) skip the served backlog. A re-upload under
    the same name (newer mtime) is served again."""
    try:
        im = os.path.getmtime(os.path.join(args.watch, n))
        if os.path.getmtime(os.path.join(args.out, n)) < im:
            return False
        if args.uncertainty and os.path.getmtime(
                os.path.join(args.uncertainty, n)) < im:
            return False
    except OSError:
        return False
    return True


def _malloc_trim():
    """Return freed glibc arena pages to the OS after a served batch: the
    per-volume load and decompression buffers otherwise raise glibc's
    dynamic mmap threshold and stay in the arenas. No-op off glibc."""
    try:
        import ctypes

        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):
        pass


def _diag(served: int) -> None:
    """PMPU_SERVE_DIAG=1: log the live torch tensors (found by ``gc``), the
    CUDA allocator's bytes and the RSS after each served batch. A growing
    tensor count means Python keeps tensors; a flat count with a growing
    RSS points below Python (allocator, CUDA runtime, glibc)."""
    import gc

    import torch

    gc.collect()
    live = [o for o in gc.get_objects() if isinstance(o, torch.Tensor)]
    n_bytes = sum(t.numel() * t.element_size() for t in live)
    cuda_mb = torch.cuda.memory_allocated() / 1e6 if torch.cuda.is_initialized() else 0.0
    logging.info("diag: served=%d live_tensors=%d live_mb=%.1f cuda_allocated_mb=%.1f "
                 "rss_mb=%.1f", served, len(live), n_bytes / 1e6, cuda_mb, rss_mb())


def main(argv=None) -> int:
    # a --rss-limit-mb re-exec blocks SIGINT across the execv, so that an
    # operator interrupt cannot kill the new interpreter while it imports;
    # unblock here, where a pending interrupt raises into the clean exit
    signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGINT})
    logging.basicConfig(level=logging.INFO, format="%(levelname)s: %(message)s")
    argv = sys.argv[1:] if argv is None else list(argv)
    args = get_args(argv)
    from pmpu_tpu_torch.device import resolve_device
    from pmpu_tpu_torch.inference.engine import VolumeEvaluator
    from pmpu_tpu_torch.train.tasks import make_task

    device = resolve_device(args.device)
    if args.compile_cache:
        logging.info("--compile-cache %s ignored: PyTorch runs eagerly, there is no "
                     "compilation cache", args.compile_cache)
    cfg = Config(net=args.net, n_classes=args.n_classes, load=args.load,
                 num_filters=args.num_filters,
                 eval_samples=args.eval_samples, eval_batch=args.eval_batch,
                 num_views=args.num_views, seed=args.seed, bf16=args.bf16)
    if args.load:
        from pmpu_tpu_torch.train.checkpoint import load_for_inference

        task, cfg = load_for_inference(args.load, cfg, device=device)
    else:
        logging.warning("no checkpoint: serving an untrained model")
        task = make_task(cfg.net, **cfg.task_kwargs(), device=device, seed=cfg.seed)

    ev = VolumeEvaluator(
        task,
        n_samples=cfg.eval_samples if cfg.net == "probunet" else 1,
        eval_batch=cfg.eval_batch,
        num_views=cfg.num_views,
        quantize=args.quantize,
        calibration=args.calibration,
        input_dtype=args.input_dtype,
        device=device,
    )
    os.makedirs(args.out, exist_ok=True)
    if args.uncertainty:
        os.makedirs(args.uncertainty, exist_ok=True)

    # exports on a writer thread overlap the next scan and inference; the
    # context drains them on exit (Ctrl-C included) and re-raises the first
    # write error without masking an exception in flight
    with nifti.AsyncWriter() as writer:
        logging.info("serving %s → %s (poll %.1fs, %s)", args.watch, args.out, args.poll,
                     device)
        try:
            rc = _serve_loop(args, argv, cfg, ev, writer)
        except KeyboardInterrupt:
            logging.info("interrupted — draining pending exports and exiting")
            rc = 0
    return rc


def _serve_loop(args, argv, cfg, ev, writer) -> int:
    from concurrent.futures import ThreadPoolExecutor

    from pmpu_tpu_torch.inference.engine import derive_seed

    cube = args.cube
    seen: set = set()
    sizes: dict = {}
    served = 0
    fails: dict = {}  # name → failed-load count (quarantine at 3)
    quarantined: dict = {}  # name → size when quarantined (-1 = unknown)
    rejected = 0  # oversize rejections (counted into --once's exit code)
    # one pool for the daemon's lifetime: a pool a poll starts new threads,
    # each with its own glibc malloc arena, and RSS creeps with the arenas
    load_pool = ThreadPoolExecutor(max_workers=8)

    skipped = [n for n in filter(nifti.is_nifti_name, os.listdir(args.watch))
               if _served_and_current(args, n)]
    if skipped:
        seen.update(skipped)
        logging.info("skipping %d already-served input(s) with current outputs", len(skipped))

    def _quarantine(n):
        seen.add(n)
        try:
            quarantined[n] = os.path.getsize(os.path.join(args.watch, n))
        except OSError:
            # vanished between the failure and this stat: any size a file
            # under this name reappears with differs from -1
            quarantined[n] = -1

    def _fail(n, e):
        # a retry covers an upload still being flushed that the size check
        # missed; a file that fails three times is corrupt or stalled
        fails[n] = fails.get(n, 0) + 1
        if fails[n] >= 3:
            logging.error("quarantining %s after %d failed loads: %s", n, fails[n], e)
            _quarantine(n)
        else:
            logging.warning("skipping %s (attempt %d): %s", n, fails[n], e)

    def _reject_oversize(n, shape):
        # final for this file's content (no retry), but through the same
        # self-healing map: a corrected file of another size is re-inspected
        nonlocal rejected
        logging.error("%s shape %s exceeds cube %d; rejected", n, shape, cube)
        fails.pop(n, None)
        rejected += 1
        _quarantine(n)

    try:
        while True:
            if args.once:  # one scan: everything already on disk is stable
                ready = [n for n in sorted(filter(nifti.is_nifti_name, os.listdir(args.watch)))
                         if n not in seen]
            else:
                # self-healing quarantine: a file whose size changed since
                # it was quarantined (an upload resumed) is inspected again
                for n, qsz in list(quarantined.items()):
                    try:
                        sz = os.path.getsize(os.path.join(args.watch, n))
                    except OSError:
                        continue  # vanished; _stable_new_files forgets it
                    if sz != qsz:
                        logging.info("%s grew after quarantine; re-inspecting", n)
                        del quarantined[n]
                        fails.pop(n, None)
                        seen.discard(n)
                ready = _stable_new_files(args.watch, seen, sizes)
            if ready:
                # header preflight: corrupt and oversize files are turned
                # away from the 348-byte header, before any payload is read
                accepted, geoms = [], {}
                for n in ready:
                    try:
                        hdr = nifti.read_header(os.path.join(args.watch, n))
                        shape = hdr.shape
                        geoms[n] = geom_from_header(hdr, n)
                    except Exception as e:  # any unreadable header counts as a failure
                        _fail(n, e)
                        continue
                    # with --cube 0 the oversize check waits for a volume
                    # that loads: a torn first upload must not fix the cube
                    if cube and max(shape) > cube:
                        _reject_oversize(n, shape)
                        continue
                    accepted.append(n)
                loaded = list(load_pool.map(
                    lambda n: _try_load(os.path.join(args.watch, n)), accepted))
                vols, names = [], []
                for n, v in zip(accepted, loaded):
                    if isinstance(v, Exception):
                        _fail(n, v)
                        continue
                    if cube == 0:
                        cube = int(max(v.shape))
                        logging.info("program cube fixed at %d from %s", cube, n)
                    if max(v.shape) > cube:
                        # only in the first batch of --cube 0, where the
                        # preflight had no cube to check against
                        _reject_oversize(n, v.shape)
                        continue
                    vols.append(pad_to_cube(v, cube))
                    names.append(n)
                    seen.add(n)
                if vols:
                    t0 = time.perf_counter()
                    outs = ev.predict_volumes_pipelined(
                        vols, seed=derive_seed(cfg.seed, served),
                        pipeline_depth=args.pipeline_depth,
                        want_entropy=bool(args.uncertainty),
                    )
                    dt = time.perf_counter() - t0
                    del vols
                    for n, out in zip(names, outs):
                        seg, ent = out if args.uncertainty else (out, None)
                        writer.save(os.path.join(args.out, n),
                                    *restore_geometry(seg, geoms.get(n), args.identity_affine))
                        if ent is not None:
                            writer.save(os.path.join(args.uncertainty, n),
                                        *restore_geometry(ent, geoms.get(n),
                                                          args.identity_affine))
                    served += len(names)
                    logging.info("served %d volumes in %.2fs (%.2f s/volume, %d total)",
                                 len(names), dt, dt / len(names), served)
                    _malloc_trim()
                    if os.environ.get("PMPU_SERVE_DIAG"):
                        _diag(served)
                    if args.rss_limit_mb and rss_mb() > args.rss_limit_mb:
                        _reexec(argv, served, args.rss_limit_mb, writer)
            if args.once:
                # the batch contract: non-zero when any volume failed to load
                # or was rejected, so a caller sees partial results
                return 1 if (fails or rejected) else 0
            time.sleep(args.poll)
    finally:
        load_pool.shutdown(wait=False)


def _reexec(argv, served: int, limit_mb: float, writer) -> None:
    """Replace this process by a fresh ``python -m pmpu_tpu_torch.serve``
    with the same arguments. No device work is in flight (the batch is
    fetched); the pending exports are drained first, and SIGINT stays
    pending (blocked) until the new process's ``main`` unblocks it."""
    cmd = [sys.executable, "-m", "pmpu_tpu_torch.serve", *argv]
    logging.warning("rss %.0f MB exceeds --rss-limit-mb %.0f after %d served; re-exec: %s",
                    rss_mb(), limit_mb, served, " ".join(cmd))
    writer.close()
    sys.stdout.flush()
    sys.stderr.flush()
    signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGINT})
    os.execv(sys.executable, cmd)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except KeyboardInterrupt:
        # SIGINT is a clean shutdown in any phase, also while a re-executed
        # daemon imports, before _serve_loop's handler is installed
        sys.exit(0)

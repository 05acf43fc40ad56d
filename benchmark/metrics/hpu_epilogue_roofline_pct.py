"""The HPU-Net's residual-block epilogue kernels' share of their roofline, in
%: the least time of the volumes' epilogues ÷ the device time of the
kernels' launches (names holding ``hpu_epilogue``) in the traced window's
``model`` spans. The least time is bytes at the memory bandwidth, counted
from the configuration's shapes alone, in the compute dtype: at each level
of h×h maps, each block's ``convs_per_block`` − 1 outputs of the down width
read and written once (bias and ReLU in place), and its 1×1 output of the
level's width read, the skip (the block's input or its skip conv's output)
read and the sum written, with the sum's ReLU written too on all but the
level's last block; the encoder once a slice, the latent and stitching
decoders once a draw. Nothing where the program has no such kernel."""

from benchmark.flops import PEAKS, slices_per_volume
from benchmark.flops_hpunet import level_sizes

DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def level_elements(h: int, c: int, d: int, blocks: int, convs: int) -> int:
    """Elements the epilogues of one level's blocks read and write on one
    h×h map."""
    in_place = 2 * (convs - 1) * blocks * d
    residual = (3 * blocks + blocks - 1) * c
    return h * h * (in_place + residual)


def volume_bytes(cfg: dict) -> float:
    """Least bytes of the epilogues of one volume."""
    ch = cfg["channels_per_block"]
    down = cfg.get("down_channels_per_block") or [c // 2 for c in ch]
    n_lev, n_lat = len(ch), len(cfg["latent_dims"])
    sizes = level_sizes(cfg["cube"], n_lev)

    def level(e):
        return level_elements(sizes[e], ch[e], down[e], cfg["blocks_per_level"],
                              cfg["convs_per_block"])

    encoder = sum(level(e) for e in range(n_lev))
    decoders = sum(level(e) for e in range(n_lev - 1 - n_lat, n_lev - 1))
    decoders += sum(level(e) for e in range(n_lev - 2 - n_lat, -1, -1))
    per_slice = encoder + cfg["prior_samples"] * decoders
    return DTYPE_BYTES[cfg["dtype"]] * slices_per_volume(cfg) * per_slice


def read(r):
    spent = r.trace.span_device_s("model", "hpu_epilogue")
    n = r.trace.span_counts.get("model", 0)
    if not n or spent <= 0:
        return None
    return 100.0 * n * volume_bytes(r.config) / PEAKS["hbm_bytes"] / spent

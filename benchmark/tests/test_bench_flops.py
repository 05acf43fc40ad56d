"""The counts of operations and bytes, from shapes alone, against the
records of the kernels' bounds at 128³ (PERF.md's kernel table)."""

import pytest

from benchmark import flops

CFG128 = dict(cube=128, num_filters=[64, 128, 256, 512, 1024], input_channels=1,
              latent_dim=6, num_classes=3, prior_samples=5, no_convs_fcomb=4, views=3)


def test_fcomb_chunk_of_128_slices():
    assert flops.fcomb_flops(128, 128 * 128, 64, 64, 3, 5, 4) == pytest.approx(1.93e11, rel=1e-3)
    assert flops.fcomb_bytes(128, 128 * 128, 64, 3) == pytest.approx(294e6, rel=2e-3)


@pytest.mark.parametrize("planes,mb", [(384, 50.3), (768, 100.7)])
def test_gather_bytes(planes, mb):
    assert flops.gather_bytes(planes, 128 * 128) == pytest.approx(mb * 1e6, rel=1e-3)


def test_gather_training_batch_with_labels():
    assert flops.gather_bytes(128, 128 * 128, labels=True) == pytest.approx(33.6e6, rel=2e-3)


def test_oblique_six_views():
    assert flops.oblique_bytes(128, 6) == pytest.approx(58.7e6, rel=1e-3)
    assert flops.oblique_flops(128, 6) == pytest.approx(7.05e8, rel=1e-3)


def test_train_step_and_volume():
    # the bf16 step at batch 128 of 128² slices: 1.590e13 FLOPs (FlopCounterMode, PR 12)
    assert flops.train_step_flops(CFG128, 128) == pytest.approx(1.590e13, rel=2e-3)
    assert flops.volume_flops(CFG128) == pytest.approx(1.307e13, rel=1e-3)
    six = dict(CFG128, views=6)
    assert flops.volume_flops(six) == pytest.approx(2 * flops.volume_flops(CFG128))


def test_least_seconds_takes_the_longer_bound():
    assert flops.least_seconds(989e12, 0.0, flops.PEAKS["bf16_flops"]) == pytest.approx(1.0)
    assert flops.least_seconds(0.0, 3.35e12, flops.PEAKS["bf16_flops"]) == pytest.approx(1.0)

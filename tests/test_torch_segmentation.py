"""The segmentation cohort builder: ``mmnn_sts_torch.data.images.
build_segmentation_cohort`` held bit for bit against the JAX package's
(data/images.py:436-463) on the tiny cohort of the JAX package's own
test (tests/test_streaming.py:59-69), at that test's size and at an
anisotropic one."""

import numpy as np
import pytest

from fixtures import make_full_cohort
from mmnn_sts_tpu.data.images import (
    build_segmentation_cohort as jax_build_segmentation_cohort)
from mmnn_sts_torch.data.images import build_segmentation_cohort


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    return make_full_cohort(str(tmp_path_factory.mktemp("seg")), n=4)


@pytest.mark.parametrize("size", [(10, 10, 10), (12, 8, 6)])
def test_segmentation_cohort_matches_jax_bit_for_bit(cohort, size):
    paths, _ = cohort
    imgs, masks = build_segmentation_cohort(paths["t1"], paths["key"],
                                            spatial_size=size)
    want_imgs, want_masks = jax_build_segmentation_cohort(
        paths["t1"], paths["key"], spatial_size=size)
    assert imgs.volumes.shape == masks.volumes.shape == (4,) + size + (1,)
    assert imgs.volumes.dtype == masks.volumes.dtype == np.float32
    assert set(np.unique(masks.volumes)) <= {0.0, 1.0}
    np.testing.assert_array_equal(imgs.uids, masks.uids)
    for got, want in ((imgs, want_imgs), (masks, want_masks)):
        np.testing.assert_array_equal(got.uids, want.uids)
        np.testing.assert_array_equal(got.volumes, want.volumes)

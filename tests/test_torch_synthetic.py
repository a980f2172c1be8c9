"""The port's ``utils/synthetic.make_targets`` gives the JAX package's clip GT, bit for
bit, for the clip lengths, point counts and instance counts its callers use."""

import numpy as np
import pytest


@pytest.mark.parametrize("T,npts,n_gt", [(3, 5, 2), (6, 25, 4), (1, 16, 1)])
def test_make_targets_equals_jax(T, npts, n_gt):
    from gomatching_tpu.utils.synthetic import make_targets as jax_make
    from gomatching_tpu_torch.utils.synthetic import make_targets

    got, want = make_targets(T, npts, n_gt), jax_make(T, npts, n_gt)
    assert sorted(got) == sorted(want) == ["gt_boxes", "gt_ctrl", "gt_ids"]
    for k in want:
        assert len(got[k]) == len(want[k]) == T
        for a, b in zip(got[k], want[k]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b, err_msg=k)
    boxes = np.stack(got["gt_boxes"])
    assert (boxes[..., 2:] > boxes[..., :2]).all()

"""smpltpu_torch body model and output helpers against the JAX package on
the CPU in float64: rodrigues (Taylor branch included), the SMPL forward,
write-back, the pixel metric and the camera heuristic. Tolerance 1e-10:
the same formulas, so the gap is summation order (~1e-15 relative on
metre-scale vertices and O(100) px errors)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smpltpu.constants import N_KP_SLOTS, USE_SMPL, init_root_rotation
from smpltpu.models import SMPLModel as JModel
from smpltpu.models import rodrigues as j_rodrigues
from smpltpu.models import smpl_forward as j_forward
from smpltpu.models.smpl import tree_levels as j_tree_levels
from smpltpu.utils import default_intrinsics as j_intrinsics
from smpltpu.utils import mean_pixel_error as j_mpe
from smpltpu.utils.writeback import params_to_pose as j_params_to_pose
from smpltpu_torch.models import SMPLModel, rodrigues, smpl_forward
from smpltpu_torch.models.smpl import tree_levels
from smpltpu_torch.utils import (
    default_intrinsics,
    mean_pixel_error,
    params_to_pose,
)

F64 = torch.float64
CPU = torch.device("cpu")
ATOL = 1e-10


@pytest.fixture(scope="module")
def models(small_model_dict):
    return (SMPLModel.from_dict(small_model_dict, device=CPU, dtype=F64),
            JModel.from_dict(small_model_dict, dtype=jnp.float64))


def test_rodrigues_matches_jax_including_small_angles():
    rng = np.random.default_rng(0)
    aa = np.concatenate([rng.normal(size=(8, 3)),
                         1e-7 * rng.normal(size=(3, 3)),     # theta^2 < 1e-12
                         np.zeros((1, 3))])
    got = rodrigues(torch.as_tensor(aa)).numpy()
    want = np.asarray(j_rodrigues(jnp.asarray(aa)))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got[-1], np.eye(3), rtol=0, atol=0)


@pytest.mark.parametrize("use_posedirs", [False, True])
def test_smpl_forward_matches_jax(models, use_posedirs):
    tm, jm = models
    rng = np.random.default_rng(1)
    shape = 0.4 * rng.normal(size=(3, 10))
    rots = np.array(j_rodrigues(jnp.asarray(0.3 * rng.normal(size=(3, 24, 3)))))
    pos = rng.normal(size=(3, 3)) + [0.0, 0.0, 3.0]
    got = smpl_forward(tm, torch.as_tensor(shape), torch.as_tensor(rots),
                       torch.as_tensor(pos), use_posedirs=use_posedirs)
    want = jax.vmap(lambda w, r, p: j_forward(
        jm, w, r, p, use_posedirs=use_posedirs))(
            jnp.asarray(shape), jnp.asarray(rots), jnp.asarray(pos))
    for k in ("joints", "verts"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=ATOL)


def test_from_jax_carries_every_field(models, small_model_dict):
    tm, jm = models
    carried = SMPLModel.from_jax(jm, device=CPU, dtype=F64)
    for name, buf in tm.named_buffers():
        np.testing.assert_array_equal(getattr(carried, name).numpy(), buf.numpy())
    np.testing.assert_array_equal(carried.faces, tm.faces)
    np.testing.assert_array_equal(carried.parents, tm.parents)
    assert [list(a) for a in tree_levels(tm.parents)] == \
        [list(a) for a in j_tree_levels(np.asarray(jm.parents))]


def test_writeback_metric_and_camera_match_jax(models):
    tm, jm = models
    rng = np.random.default_rng(2)
    n = 5
    params = np.zeros((n, 76))
    params[:, 0] = 1.2            # scale: discarded by the write-back
    params[:, 1:4] = 0.1 * rng.normal(size=(n, 3))
    params[:, 4:7] = [0.1, -0.1, 3.0]
    params[:, 7:] = 0.2 * rng.normal(size=(n, 69))
    r0 = np.tile(init_root_rotation(), (n, 1, 1))
    pose = params_to_pose(torch.as_tensor(params), torch.as_tensor(r0), 24)
    jpose = jax.vmap(lambda p, r: j_params_to_pose(p, r, 24))(
        jnp.asarray(params), jnp.asarray(r0))
    for got, want in zip(pose, jpose):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)

    cam = default_intrinsics(720, 1280, device=CPU, dtype=F64)
    jcam = j_intrinsics(720, 1280, dtype=jnp.float64)
    np.testing.assert_array_equal([float(c) for c in cam],
                                  [float(c) for c in jcam])

    joints = 0.3 * rng.normal(size=(n, 24, 3)) + [0.0, 0.0, 3.0]
    kp = np.zeros((n, N_KP_SLOTS, 4))
    kp[:, :, 0] = USE_SMPL
    kp[:, :, 1:3] = rng.uniform(0, 700, size=(n, N_KP_SLOTS, 2))
    kp[:, :, 3] = 1.0
    kp[1, :4, 3] = 0.0
    kp[3, :, 3] = 0.0                                   # no valid slot -> 0
    got = mean_pixel_error(torch.as_tensor(joints), torch.as_tensor(kp), cam)
    want = jax.vmap(lambda j, k: j_mpe(j, k, jcam))(jnp.asarray(joints),
                                                    jnp.asarray(kp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)
    assert float(got[3]) == 0.0

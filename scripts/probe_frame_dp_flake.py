"""Why ``tests/test_parallel.py::test_sharded_frame_fit_matches_unsharded``
passes in one run of the suite and fails in another.

The test draws its data from the suite's session-scoped ``rng`` fixture
(``tests/conftest.py``: ``np.random.default_rng(42)``, one generator for a
whole worker process). Under ``pytest -n 6 --dist loadfile`` the files a
worker runs before ``tests/test_parallel.py`` vary from run to run, and
each of them draws from the same generator, so the test sees other data.
This script runs the test's body on the generator advanced by several
amounts (as earlier tests would leave it) and prints, for each, the
largest relative cost gap and the parameter gap over the test's limit
(``x_over_limit`` > 1 fails), and whether the unsharded fit repeats bit
for bit:

    JAX_PLATFORMS=cpu python scripts/probe_frame_dp_flake.py [skip ...]

Run it twice, the second time with ``tests/.xla_cache`` removed, and
under ``taskset -c 0``: for a given skip the numbers do not change.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import tests.conftest  # noqa: E402,F401  (the suite's JAX settings)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from smpltpu.constants import N_KP_SLOTS, USE_SMPL, init_root_rotation  # noqa: E402
from smpltpu.energy import skeleton_joints_cam  # noqa: E402
from smpltpu.energy.params import init_frame_params  # noqa: E402
from smpltpu.energy.reproj import project  # noqa: E402
from smpltpu.models import SMPLModel  # noqa: E402
from smpltpu.models.synthetic import make_synthetic_model  # noqa: E402
from smpltpu.parallel import frames_mesh  # noqa: E402
from smpltpu.parallel.sharded import sharded_frame_fit  # noqa: E402
from smpltpu.solve import build_fitter, make_single_frame_problem  # noqa: E402
from smpltpu.utils import default_intrinsics  # noqa: E402


def main(skips):
    model = SMPLModel.from_dict(make_synthetic_model(n_verts=300, n_shapes=10,
                                                     seed=0),
                                dtype=jnp.float64)
    cam = default_intrinsics(720, 1280, dtype=jnp.float64)
    f = 8
    prob = make_single_frame_problem(model, init_root_rotation(), cam,
                                     beta_pose=2.0, dtype=jnp.float64)
    fitter = build_fitter(prob, max_iters=120, dtype=jnp.float64)
    mesh = frames_mesh(8)
    for skip in skips:
        rng = np.random.default_rng(42)
        rng.normal(size=skip)     # what earlier tests drew
        gt = jnp.tile(init_frame_params(dtype=jnp.float64), (f, 1))
        gt = gt.at[:, 7:].add(0.1 * rng.normal(size=(f, 69)))
        uv = np.asarray(jax.vmap(lambda p: project(skeleton_joints_cam(
            p, jnp.zeros(10), prob.spec), cam))(gt))
        kp = np.zeros((f, N_KP_SLOTS, 4))
        kp[:, :, 0] = USE_SMPL
        kp[:, :, 1:3] = uv[:, USE_SMPL] + rng.normal(size=(f, N_KP_SLOTS, 2))
        kp[:, :, 3] = 1.0
        x0 = gt + 0.03 * jnp.asarray(rng.normal(size=gt.shape))
        ref = fitter(x0, jnp.asarray(kp))
        st = sharded_frame_fit(mesh, fitter, x0, jnp.asarray(kp))
        again = fitter(x0, jnp.asarray(kp))
        c, c_ref = np.asarray(st.cost), np.asarray(ref.cost)
        x, x_ref = np.asarray(st.x), np.asarray(ref.x)
        print(json.dumps({
            "skip": skip,
            "cost_rel_max": float((np.abs(c - c_ref) / np.abs(c_ref)).max()),
            "x_over_limit": float((np.abs(x - x_ref)
                                   / (2e-3 + 2e-2 * np.abs(x_ref))).max()),
            "unsharded_repeats_bitwise": bool(np.array_equal(
                np.asarray(again.x), x_ref))}), flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [0, 1, 7, 13, 50, 101, 333,
                                             1000, 2024, 4096])

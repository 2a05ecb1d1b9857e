"""The port's ``parallel/`` against the JAX package's: ``pad_to_multiple``
and ``se3sync_full`` in this process; the sharded solvers, ``mesh=`` of
``bipartite_se3sync`` and of perception in two gloo ranks on the CPU,
spawned once for the module (tests/test_sharded.py's and
tests/test_distributed.py's problems and bars)."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from vican_tpu.parallel import sharded as JS
from vican_tpu.solver import core as JC
from vican_tpu.solver import pack_problem
from vican_tpu.synthetic import make_problem, make_problem_arrays
from vican_torch.parallel import sharded as TS
from vican_torch.solver import core as TCore
from vican_torch.solver.packing import pack_problem as tpack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the problem of tests/test_sharded.py and that of tests/test_distributed.py
SHARDED = dict(seed=11, n_cams=8, n_times=64, n_markers=6, kappa_r=1e5, sigma_t=1e-4)
DISTRIBUTED = dict(seed=41, n_cams=12, n_times=64, n_markers=6, n_edges=1200,
                   kappa_r=1e5, sigma_t=1e-4)
RANK_TIMEOUT_S = 300


def _one(e):
    return 1.0


def _all(e):
    return True


WORKER = r"""
import json, os, sys
import numpy as np
import torch

rank, store, render_root, out_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
sys.path.insert(0, __REPO__)
torch.set_num_threads(1)
from vican_torch import bipgo
from vican_torch.cam import Camera, estimate_pose_mp
from vican_torch.dataset import Dataset
from vican_torch.parallel import init_distributed, make_mesh
from vican_torch.parallel.sharded import se3sync_sharded, so3_sync_sharded
from vican_torch.solver import core
from vican_torch.solver.packing import pack_problem
from vican_torch.solver.scale import so3_sync_large_sharded, sort_edges_by_time
from vican_torch.synthetic import make_problem, make_problem_arrays

init_distributed(store, num_processes=2, process_id=rank, device="cpu")
init_distributed(store, num_processes=2, process_id=rank, device="cpu")  # a no-op
mesh = make_mesh(device="cpu")
one, every = (lambda e: 1.0), (lambda e: True)
out = {"world": mesh.size(), "dims": list(mesh.mesh_dim_names)}
try:
    make_mesh(n_devices=3, device="cpu")
except ValueError:
    out["n_devices_3_raises"] = True

prob = make_problem(**__SHARDED__)
p = pack_problem(prob.edges, prob.constraints(), one, one, every, dtype=np.float64)
t = lambda x: torch.as_tensor(np.asarray(x))
KR = core.fold_constraints(t(p.R_e), t(p.k_r), t(p.marker_idx).long(), t(p.R_con), p.root_idx)
res = so3_sync_sharded(KR.numpy(), p.k_r, p.cam_idx, p.time_idx, C=p.num_cams, T=p.num_times,
                       maxiter=4, mesh=mesh, dtype=np.float64, device="cpu")
out["so3_sharded"] = {"r_cam": res.r_cam.tolist(), "r_time": res.r_time.tolist()}
r_cam, r_time, t_est, cg = se3sync_sharded(p, maxiter=4, mesh=mesh, dtype=np.float64,
                                           device="cpu")
out["se3_sharded"] = {"r_cam": r_cam.tolist(), "t_est": t_est.tolist(), "res": cg,
                      "cam_ids": list(p.cam_ids)}

prob = make_problem_arrays(**__DISTRIBUTED__)
p = pack_problem(prob.edges, prob.constraints(), one, one, every, dtype=np.float64)
KR = core.fold_constraints(t(p.R_e), t(p.k_r), t(p.marker_idx).long(), t(p.R_con), p.root_idx)
chunked = sort_edges_by_time(KR.numpy(), p.k_r, p.cam_idx, p.time_idx, p.num_times, 8)
res = so3_sync_large_sharded(*chunked, C=p.num_cams, T=p.num_times, chunk_t=8, maxiter=4,
                             mesh=mesh, device="cpu")
out["large_sharded"] = {"r_cam": res.r_cam.tolist(), "r_time": res.r_time.tolist(),
                        "iters": res.num_iters}

os.environ["VICAN_TPU_SCALE_MIN_CAMS"] = "4"  # the large-graph route at 12 cameras
kw = dict(constraints=prob.constraints(), noise_model_r=one, noise_model_t=one,
          edge_filter=every, maxiter=4, dtype=np.float64, verbose=False, device="cpu")
sharded = bipgo.bipartite_se3sync(prob.edges, mesh=mesh, **kw)
single = bipgo.bipartite_se3sync(prob.edges, **kw)
out["bipgo"] = {k: [sharded[k].pose().tolist(), single[k].pose().tolist()] for k in single}
del os.environ["VICAN_TPU_SCALE_MIN_CAMS"]

ds = Dataset(render_root)
cams = [Camera(id=c.id, intrinsics=c.intrinsics, distortion=c.distortion,
               extrinsics=c.extrinsics, resolution_x=c.resolution_x,
               resolution_y=c.resolution_y) for c in ds.im_data["cam"]]
pkw = dict(aruco="DICT_4X4_1000", marker_size=0.138, corner_refine="CORNER_REFINE_APRILTAG",
           marker_ids=[str(i) for i in range(24)], flags="SOLVEPNP_IPPE_SQUARE",
           brightness=0, contrast=0, batch_size=3, verbose=False, device="cpu")
edges = {"mesh": estimate_pose_mp(ds.im_data["filename"], cams, mesh=mesh, **pkw),
         "single": estimate_pose_mp(ds.im_data["filename"], cams, **pkw)}
out["perception"] = {name: [[list(k), e["corners"].tolist(), e["pose"].t().tolist()]
                            for k, e in d.items()] for name, d in edges.items()}
with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
torch.distributed.destroy_process_group()
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results: two processes joined by gloo through a
    ``file://`` store, each under its own timeout."""
    pytest.importorskip("cv2")
    from vican_tpu.cam import Camera
    from vican_tpu.geometry import SE3, rodrigues
    from vican_tpu.render import look_at, make_cube_markers, render_dataset

    tmp = tmp_path_factory.mktemp("ranks")
    # tests/test_sharded.py::test_perception_mesh_matches_single's scene
    rng = np.random.default_rng(5)
    K = np.array([[400.0, 0, 256], [0, 400.0, 144], [0, 0, 1]])
    cams = {str(i): Camera(id=str(i), intrinsics=K, distortion=np.zeros(12),
                           extrinsics=look_at(p, (0, 0, 1.0)), resolution_x=512,
                           resolution_y=288)
            for i, p in enumerate([(1.8, 0, 1.1), (0, 1.8, 1.2)])}
    traj = {}
    for t in range(4):
        v = rng.normal(size=3)
        v = v / np.linalg.norm(v) * rng.uniform(0, np.pi)
        traj[str(t)] = SE3(R=rodrigues(v), t=np.array([0.0, 0.0, 1.0]))
    root = str(tmp / "ds")
    render_dataset(root, cams, traj, make_cube_markers(), marker_size=0.138, marker_px=120)
    script = tmp / "worker.py"
    script.write_text(WORKER.replace("__REPO__", repr(REPO))
                      .replace("__SHARDED__", repr(SHARDED))
                      .replace("__DISTRIBUTED__", repr(DISTRIBUTED)))
    store = f"file://{tmp / 'store'}"
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = [subprocess.Popen([sys.executable, str(script), str(r), store, root, str(tmp)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    logs = []
    try:
        for pr in procs:
            logs.append(pr.communicate(timeout=RANK_TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.communicate()
    for pr, log in zip(procs, logs):
        assert pr.returncode == 0, log[-3000:]
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]


@pytest.fixture(scope="module")
def sharded_problem():
    prob = make_problem(**SHARDED)
    return prob, tpack(prob.edges, prob.constraints(), _one, _one, _all, dtype=np.float64)


def test_pad_to_multiple_matches_jax():
    rng = np.random.default_rng(0)
    for shape, mult, axis, fill in [((7, 3), 4, 0, 0), ((5, 2, 3), 3, 1, -1.5),
                                    ((8,), 4, 0, 0), ((0, 2), 3, 0, 7)]:
        a = rng.normal(size=shape)
        out, ref = TS.pad_to_multiple(a, mult, axis, fill), JS.pad_to_multiple(a, mult, axis, fill)
        assert out.shape == ref.shape
        np.testing.assert_array_equal(out, ref)


def test_se3sync_full_matches_jax(sharded_problem):
    """The port's fused composite against JAX's on the same packed problem
    (float64): rotations within 1e-8, translations within the CG tolerance
    of tests/test_sharded.py (1e-3 m)."""
    import jax.numpy as jnp

    prob, p = sharded_problem
    jp = pack_problem(prob.edges, prob.constraints(), _one, _one, _all, dtype=np.float64)
    j = lambda x: jnp.asarray(np.asarray(x))
    jres, jposes, jcg = JC.se3sync_full(
        j(jp.R_e), j(jp.t_e), j(jp.k_r), j(jp.k_t), j(jp.cam_idx), j(jp.time_idx),
        j(jp.marker_idx), j(jp.R_con), j(jp.t_con), root_idx=jp.root_idx, C=jp.num_cams,
        T=jp.num_times, maxiter=jnp.asarray(4, jnp.int32))
    t = lambda x: torch.as_tensor(np.asarray(x))
    res, poses, cg = TCore.se3sync_full(
        t(p.R_e), t(p.t_e), t(p.k_r), t(p.k_t), t(p.cam_idx).long(), t(p.time_idx).long(),
        t(p.marker_idx).long(), t(p.R_con), t(p.t_con), root_idx=p.root_idx, C=p.num_cams,
        T=p.num_times, maxiter=4)
    assert poses.shape == (p.num_cams + p.num_times, 4, 4)
    assert res.num_iters == int(jres.num_iters)
    np.testing.assert_allclose(poses[:, :3, :3].numpy(), np.asarray(jposes)[:, :3, :3],
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(poses[:, :3, 3].numpy(), np.asarray(jposes)[:, :3, 3],
                               rtol=0, atol=1e-3)
    np.testing.assert_array_equal(poses[:, 3].numpy(), np.asarray(jposes)[:, 3])
    assert float(cg) < 1e-3 and float(jcg) < 1e-3


def test_ranks_formed_one_mesh(ranks):
    """Both ranks hold one 1-D ``"edges"`` mesh of two ranks; a second
    ``init_distributed`` is a no-op and a mesh of another size raises."""
    for r in ranks:
        assert (r["world"], r["dims"], r.get("n_devices_3_raises")) == (2, ["edges"], True)


def test_so3_sync_sharded_matches_port_single(ranks, sharded_problem):
    """tests/test_sharded.py:44-45's bar: atol 1e-8 in float64."""
    _, p = sharded_problem
    t = lambda x: torch.as_tensor(np.asarray(x))
    KR = TCore.fold_constraints(t(p.R_e), t(p.k_r), t(p.marker_idx).long(), t(p.R_con),
                                p.root_idx)
    single = TCore.so3_sync(KR, t(p.k_r), t(p.cam_idx).long(), t(p.time_idx).long(),
                            C=p.num_cams, T=p.num_times, maxiter=4)
    for r in ranks:
        np.testing.assert_allclose(np.asarray(r["so3_sharded"]["r_cam"]), single.r_cam.numpy(),
                                   rtol=0, atol=1e-8)
        np.testing.assert_allclose(np.asarray(r["so3_sharded"]["r_time"]),
                                   single.r_time.numpy(), rtol=0, atol=1e-8)


def test_se3sync_sharded_matches_bipartite_se3sync(ranks, sharded_problem):
    """tests/test_sharded.py:55-61's bars: rotations 1e-6, translations
    1e-3 m, CG residual below 1e-3."""
    from vican_torch import bipgo

    prob, _ = sharded_problem
    est = bipgo.bipartite_se3sync(prob.edges, constraints=prob.constraints(),
                                  noise_model_r=_one, noise_model_t=_one, edge_filter=_all,
                                  maxiter=4, dtype=np.float64, verbose=False, device="cpu")
    for r in ranks:
        s = r["se3_sharded"]
        assert s["res"] < 1e-3
        for i, c in enumerate(s["cam_ids"]):
            np.testing.assert_allclose(np.asarray(s["r_cam"][i]), est[c].R(), rtol=0, atol=1e-6)
            np.testing.assert_allclose(np.asarray(s["t_est"][i]), est[c].t(), rtol=0, atol=1e-3)


def test_so3_sync_large_sharded_matches_jax(ranks):
    """Against JAX's so3_sync_large_sharded on the 8 virtual devices, on
    tests/test_distributed.py's problem: below 1e-4 degrees (float64)."""
    import jax.numpy as jnp

    from vican_tpu.ops.lie import distance_so3
    from vican_tpu.parallel import make_mesh
    from vican_tpu.solver.scale import so3_sync_large_sharded, sort_edges_by_time

    prob = make_problem_arrays(**DISTRIBUTED)
    p = pack_problem(prob.edges, prob.constraints(), _one, _one, _all, dtype=np.float64)
    KR = np.asarray(JC.fold_constraints(jnp.asarray(p.R_e), jnp.asarray(p.k_r),
                                        jnp.asarray(p.marker_idx), jnp.asarray(p.R_con),
                                        p.root_idx))
    chunked = sort_edges_by_time(KR, p.k_r, p.cam_idx, p.time_idx, p.num_times, 8)
    ref = so3_sync_large_sharded(*chunked, C=p.num_cams, T=p.num_times, chunk_t=8,
                                 maxiter=4, mesh=make_mesh())
    for r in ranks:
        out = r["large_sharded"]
        assert out["iters"] == int(ref.num_iters)
        for mine, theirs in (("r_cam", ref.r_cam), ("r_time", ref.r_time)):
            d = np.asarray(distance_so3(np.asarray(out[mine]), np.asarray(theirs)))
            assert d.max() < 1e-4, (mine, d.max())


def test_bipartite_se3sync_mesh_matches_single(ranks):
    """The large-graph route sharded over the two ranks against one rank's
    solve without a mesh, in the same process: the psum order only."""
    for r in ranks:
        for k, (sharded, single) in r["bipgo"].items():
            np.testing.assert_allclose(np.asarray(sharded), np.asarray(single), rtol=0,
                                       atol=1e-6, err_msg=k)


def test_estimate_pose_mp_mesh_matches_single(ranks):
    """tests/test_sharded.py:105-108's bars: the same keys, corners within
    1e-4, translations within 1e-5; the whole dict on both ranks, in the
    single run's order."""
    for r in ranks:
        mesh, single = r["perception"]["mesh"], r["perception"]["single"]
        assert len(single) >= 8
        assert [k for k, _, _ in mesh] == [k for k, _, _ in single]
        for (_, c1, t1), (_, c2, t2) in zip(mesh, single):
            np.testing.assert_allclose(c1, c2, rtol=0, atol=1e-4)
            np.testing.assert_allclose(t1, t2, rtol=0, atol=1e-5)


def test_ranks_returned_the_same_results(ranks):
    a, b = ranks
    assert a == b

"""Tests of the port that need a CUDA card (marker ``gpu``; they skip
without one).  The file imports neither JAX nor the JAX package, so it runs
on a machine with the card and PyTorch alone:

    python3 -m pytest --noconftest -m gpu tests/test_torch_gpu.py

(``--noconftest``: tests/conftest.py configures JAX for the rest of the
suite).  Whether a card is present is decided inside the fixture, so every
pytest worker collects the same tests.
"""
import numpy as np
import pytest
import torch

from torch_bars import (CELLS, CUBE_KW, MV_REL_TOL, P_KW, PNP_MARKER, PNP_MEDIAN_TOL,
                        PNP_TOL, PWR_REL_TOL, detect_gaps, detect_ok, filter_problem,
                        p_first_batch, p_frames, pnp_gaps, pnp_slots, rendered_640,
                        thin_mv_cases)
from vican_torch import bipgo, render
from vican_torch.cam import Camera
from vican_torch.geometry import distance_SO3
from vican_torch.ops.pnp import pnp_block, pnp_block_plain
from vican_torch.ops.threshold import multi_threshold, multi_threshold_plain
from vican_torch.perception import estimate_pose_gray
from vican_torch.solver.mv import aligned_bf16, thin_mv, thin_mv_plain
from vican_torch.solver.pwr import filter_operator, pwr_apply, pwr_apply_plain, pwr_plan
from vican_torch.solver.tiles import single_plan
from vican_torch.synthetic import make_problem_arrays
from vican_torch.utils import PhaseTimer


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("design", ["single", "two"])
@pytest.mark.parametrize("n,T,w", [
    (48, 70, 5), (64, 64, 1), (48, 33, 10), (128, 32, 7), (21, 10, 16),
    (3000, 1000, 10), (3000, 1000, 1),
    # both sides of each cluster size of the single read (tiles.single_plan:
    # 1920 columns a CTA, clusters of 1, 2, 4, 8, 16), n and T not multiples
    # of 16
    (1920, 17, 10), (1921, 17, 3), (3840, 9, 16), (3841, 9, 10), (7680, 5, 10),
    (7681, 5, 1), (15360, 3, 10), (15361, 3, 16), (30720, 2, 10),
    # past the single read: the two reads only
    (30721, 2, 10), (30722, 11, 16),
])
def test_cuda_kernel_matches_plain(cuda, n, T, w, design):
    rng = np.random.default_rng(3)
    B = torch.from_numpy(rng.standard_normal((n, 3 * T)).astype(np.float32)).to(cuda)
    lbd = torch.from_numpy(rng.standard_normal((T, 3, 3)).astype(np.float32)).to(cuda)
    X = torch.from_numpy(rng.standard_normal((n, w)).astype(np.float32)).to(cuda)
    Bt = filter_operator(B)
    picked = pwr_plan(n, T, w).design
    if design == "single" and single_plan(n, T) is None:
        assert picked == "two"
        with pytest.raises(ValueError):
            pwr_apply(Bt, lbd, X, design=design)
        return
    before = pwr_apply.launches
    out = pwr_apply(Bt, lbd, X, design=design)
    torch.cuda.synchronize()
    assert pwr_apply.launches == before + 1
    ref = pwr_apply_plain(Bt, lbd, X)
    assert out.shape == ref.shape == (n, w) and out.dtype == torch.float32
    err = ((out - ref).abs().max() / ref.abs().max()).item()
    # a float32 sum order other than cuBLAS's may flip the bf16 rounding of
    # single W entries (torch_bars.PWR_REL_TOL); a fault shows at O(1)
    assert err < PWR_REL_TOL, err
    # no atomics, partials summed in a fixed order: bit for bit again
    assert torch.equal(out, pwr_apply(Bt, lbd, X, design=design))
    if design == picked:
        assert torch.equal(out, pwr_apply(Bt, lbd, X))


@pytest.mark.gpu
def test_large_route_on_the_card_matches_cpu(cuda, monkeypatch):
    """bipartite_se3sync on the large-graph route: the card (kernel) and
    the CPU (plain version) agree, and the kernel was launched."""
    prob = make_problem_arrays(seed=13, n_cams=40, n_times=256, n_markers=8,
                               n_edges=6000, kappa_r=1e5, sigma_t=1e-4)
    monkeypatch.setenv("VICAN_TPU_SCALE_MIN_CAMS", "16")
    args = (prob.edges, prob.constraints(), lambda e: 1.0, lambda e: 1.0, lambda e: True)
    before = pwr_apply.launches
    gpu = bipgo.bipartite_se3sync(*args, maxiter=4, verbose=False)
    assert pwr_apply.launches > before
    cpu = bipgo.bipartite_se3sync(*args, maxiter=4, verbose=False, device="cpu")
    d_rot = max(distance_SO3(np.asarray(gpu[k].R(), np.float64),
                             np.asarray(cpu[k].R(), np.float64)) for k in cpu)
    d_tr = max(np.linalg.norm(gpu[k].t() - cpu[k].t()) for k in cpu)
    # the bars of tests/test_scale.py:205-206 (f32 variants on a noisy fixture)
    assert d_rot < 0.2, d_rot
    assert d_tr < 0.05, d_tr


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,w,aligned", [
    (1000, 2048, 10, True), (1000, 2048, 1, True), (999, 1003, 10, True),
    (333, 517, 16, False), (257, 4099, 128, True), (130, 77, 37, False),
    (513, 2050, 128, False), (200, 999, 200, True), (77, 130, 200, False),
])
def test_thin_mv_kernel_matches_plain(cuda, M, K, w, aligned):
    """The thin-matvec kernel against its plain version: aligned rows (the
    vector path) and rows at an odd stride (the entry-by-entry path), M and
    K not multiples of 8, w across the n8-tile widths, 128 columns and
    past them (two 128-column slices of the grid)."""
    rng = np.random.default_rng(M + K + w)
    A = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(cuda)
    B = aligned_bf16(A) if aligned else A.to(torch.bfloat16)
    assert (B.stride(0) % 8 == 0) == aligned
    X = torch.from_numpy(rng.standard_normal((K, w)).astype(np.float32)).to(cuda)
    before = thin_mv.launches
    out = thin_mv(B, X)
    torch.cuda.synchronize()
    assert thin_mv.launches == before + 1
    ref = thin_mv_plain(B, X)
    assert out.shape == ref.shape == (M, w) and out.dtype == torch.float32
    # the same exact products summed in another float32 order
    err = ((out - ref).abs().max() / ref.abs().max()).item()
    assert err < MV_REL_TOL, err
    assert torch.equal(out, thin_mv(B, X))  # no atomics: bit for bit again


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["B", "C"])
def test_pwr_kernel_at_a_cells_shape_matches_plain(cuda, cell):
    """``pwr_apply`` at a large-graph cell's whole shape over 10k timesteps
    (B: n = 30000, the single read with its largest clusters; C: n = 6144)
    on an operator built like the route's, w = 1, 10 and 16, in both
    designs: within PWR_REL_TOL of the plain version, bit for bit again."""
    Bt, lbd, n, T = filter_problem(cuda, CELLS[cell])
    g = torch.Generator(device=cuda).manual_seed(0)
    for w in (1, 10, 16):
        X, _ = torch.linalg.qr(torch.randn((n, w), generator=g, device=cuda))
        ref = pwr_apply_plain(Bt, lbd, X)
        for design in ("single", "two"):
            out = pwr_apply(Bt, lbd, X, design=design)
            err = ((out - ref).abs().max() / ref.abs().max()).item()
            assert err < PWR_REL_TOL and bool(torch.isfinite(out).all()), (w, design, err)
            assert torch.equal(out, pwr_apply(Bt, lbd, X, design=design))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["probe", "streaming w=10", "streaming w=1", "ragged"])
def test_thin_mv_kernel_at_full_size_matches_plain(cuda, case):
    """``thin_mv`` at the streaming regime's whole shape (a symmetric
    30000^2 operator: 3C at 10k cameras), a ragged 29999 x 30001 and the
    JAX package's probe (30208 x 31744, w = 128): within MV_REL_TOL of the
    plain version, bit for bit again."""
    (_, B, X), = thin_mv_cases(cuda, (case,))
    out, ref = thin_mv(B, X), thin_mv_plain(B, X)
    err = ((out - ref).abs().max() / ref.abs().max()).item()
    assert err < MV_REL_TOL and bool(torch.isfinite(out).all()), err
    assert torch.equal(out, thin_mv(B, X))


@pytest.mark.gpu
def test_streaming_regime_on_the_card_matches_cpu(cuda):
    """so3_sync_large past its operator budget (forced by
    ``materialize_budget=1``): the card (thin-matvec kernel) and the CPU
    (plain version) agree, and the kernel was launched."""
    from vican_torch.solver.core import fold_constraints
    from vican_torch.solver.packing import pack_problem
    from vican_torch.solver.scale import so3_sync_large, sort_edges_by_time

    prob = make_problem_arrays(seed=7, n_cams=24, n_times=96, n_markers=6, n_edges=2500,
                               kappa_r=1e5, sigma_t=1e-4)
    p = pack_problem(prob.edges, prob.constraints(), lambda e: 1.0, lambda e: 1.0,
                     lambda e: True, dtype=np.float32)
    KR = fold_constraints(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (
        p.R_e, p.k_r, p.marker_idx.astype(np.int64), p.R_con)), p.root_idx).numpy()
    chunked = sort_edges_by_time(KR, p.k_r, p.cam_idx, p.time_idx, p.num_times, 32)
    kw = dict(C=p.num_cams, T=p.num_times, chunk_t=32, maxiter=4, materialize_budget=1)
    before, pwr_before = thin_mv.launches, pwr_apply.launches
    gpu = so3_sync_large(*chunked, device=cuda, **kw)
    assert thin_mv.launches > before and pwr_apply.launches == pwr_before
    cpu = so3_sync_large(*chunked, device="cpu", **kw)
    d = max(distance_SO3(a, b) for a, b in zip(gpu.r_cam.cpu().double().numpy(),
                                                cpu.r_cam.double().numpy()))
    # f32 on both sides, bf16 filter products summed in other orders (the
    # JAX parity bar of tests/test_torch_scale.py)
    assert d < 0.15, d


_DEFAULT = (3, 9, 13, 19, 23, 29, 33)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,C,wins,view", [
    (2, 96, 256, 10.0, _DEFAULT, False), (1, 73, 130, 10.0, _DEFAULT, False),
    (3, 1, 40, 10.0, _DEFAULT, False), (1, 721, 1283, 10.0, _DEFAULT, False),
    (4, 33, 517, 7.5, _DEFAULT, False), (2, 200, 331, -2.25, _DEFAULT, False),
    # H and W below the 33-pixel window; a single pixel
    (2, 20, 17, 10.0, _DEFAULT, False), (1, 1, 1, 10.0, _DEFAULT, False),
    (3, 31, 32, 3.0, _DEFAULT, False),
    # W % 16 != 0 on the 16-byte path's neighbours, and W a multiple of 16
    (2, 64, 1288, 10.0, _DEFAULT, False), (2, 130, 1296, 10.0, _DEFAULT, False),
    # gray[1:] of a 2 x 721 x 1283 batch: an odd storage offset
    (2, 721, 1283, 10.0, _DEFAULT, True),
    # one window of each extreme, and eight windows
    (2, 70, 300, 10.0, (1,), False), (2, 70, 300, 10.0, (33,), False),
    (2, 70, 304, 10.0, (3, 33, 5, 7, 9, 11, 13, 15), False),
    (1, 50, 77, 7.5, (1, 31, 3, 33, 17, 5, 25, 9), False),
    # a frame as wide as the kernel's column band, and two bands
    (1, 64, 256, 10.0, _DEFAULT, False), (5, 97, 512, 10.0, _DEFAULT, False),
    # the scene's frame size at B = 1 and at a batch that cuts rows into segments
    (1, 720, 1280, 10.0, _DEFAULT, False), (6, 720, 1280, 10.0, _DEFAULT, False),
])
def test_threshold_kernel_matches_plain(cuda, B, H, W, C, wins, view):
    rng = np.random.default_rng(H + W)
    # a smooth ramp with noise, so that masks are neither empty nor full
    ramp = np.linspace(0, 200, W)[None, None, :] + np.linspace(0, 40, H)[None, :, None]
    img = np.clip(ramp + rng.normal(scale=30, size=(B, H, W)), 0, 255).astype(np.uint8)
    gray = torch.from_numpy(img).to(cuda)
    if view:
        gray = gray[1:]
        assert gray.data_ptr() % 2 == 1 and gray.is_contiguous()
    before = multi_threshold.launches
    out = multi_threshold(gray, win_sizes=wins, thresh_const=C)
    torch.cuda.synchronize()
    assert multi_threshold.launches == before + 1
    ref = multi_threshold_plain(gray, win_sizes=wins, thresh_const=C)
    assert out.shape == ref.shape == (gray.shape[0], len(wins), H, -(-W // 8))
    assert int((out != ref).sum()) == 0
    # the plain version computes the same on the card and on the CPU
    assert torch.equal(ref.cpu(), multi_threshold_plain(gray.cpu(), win_sizes=wins,
                                                        thresh_const=C))


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,rows", [(2, 721, 1283, 32), (2, 721, 1283, 256),
                                        (2, 721, 1283, 736), (3, 720, 1280, 64),
                                        (3, 720, 1280, 192)])
def test_threshold_kernel_every_row_cut(cuda, B, H, W, rows):
    """Any rows per CTA (the plan's override) gives the same masks."""
    rng = np.random.default_rng(rows)
    gray = torch.from_numpy(rng.integers(0, 256, (B, H, W)).astype(np.uint8)).to(cuda)
    out = multi_threshold(gray, rows=rows)
    assert int((out != multi_threshold_plain(gray)).sum()) == 0


@pytest.mark.gpu
def test_threshold_plan_matches_the_kernel(cuda):
    """The plan's constants are the kernel's (threshold.cu:threshold_constant),
    and the loaded variants report their resources (threshold_attribute)."""
    from vican_torch import _kernels
    from vican_torch.ops import threshold as th

    got = [_kernels.call("threshold", "threshold_constant", i) for i in range(4)]
    assert got == [th.BAND, th.STEP_ROWS, th.THREADS, th.SMEM]
    for v in range(4):
        regs, smem_static, local = (_kernels.call("threshold", "threshold_attribute", v, w)
                                    for w in range(3))
        assert 0 < regs <= 128 and smem_static + th.SMEM <= th.SMEM_LIMIT and local >= 0


@pytest.mark.gpu
def test_perception_on_the_card_matches_cpu(cuda):
    """Three frames from the port's renderer: the gray-batch stage on the
    card (the threshold kernel) and on the CPU (its plain version) find the
    same detections."""
    frames, names, frame_cams = rendered_640(cuda, 1, 3)
    kw = dict(CUBE_KW, batch_size=4)
    before = multi_threshold.launches
    gpu = estimate_pose_gray(frames, names, frame_cams, **kw)
    assert multi_threshold.launches == before + 1
    cpu = estimate_pose_gray(frames.cpu(), names, frame_cams, device="cpu", **kw)
    assert len(cpu) > 5
    assert set(gpu) == set(cpu)
    for k in cpu:
        np.testing.assert_allclose(gpu[k]["corners"], cpu[k]["corners"], rtol=0, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("pad", [0, 3], ids=["W=640", "W=643"])
def test_perception_modes_on_the_card_agree(cuda, pad):
    """The host mode (host threshold, the kernel not launched) gives the
    device mode's detections on the card, at the frames' width and at a
    ragged one (W % 8 != 0: the kernel's bits past W are zero)."""
    from vican_torch import perception

    frames, names, frame_cams = rendered_640(cuda, 2, 5, pad)
    kw = dict(CUBE_KW, batch_size=4)
    before = multi_threshold.launches
    dev = estimate_pose_gray(frames, names, frame_cams, pipeline_mode="device", **kw)
    assert multi_threshold.launches == before + 2 and perception.last_labeler == "c"
    host = estimate_pose_gray(frames.cpu().numpy(), names, frame_cams, pipeline_mode="host",
                              **kw)
    assert multi_threshold.launches == before + 2
    assert len(dev) > 5 and list(host) == list(dev)
    for k in dev:
        np.testing.assert_allclose(host[k]["corners"], dev[k]["corners"], rtol=0, atol=1e-3)


def _angles(R) -> np.ndarray:
    """Rotation angles in float64 from the antisymmetric part and the trace."""
    R = np.asarray(R, np.float64)
    w = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], -1)
    return np.arctan2(np.linalg.norm(w, axis=-1) / 2, (np.trace(R, axis1=-2, axis2=-1) - 1) / 2)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [10.0, 1e3, 1e5])
def test_random_langevin_on_the_card_matches_cpu_in_distribution(cuda, k):
    """The card's and the CPU's generators give different streams: the
    samplers are held by the angle distribution, a two-sample KS statistic
    < 0.03 at n = 20 000, as against the JAX package on the CPU."""
    from scipy.stats import ks_2samp

    from vican_torch.ops.lie import random_langevin

    n = 20_000
    card = random_langevin(torch.Generator(device=cuda).manual_seed(0), k, (n,), device=cuda)
    again = random_langevin(torch.Generator(device=cuda).manual_seed(0), k, (n,), device=cuda)
    cpu = random_langevin(torch.Generator().manual_seed(0), k, (n,), device="cpu")
    assert card.device.type == cuda.type and card.dtype == torch.float32 and card.shape == (n, 3, 3)
    assert torch.equal(card, again)
    stat = ks_2samp(_angles(card.cpu()), _angles(cpu)).statistic
    assert stat < 0.03, stat


@pytest.mark.gpu
def test_evaluate_calibration_of_a_card_solve(cuda):
    """A problem solved on the card and on the CPU in float64:
    evaluate_calibration gives both the same report, translations within
    1e-3 cm and rotations within the 0.05 deg floor of the float32 pose
    composition (arccos of float32 rotations near the identity,
    tests/test_evaluation.py:57-59), at the problem's noise floor."""
    from vican_torch.evaluation import evaluate_calibration
    from vican_torch.synthetic import make_problem

    prob = make_problem(seed=3, n_cams=12, n_times=60)
    kw = dict(constraints=prob.constraints(), noise_model_r=lambda e: 1.0,
              noise_model_t=lambda e: 1.0, edge_filter=lambda e: True, maxiter=4,
              dtype=np.float64, verbose=False)
    card = evaluate_calibration(prob.cams_gt, bipgo.bipartite_se3sync(prob.edges, device=cuda,
                                                                      **kw))
    cpu = evaluate_calibration(prob.cams_gt, bipgo.bipartite_se3sync(prob.edges, device="cpu",
                                                                     **kw))
    assert card.missing_cam_ids == cpu.missing_cam_ids == []
    assert card.valid_cam_ids == cpu.valid_cam_ids
    np.testing.assert_allclose(card.r_err_deg, cpu.r_err_deg, rtol=0, atol=0.05)
    np.testing.assert_allclose(card.t_err_cm, cpu.t_err_cm, rtol=0, atol=1e-3)
    assert card.summary()["SO3_deg"]["avg"] < 0.5 and card.summary()["E3_cm"]["avg"] < 1.0


@pytest.mark.gpu
def test_tutorial_flow_on_the_card(cuda):
    """examples/tutorial.py's flow at its --quick size from frames rendered
    on the card (no files, no OpenCV): the tutorial's preprocess on the
    host, detection with the threshold kernel, the object and network
    stages, cell 9's evaluation; tests/test_tutorial.py's bars."""
    from vican_torch.evaluation import evaluate_calibration
    from vican_torch.ops.shoelace import polygon_area
    from vican_torch.perception import host_preprocess
    from vican_torch.synthetic import _cube_scene, calibration_sweep

    markers = render.make_cube_markers()
    ids = {str(i) for i in range(24)}
    kw = dict(CUBE_KW, batch_size=32)

    def detect(cams, traj):
        frames, names, frame_cams = render.render_frames(cams, traj, markers, marker_size=0.138,
                                                         device=cuda)
        gray = host_preprocess(frames.cpu().numpy(), -150.0, 120.0)
        before = multi_threshold.launches
        edges = estimate_pose_gray(gray, names, frame_cams, **kw)
        assert multi_threshold.launches == before + -(-len(names) // 32)
        return {k: v for k, v in edges.items() if k[1].split("_")[1] in ids}

    cube_cams, cube_traj = _cube_scene([(1.1, 0.2, 1.1)], 24, seed=2, res=(960, 540),
                                       traj=calibration_sweep(24, (1.1, 0.2, 1.1)))
    obj = bipgo.object_bipartite_se3sync(
        detect(cube_cams, cube_traj),
        noise_model_r=lambda e: 0.01 * polygon_area(e["corners"]) ** 2,
        noise_model_t=lambda e: 0.001 * polygon_area(e["corners"]) ** 2.0,
        edge_filter=lambda e: e["reprojected_err"] < 0.1, maxiter=4, dtype=np.float64,
        verbose=False, device=cuda)
    assert sorted(obj, key=int) == sorted(ids, key=int)
    cams, traj = _cube_scene([(3, 0, 1.2), (0, 3, 1.5), (-3, 0, 1.0), (0, -3, 1.3)], 16, seed=1,
                             res=(960, 540), wander=True)
    est = bipgo.bipartite_se3sync(
        detect(cams, traj), constraints=obj,
        noise_model_r=lambda e: 0.001 * polygon_area(e["corners"]) ** 1.0,
        noise_model_t=lambda e: 0.001 * polygon_area(e["corners"]) ** 2.0,
        edge_filter=lambda e: e["reprojected_err"] < 0.05, maxiter=4, dtype=np.float32,
        verbose=False, device=cuda)
    s = evaluate_calibration(cams, est).summary()
    assert s["missing"] == []
    assert s["SO3_deg"]["avg"] < 1.0 and s["E3_cm"]["avg"] < 10.0, s


@pytest.mark.gpu
def test_detect_and_draw_on_the_card(cuda, tmp_path, capsys):
    """detect_and_draw on the card launches the threshold kernel once and
    draws what the CPU run draws (it needs OpenCV to read the file)."""
    cv = pytest.importorskip("cv2")
    from vican_torch.plot import detect_and_draw

    K = np.array([[420.0, 0, 320], [0, 420.0, 180], [0, 0, 1]])
    cams = {"0": Camera(id="0", intrinsics=K, distortion=np.zeros(12),
                        extrinsics=render.look_at((2.4, 0.3, 1.3), (0, 0, 1.0)),
                        resolution_x=640, resolution_y=360)}
    frames, _, _ = render.render_frames(cams, render.cube_trajectory(1, seed=5),
                                        render.make_cube_markers(), marker_size=0.138,
                                        device=cuda)
    path = str(tmp_path / "frame.png")
    cv.imwrite(path, frames[0].cpu().numpy())
    before = multi_threshold.launches
    card = detect_and_draw(path, "DICT_4X4_1000", brightness=-150, contrast=120, device=cuda)
    card_ids = capsys.readouterr().out.strip().splitlines()[-1]
    assert multi_threshold.launches == before + 1
    cpu = detect_and_draw(path, "DICT_4X4_1000", brightness=-150, contrast=120, device="cpu")
    assert capsys.readouterr().out.strip().splitlines()[-1] == card_ids
    assert len(eval(card_ids)) >= 4
    np.testing.assert_array_equal(card, cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("pad", [0, 3], ids=["W=640", "W=643"])
def test_pure_mode_on_the_card_matches_cpu(cuda, pad):
    """The ``pure`` program on the card (the threshold kernel, then the
    components, candidates and re-fit on the card) against the CPU on 4
    frames, at the frames' width and a ragged one: the same keys, corners
    within 1e-3 px; one kernel launch per batch."""
    frames, names, frame_cams = rendered_640(cuda, 2, 7, pad)
    frames, names, frame_cams = frames[:4], names[:4], frame_cams[:4]
    kw = dict(CUBE_KW, batch_size=4, pipeline_mode="pure")
    before = multi_threshold.launches
    card = estimate_pose_gray(frames, names, frame_cams, **kw)
    assert multi_threshold.launches == before + 1
    cpu = estimate_pose_gray(frames.cpu(), names, frame_cams, device="cpu", **kw)
    assert len(cpu) > 5 and list(card) == list(cpu)
    for k in cpu:
        np.testing.assert_allclose(card[k]["corners"], cpu[k]["corners"], rtol=0, atol=1e-3)


@pytest.mark.gpu
def test_detect_markers_on_the_card_matches_cpu(cuda):
    """``detect_markers`` on a batch on the card against the CPU: the same
    valid slots and ids, corners within 1e-3 px."""
    from vican_torch.ops import detect as D
    from vican_torch.ops.dictionary import marker_bits_table

    frames, _, _ = rendered_640(cuda, 1, 9)
    params = D.resolve_error_correction(D.DetectorParams(), "DICT_4X4_1000")
    table = marker_bits_table("DICT_4X4_1000")
    before = multi_threshold.launches
    card = D.detect_markers(frames.float(), table, 4, params, device=cuda)
    assert multi_threshold.launches == before + 1
    cpu = D.detect_markers(frames.cpu().float(), table, 4, params, device="cpu")
    valid = cpu.valid.numpy()
    assert valid.sum() > 5
    np.testing.assert_array_equal(card.valid.cpu().numpy(), valid)
    np.testing.assert_array_equal(card.ids.cpu().numpy()[valid], cpu.ids.numpy()[valid])
    np.testing.assert_allclose(card.corners.cpu().numpy()[valid], cpu.corners.numpy()[valid],
                               rtol=0, atol=1e-3)


@pytest.mark.gpu
def test_pipeline_on_the_card_equals_depth_one(cuda, monkeypatch):
    """Six frames on the card in batches of 2 (three batches): the default
    depth gives the depth-1 run's edges bit for bit, and the feed thread
    launched every threshold kernel on the caller's device and on a stream
    of its own, not the caller's."""
    from vican_torch.ops import threshold

    frames, names, frame_cams = rendered_640(cuda, 2, 7)
    kw = dict(CUBE_KW, batch_size=2)
    seen = []
    real = threshold.multi_threshold

    def spy(g, *args, **kwargs):
        seen.append((torch.cuda.current_device(), g.device.index,
                     torch.cuda.current_stream(g.device)))
        return real(g, *args, **kwargs)

    spy.launches = real.launches  # the wrapper counts on the module's name
    monkeypatch.setattr(threshold, "multi_threshold", spy)
    caller = torch.cuda.current_stream(cuda)
    piped = estimate_pose_gray(frames, names, frame_cams, **kw)
    monkeypatch.setenv("VICAN_TPU_PIPELINE_DEPTH", "1")
    one = estimate_pose_gray(frames, names, frame_cams, **kw)
    dev = torch.cuda.current_device()
    assert len(seen) == 6
    assert all(d == dev and index == dev and stream != caller for d, index, stream in seen)
    assert len(piped) > 5 and list(piped) == list(one)
    for k in one:
        np.testing.assert_array_equal(piped[k]["corners"], one[k]["corners"])
        np.testing.assert_array_equal(piped[k]["pose"].pose(), one[k]["pose"].pose())


@pytest.fixture(scope="module")
def scene():
    """:func:`torch_bars.rendered_640`'s six frames (2 timesteps, seed 7),
    rendered once for the tests that share them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    return rendered_640(torch.device("cuda"), 2, 7)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,thresholds", [("device", 3), ("auto", 3), ("host", 0),
                                             ("roi", 0), ("pure", 3)])
def test_every_mode_launches_detect_and_pnp_once_a_batch(scene, mode, thresholds):
    """Six frames from host arrays in batches of 2, in each pipeline mode:
    one detect and one PnP launch a batch, the threshold kernel's launches
    the mode's, the C labeler and gates wherever the host labels; host,
    roi and auto give the device mode's keys, corners within the
    card-vs-CPU bar (pure differs as the JAX package's pure mode does)."""
    from vican_torch import perception
    from vican_torch.ops import detect, pnp

    frames, names, frame_cams = scene
    gray = frames.cpu().numpy()
    kw = dict(CUBE_KW, batch_size=2)
    ref = estimate_pose_gray(gray, names, frame_cams, **kw)
    perception.last_labeler = perception.last_gates = None

    def launches():
        return multi_threshold.launches, detect.detect_candidates.launches, pnp.pnp_block.launches

    before = launches()
    edges = estimate_pose_gray(gray, names, frame_cams, pipeline_mode=mode, **kw)
    assert tuple(a - b for a, b in zip(launches(), before)) == (thresholds, 3, 3)
    assert len(edges) > 5
    if mode != "pure":
        assert (perception.last_labeler, perception.last_gates) == ("c", "c")
        assert list(edges) == list(ref)
        for k in ref:
            np.testing.assert_allclose(edges[k]["corners"], ref[k]["corners"], rtol=0, atol=1e-3)


@pytest.mark.gpu
def test_the_detect_program_makes_no_host_sync(scene):
    """A warm call of the detect kernels at every refine kind queues its
    work and returns: one launch, and no synchronization under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from vican_torch.ops import detect as D

    frames = scene[0]
    params = D.resolve_error_correction(D.DetectorParams(), "DICT_4X4_1000")
    args = _detect_inputs(frames.device, frames, params)
    for refine in ("apriltag", "subpix", "none"):
        p = params._replace(corner_refine=refine)
        D.detect_candidates(frames, *args, 4, p)
        torch.cuda.synchronize()
        before = D.detect_candidates.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            D.detect_candidates(frames, *args, 4, p)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert D.detect_candidates.launches == before + 1


@pytest.mark.gpu
def test_the_c_modules_build_and_pack_a_card_solve(cuda):
    """The edge packer, the labeler and the host threshold build with the
    card machine's compiler, and a solve on the card packs in C."""
    from vican_torch import _native
    from vican_torch.solver import packing

    assert all(getattr(_native, f"get_{n}")() is not None
               for n in ("fastpack", "fastccl", "fastthresh")), _native.build_errors
    prob = make_problem_arrays(seed=13, n_cams=40, n_times=256, n_markers=8,
                               n_edges=6000, kappa_r=1e5, sigma_t=1e-4)
    bipgo.bipartite_se3sync(prob.edges, prob.constraints(), lambda e: 1.0, lambda e: 1.0,
                            lambda e: True, maxiter=4, verbose=False)
    assert packing.last_packer == "c"


MESH_CHILD = r"""
import json, os, sys, tempfile
import numpy as np
sys.path[:0] = [sys.argv[1], os.path.join(sys.argv[1], "tests")]
import torch.distributed as dist
from torch_bars import CUBE_KW, rendered_640
from vican_torch import bipgo, perception
from vican_torch.cam import estimate_pose_mp
from vican_torch.ops import detect, pnp
from vican_torch.parallel import init_distributed, make_mesh, se3sync_sharded
from vican_torch.solver.packing import pack_problem
from vican_torch.solver.pwr import pwr_apply
from vican_torch.synthetic import make_problem_arrays

init_distributed()
mesh = make_mesh()
prob = make_problem_arrays(seed=3, n_cams=64, n_times=400, n_edges=6000)
out = {"backend": dist.get_backend(), "world": mesh.size()}
one, every = (lambda e: 1.0), (lambda e: True)
os.environ["VICAN_TPU_SCALE_MIN_CAMS"] = "16"  # the large-graph route at 64 cameras
for dtype in (np.float64, np.float32):
    kw = dict(noise_model_r=one, noise_model_t=one, edge_filter=every, maxiter=4, dtype=dtype,
              verbose=False)
    pwr_apply.launches = 0
    sharded = bipgo.bipartite_se3sync(prob.edges, prob.constraints(), mesh=mesh, **kw)
    launches = pwr_apply.launches
    single = bipgo.bipartite_se3sync(prob.edges, prob.constraints(), **kw)
    out[np.dtype(dtype).name] = {
        "launches": launches,
        "rot": max(float(np.abs(sharded[k].R() - single[k].R()).max()) for k in single),
        "t": max(float(np.abs(sharded[k].t() - single[k].t()).max()) for k in single)}
del os.environ["VICAN_TPU_SCALE_MIN_CAMS"]

# the dense route's whole SE(3) sync, the edges split over the mesh
p = pack_problem(prob.edges, prob.constraints(), one, one, every, dtype=np.float64)
r_cam, _, t_est, res = se3sync_sharded(p, maxiter=4, mesh=mesh, dtype=np.float64)
single = bipgo.bipartite_se3sync(prob.edges, prob.constraints(), one, one, every, maxiter=4,
                                 dtype=np.float64, verbose=False)
out["se3sync_sharded"] = {
    "residual": res,
    "rot": max(float(np.abs(r_cam[i] - single[c].R()).max()) for i, c in enumerate(p.cam_ids)),
    "t": max(float(np.abs(t_est[i] - single[c].t()).max()) for i, c in enumerate(p.cam_ids))}

# perception from JPEG files (written by OpenCV), each rank a share of every batch
try:
    import cv2
except ImportError:
    cv2 = None
out["perception"] = None
if cv2 is not None:
    frames, names, frame_cams = rendered_640("cuda", 2, 7)
    pkw = dict(CUBE_KW, brightness=0, contrast=0, marker_ids=None, batch_size=2)
    with tempfile.TemporaryDirectory() as tmp:
        files = [os.path.join(tmp, n.replace("/", "_")) for n in names]
        assert all(cv2.imwrite(f, img) for f, img in zip(files, frames.cpu().numpy()))
        pnp.pnp_block.launches = detect.detect_candidates.launches = 0
        sharded = estimate_pose_mp(files, frame_cams, mesh=mesh, **pkw)
        launches = [pnp.pnp_block.launches, detect.detect_candidates.launches]
        host = [perception.last_labeler, perception.last_gates]
        single = estimate_pose_mp(files, frame_cams, **pkw)
    out["perception"] = {
        "detections": len(single), "launches": launches, "host": host,
        "identical": list(sharded) == list(single) and all(
            np.array_equal(sharded[k]["corners"], v["corners"])
            and np.array_equal(sharded[k]["pose"].pose(), v["pose"].pose())
            for k, v in single.items())}
dist.destroy_process_group()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """:data:`MESH_CHILD`'s results: a world of one rank over NCCL, in a
    child process of its own (its own timeout ends the process group)."""
    import json
    import os
    import subprocess
    import sys

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: NCCL runs only there")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path_factory.mktemp("mesh") / "mesh_child.py"
    script.write_text(MESH_CHILD)
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    proc = subprocess.run([sys.executable, str(script), repo], capture_output=True, text=True,
                          env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (out["backend"], out["world"]) == ("nccl", 1)
    return out


@pytest.mark.gpu
def test_mesh_large_route_over_nccl_matches_single(mesh_run):
    """``bipartite_se3sync(mesh=make_mesh())`` at world size 1: float64
    rotations equal to ``mesh=None`` within 1e-9 (entries), translations
    within the CG tolerance of tests/test_sharded.py (1e-3 m: the
    relative-residual stop may fall one iteration apart); in float32 the
    sharded filter launches ``pwr_apply``."""
    out = mesh_run
    assert out["float64"]["rot"] < 1e-9 and out["float64"]["t"] < 1e-3, out
    assert out["float32"]["launches"] > 0 and out["float64"]["launches"] == 0, out


@pytest.mark.gpu
def test_se3sync_sharded_over_nccl_matches_single(mesh_run):
    """``se3sync_sharded`` at world size 1 against ``bipartite_se3sync`` in
    float64, at tests/test_sharded.py:55-61's bars: rotations 1e-6 (the
    single run's poses pass through float32), translations 1e-3 m, CG
    residual below 1e-3."""
    s = mesh_run["se3sync_sharded"]
    assert s["residual"] < 1e-3 and s["rot"] < 1e-6 and s["t"] < 1e-3, s


@pytest.mark.gpu
def test_perception_with_a_mesh_over_nccl_matches_single(mesh_run):
    """``estimate_pose_mp(mesh=...)`` at world size 1 on six files gives
    ``mesh=None``'s edges bit for bit, one PnP and one detect launch a
    batch, candidates from the C labeler and gates."""
    p = mesh_run["perception"]
    if p is None:
        pytest.skip("needs OpenCV to write the frames as files")
    assert p["identical"] and p["detections"] > 5, p
    assert p["launches"] == [3, 3] and p["host"] == ["c", "c"], p


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["ippe_square", "iterative"])
@pytest.mark.parametrize("distorted", [False, True])
def test_pnp_kernel_matches_plain(cuda, method, distorted):
    """The PnP kernel (csrc/pnp.cu) against ``pnp_block_plain`` on the card
    at P's shape, 32 cameras x 24 slots of ``torch_bars.pnp_slots``:
    ``ok``, corners and ids identical, slots that are not valid zero past
    their id, poses and errors within torch_bars' float64 bars (where
    their reason is given); one launch."""
    args = pnp_slots(32, 24, 3 + distorted, distorted, cuda)
    pnp_block.launches = 0
    out = pnp_block(*args, PNP_MARKER, 20, method)
    torch.cuda.synchronize()
    assert pnp_block.launches == 1
    ref = pnp_block_plain(*args, PNP_MARKER, 20, method)
    gaps = pnp_gaps(out, ref)
    assert gaps["same_ok"] and gaps["same_head"] and gaps["same_zeros"], gaps
    assert gaps["ok"] > 400, gaps
    assert max(gaps["R"], gaps["t"], gaps["err"]) <= PNP_TOL, gaps
    assert max(gaps["R_median"], gaps["t_median"]) <= PNP_MEDIAN_TOL, gaps
    not_valid = ~args[2].cpu()
    assert (out.cpu()[not_valid, 9:] == 0).all()


def _assert_pnp_edge(out, ref):
    """``ok``, corners and ids identical, zeros past the id where the plain
    version has them, the ok slots within the float64 bars, and every
    valid slot that is not ok non-finite in the kernel too."""
    o, r = out.cpu().numpy(), ref.cpu().numpy()
    assert np.array_equal(o[:, :10], r[:, :10])
    zero = (r[:, 9:] == 0).all(1)
    assert (o[zero, 9:] == 0).all()
    ok = r[:, 9] > 0.5
    if ok.any():
        gaps = pnp_gaps(out, ref)
        assert max(gaps["R"], gaps["t"], gaps["err"]) <= PNP_TOL, gaps
        assert max(gaps["R_median"], gaps["t_median"]) <= PNP_MEDIAN_TOL, gaps
    failed = ~ok & ~zero
    assert not np.isfinite(o[failed, 10:]).all(1).any()


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["ragged", "none_valid", "one_valid", "zero_quads"])
@pytest.mark.parametrize("method", ["ippe_square", "iterative"])
def test_pnp_warp_design_edges_match_plain(cuda, case, method):
    """The warp design's edges against ``pnp_block_plain``, one launch each:
    21 slots (not a multiple of a block's 4), a batch with no valid slot
    (heads and zeros only), a single valid slot, and valid slots whose
    quads are all zero (non-finite, ``ok`` = 0, as the plain version
    gives)."""
    corners, ids, valid, Ks, dists = pnp_slots(*((3, 7) if case == "ragged" else (4, 24)), 11,
                                               True, cuda)
    if case == "none_valid":
        valid = torch.zeros_like(valid)
    elif case == "one_valid":
        valid = torch.zeros_like(valid)
        valid[int((corners != 0).flatten(1).any(1).nonzero()[-1, 0])] = True
    elif case == "zero_quads":
        corners[::5] = 0.0
        valid[::5] = True
    pnp_block.launches = 0
    out = pnp_block(corners, ids, valid, Ks, dists, PNP_MARKER, 20, method)
    torch.cuda.synchronize()
    assert pnp_block.launches == 1
    ref = pnp_block_plain(corners, ids, valid, Ks, dists, PNP_MARKER, 20, method)
    _assert_pnp_edge(out, ref)
    n_ok = int(out[:, 9].sum())
    assert n_ok == {"none_valid": 0, "one_valid": 1}.get(case, n_ok)
    if case == "zero_quads":
        assert (out[::5, 9] == 0).all()


@pytest.mark.gpu
def test_phase_sync_waits_for_the_card(cuda):
    """``PhaseTimer.phase(sync=t)`` on a timer with no device waits for the
    work queued on ``t``'s stream: a ~0.1 s device sleep lands inside the
    phase."""
    timer = PhaseTimer(verbose=False)
    x = torch.ones(4, device=cuda)
    torch.cuda.synchronize()
    with timer.phase("sleep", sync=x):
        torch.cuda._sleep(200_000_000)
    with timer.phase("sleep, out", stage="drain") as out:
        torch.cuda._sleep(200_000_000)
        out["sync"] = {"x": [x]}
    assert all(e["seconds"] > 0.05 for e in timer.events), timer.events


def _count_synchronizations(monkeypatch) -> list:
    """Every ``torch.cuda.Stream.synchronize`` from now on, in a list."""
    seen, real = [], torch.cuda.Stream.synchronize

    def counted(stream):
        seen.append(stream)
        return real(stream)

    monkeypatch.setattr(torch.cuda.Stream, "synchronize", counted)
    return seen


@pytest.mark.gpu
def test_a_capture_times_its_kernels_and_adds_one_wait_a_batch(cuda, monkeypatch):
    """Six frames in batches of 2 on the card: the "detect program" and
    "PnP" events, and they alone, carry a device time, above 0 and at most
    their host time; and the capture synchronizes a stream once a phase:
    the seven phases a batch that synchronized before, and "candidates
    upload", whose end comes just before that of "host candidates" around
    it."""
    frames, names, frame_cams = rendered_640(cuda, 2, 7)
    kw = dict(CUBE_KW, batch_size=2)
    estimate_pose_gray(frames, names, frame_cams, **kw)  # builds and loads the kernels
    syncs = _count_synchronizations(monkeypatch)
    timer = PhaseTimer(verbose=False, device=cuda)
    edges = estimate_pose_gray(frames, names, frame_cams, timer=timer, **kw)
    assert len(edges) > 5
    before = ("upload", "threshold kernel", "masks to host", "host candidates",
              "detect program", "PnP", "dict")
    timed = sorted(e["name"] for e in timer.events if e["device_seconds"] is not None)
    assert timed == sorted(("detect program", "PnP") * 3)
    assert sorted(e["name"] for e in timer.events) == sorted(
        (*before, "candidates upload", "wait for feed") * 3)
    assert len(syncs) == len(before) * 3 + 3
    for e in timer.events:
        if e["name"] in ("detect program", "PnP"):
            assert 0 < e["device_seconds"] <= e["seconds"], e


def _rig_frames(dev):
    """The cube seen by two cameras at 640x480 and one at 1920x1080 over 5
    timesteps, rendered on ``dev``, as the frames arrive (timesteps
    outer): ``(frames, names, frame_cams)``, the frames a list of 2-D
    tensors.  In batches of 4: 4, 4, 2 VGA frames, then 4 and 1 HD, each
    size's last batch padded."""
    cams = {}
    for i, (pos, (W, H)) in enumerate([((2.4, 0, 1.2), (640, 480)),
                                       ((0, 2.4, 1.4), (1920, 1080)),
                                       ((-2.4, 0.5, 1.0), (640, 480))]):
        f = 0.55 * (W + H)
        K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]])
        cams[str(i)] = Camera(id=str(i), intrinsics=K, distortion=np.zeros(12),
                              extrinsics=render.look_at(pos, (0, 0, 1.0)),
                              resolution_x=W, resolution_y=H)
    markers = render.make_cube_markers()
    tiles = render.marker_tiles(list(markers))
    frames, names, frame_cams = [], [], []
    for t, obj in render.cube_trajectory(5, seed=11).items():
        world = {m: obj @ p for m, p in markers.items()}
        for cid, cam in cams.items():
            frames.append(render.render_image(cam, world, tiles, CUBE_KW["marker_size"],
                                              device=dev))
            names.append(f"{t}/{cid}.jpg")
            frame_cams.append(cam)
    return frames, names, frame_cams


@pytest.fixture(scope="module")
def rig():
    """:func:`_rig_frames` on the card, rendered once for the tests that
    share them, and its frames in host memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel runs only there")
    frames, names, frame_cams = _rig_frames(torch.device("cuda"))
    return frames, [f.cpu().numpy() for f in frames], names, frame_cams


def _assert_identical(a: dict, b: dict):
    """The same keys in the same order, and bit for bit the same values."""
    assert list(a) == list(b)
    for k in a:
        np.testing.assert_array_equal(a[k]["corners"], b[k]["corners"])
        np.testing.assert_array_equal(a[k]["pose"].pose(), b[k]["pose"].pose())
        assert a[k]["reprojected_err"] == b[k]["reprojected_err"]
        assert a[k]["im_filename"] == b[k]["im_filename"]


def _uploads(timer) -> list:
    return [(e["batch"], e["height"], e["width"], e["pinned"], e["bytes"])
            for e in sorted(timer.events, key=lambda e: e["batch"]) if e["name"] == "upload"]


@pytest.mark.gpu
def test_every_route_of_a_rig_to_the_card_gives_the_same_edges(rig):
    """640x480 and 1920x1080 frames in batches of 4, each size ending in a
    padded tail batch: the list of host frames (stacked into page-locked
    memory), one host array of each size (copied into it by the upload)
    and the same list already on the card (stacked there) give bit for bit
    the same edges; every batch is 4 frames on the card."""
    on_card, host, names, cams = rig
    kw = dict(CUBE_KW, batch_size=4)
    listed = estimate_pose_gray(host, names, cams, **kw)
    arrays = {}
    for size in ((480, 640), (1080, 1920)):
        idx = [i for i, f in enumerate(host) if f.shape == size]
        arrays.update(estimate_pose_gray(np.stack([host[i] for i in idx]),
                                         [names[i] for i in idx], [cams[i] for i in idx],
                                         **kw))
    timer = PhaseTimer(verbose=False, device=torch.device("cuda"))
    carded = estimate_pose_gray(on_card, names, cams, timer=timer, **kw)
    assert {k[0] for k in listed} == {"0", "1", "2"} and len(listed) > 20
    _assert_identical(listed, arrays)
    _assert_identical(listed, carded)
    assert [u[:3] for u in _uploads(timer)] == [(0, 480, 640), (1, 480, 640), (2, 480, 640),
                                                (3, 1080, 1920), (4, 1080, 1920)]


@pytest.mark.gpu
def test_every_depth_stages_a_rig_to_the_same_edges(rig, monkeypatch):
    """The list of host frames at pipeline depths 1, 2 and 3: the same
    edges, bit for bit.  A page-locked batch rewritten while its copy to
    the card still ran would show here as other frames, so other edges."""
    _, host, names, cams = rig
    kw = dict(CUBE_KW, batch_size=4)
    runs = {}
    for depth in ("1", "2", "3"):
        monkeypatch.setenv("VICAN_TPU_PIPELINE_DEPTH", depth)
        runs[depth] = estimate_pose_gray(host, names, cams, **kw)
    assert len(runs["1"]) > 20
    _assert_identical(runs["1"], runs["2"])
    _assert_identical(runs["1"], runs["3"])


@pytest.mark.gpu
@pytest.mark.parametrize("source", ["host frames", "host array", "card frames", "card array"])
def test_the_upload_counts_whether_it_went_through_pinned_memory(rig, source):
    """Every "upload" counts ``pinned`` 1 where its frames came from host
    memory (a list's stack or an array's slice, the padded tail batch's
    too) and 0 where they were on the card already, and ``bytes``, its
    batch of 4 frames."""
    on_card, host, names, cams = rig
    frames = host if source.startswith("host") else on_card
    sizes = [(480, 640)] * 3 + [(1080, 1920)] * 2
    if source.endswith("array"):  # the VGA frames
        idx = [i for i, f in enumerate(host) if f.shape == (480, 640)]
        stack = np.stack if source.startswith("host") else torch.stack
        frames, names, cams = (stack([frames[i] for i in idx]), [names[i] for i in idx],
                               [cams[i] for i in idx])
        sizes = sizes[:3]
    timer = PhaseTimer(verbose=False, device=torch.device("cuda"))
    estimate_pose_gray(frames, names, cams, timer=timer, **dict(CUBE_KW, batch_size=4))
    pinned = int(source.startswith("host"))
    assert _uploads(timer) == [(b, h, w, pinned, 4 * h * w) for b, (h, w) in enumerate(sizes)]


@pytest.mark.gpu
def test_a_second_capture_allocates_no_pinned_memory(rig):
    """Host frames of two sizes: the first capture allocates the page-locked
    memory its batches pass through, and a second capture of the same
    frames reuses it (PyTorch's caching host allocator: no new host
    allocation)."""
    _, host, names, cams = rig
    kw = dict(CUBE_KW, batch_size=4)
    estimate_pose_gray(host, names, cams, **kw)
    before = torch.cuda.host_memory_stats()["num_host_alloc"]
    estimate_pose_gray(host, names, cams, **kw)
    assert torch.cuda.host_memory_stats()["num_host_alloc"] == before


@pytest.mark.gpu
def test_colour_files_on_the_card_give_the_edges_of_their_preprocessed_frames(cuda, tmp_path):
    """P's first 32 frames (1280x720) written as colour JPEG files, quality
    95, as the `.jpeg` cell writes them: the file entry at brightness -150
    and contrast 120 (each decode task maps its file and converts it to
    gray into the batch's page-locked memory) gives, bit for bit, the edges
    of ``estimate_pose_gray`` of ``host_preprocess(load_images(files),
    -150, 120)`` on the card: keys, corners, poses and errors.  Its batches
    of 12, the last padded from 8, count those frames in ``table_frames``
    and are uploaded from page-locked memory."""
    import cv2

    from vican_torch.perception import estimate_pose_batched, host_preprocess, load_images

    frames, names, frame_cams = p_frames(cuda)
    files = []
    for img, name in zip(frames.cpu().numpy(), names):
        files.append(str(tmp_path / name.replace("/", "_")))
        assert cv2.imwrite(files[-1], cv2.cvtColor(img, cv2.COLOR_GRAY2BGR),
                           [cv2.IMWRITE_JPEG_QUALITY, 95])
    kw = dict(P_KW, batch_size=12)
    ref = estimate_pose_gray(host_preprocess(load_images(files), -150.0, 120.0), files,
                             frame_cams, **kw)
    timer = PhaseTimer(verbose=False, device=cuda)
    out = estimate_pose_batched(files, frame_cams, brightness=-150, contrast=120, timer=timer,
                                **kw)
    assert len(ref) > 100
    _assert_identical(ref, out)
    decodes = sorted((e for e in timer.events if e["name"] == "decode"),
                     key=lambda e: e["batch"])
    assert [e["table_frames"] for e in decodes] == [12, 12, 8]
    assert _uploads(timer) == [(b, 720, 1280, 1, 12 * 720 * 1280) for b in range(3)]


@pytest.mark.gpu
def test_a_dense_solve_times_its_stages_and_adds_three_waits(cuda, monkeypatch):
    """A dense-route solve on the card: the three stages nest in
    "Optimizing + solving (device)" and record no timing events, and the
    solve synchronizes five times: at the end of the two phases that did
    before, and of the three stages."""
    prob = make_problem_arrays(seed=13, n_cams=40, n_times=256, n_markers=8,
                               n_edges=6000, kappa_r=1e5, sigma_t=1e-4)
    args = (prob.edges, prob.constraints(), lambda e: 1.0, lambda e: 1.0, lambda e: True)
    bipgo.bipartite_se3sync(*args, maxiter=4, verbose=False)
    syncs = _count_synchronizations(monkeypatch)
    timer = PhaseTimer(verbose=False, device=cuda)
    bipgo.bipartite_se3sync(*args, maxiter=4, verbose=False, timer=timer)
    stages = ["Folding constraints (device)", "Rotation sync (device)", "Translations (device)"]
    assert [e["name"] for e in timer.events] == [
        "Applying constraints", *stages, "Optimizing + solving (device)"]
    assert len(syncs) == 2 + 3
    assert all(e["device_seconds"] is None for e in timer.events)
    ev = {e["name"]: e for e in timer.events}
    assert sum(ev[n]["seconds"] for n in stages) <= ev["Optimizing + solving (device)"]["seconds"]
    assert ev["Rotation sync (device)"]["iterations"] >= 1
    assert ev["Translations (device)"]["iterations"] >= 1


def _detect_inputs(cuda, frames, params, aruco="DICT_4X4_1000"):
    """A batch's detect inputs as the feed hands them to the drain: the
    threshold kernel's masks, the C labeler's gated candidates moved to the
    card, the ``aruco`` dictionary's codes."""
    from vican_torch import perception
    from vican_torch.ops import detect as D
    from vican_torch.ops.dictionary import marker_bits_table

    H, W = frames.shape[1:]
    packed = multi_threshold(frames, params.win_sizes, params.thresh_const).cpu().numpy()
    cands = perception.quads_from_packed_masks(packed, H, W, params)
    quads, valid, areas = (torch.as_tensor(c).to(cuda) for c in cands)
    return quads, valid, areas, D.dictionary_codes(marker_bits_table(aruco), cuda)


def _marker_grid(n: int) -> np.ndarray:
    """A 1280x720 frame of ``n`` (at most 40) axis-aligned 60 px markers of
    DICT_4X4_1000 on white, 8 a row: all of one area, so the dedup's ties
    decide their order, and more than 24 of them decode."""
    from vican_torch.ops.dictionary import get_dictionary

    bits, nb = get_dictionary("DICT_4X4_1000")
    img = np.full((720, 1280), 255, np.uint8)
    for k in range(n):
        r, c = divmod(k, 8)
        tile = np.zeros((nb + 2, nb + 2), np.uint8)
        tile[1:-1, 1:-1] = np.asarray(bits[3 * k + 5]).reshape(nb, nb) * 255
        img[40 + 130 * r:100 + 130 * r, 40 + 150 * c:100 + 150 * c] = np.kron(
            tile, np.ones((10, 10), np.uint8))
    return img


def _assert_detect_matches_plain(frames, quads, valid, areas, codes, params, n_bits=4):
    """One launch of the detect kernels against ``detect_candidates_plain``
    on the same card tensors, at torch_bars' bars: valid, ids and
    scores identical on every slot, the kept corners within DETECT_TOL px.
    Returns the gaps (printed: the max corner gap is the report)."""
    from vican_torch.ops import detect as D

    before = D.detect_candidates.launches
    out = D.detect_candidates(frames, quads, valid, areas, codes, n_bits, params)
    torch.cuda.synchronize()
    assert D.detect_candidates.launches == before + 1
    ref = D.detect_candidates_plain(frames, quads, valid, areas, codes, n_bits, params)
    gaps = detect_gaps(out, ref)
    print(params.corner_refine, gaps)
    assert detect_ok(gaps), gaps
    return gaps, out


@pytest.fixture(scope="module")
def p_batch():
    """P's first batch (:func:`torch_bars.p_first_batch`): 32 frames of
    1280x720, two cameras distorted, the shape the room cells feed, and the
    detect and PnP arguments the pipeline made of it; rendered once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return p_first_batch(torch.device("cuda"))


@pytest.mark.gpu
def test_threshold_kernel_on_p_first_batch_matches_plain(p_batch):
    """The threshold kernel on P's 32x720x1280 frames at the detector's
    windows and constant: 0 bytes differ from the plain version."""
    frames, p = p_batch[0], p_batch[1][-1]
    assert tuple(frames.shape) == (32, 720, 1280)
    out = multi_threshold(frames, p.win_sizes, p.thresh_const)
    assert int((out != multi_threshold_plain(frames, p.win_sizes, p.thresh_const)).sum()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("refine", ["apriltag", "subpix", "none"])
def test_detect_kernels_on_p_first_batch_match_plain(p_batch, refine):
    """The detect kernels on P's first batch as the drain hands it over,
    at each refine kind: one launch, the bars of ``torch_bars.detect_ok``."""
    gray, quads, valid, areas, codes, n_bits, params = p_batch[1]
    quads, valid, areas = (torch.as_tensor(x, device=gray.device) for x in (quads, valid, areas))
    assert tuple(gray.shape) == (32, 720, 1280)
    gaps, _ = _assert_detect_matches_plain(gray, quads, valid, areas, codes,
                                           params._replace(corner_refine=refine), n_bits)
    assert gaps["kept"] > 100, gaps


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["ippe_square", "iterative"])
def test_pnp_kernel_on_p_first_batch_matches_plain(p_batch, method):
    """The PnP kernel on P's first batch of detections, two cameras
    distorted, in both methods: one launch, ``ok``, corners and ids
    identical, poses and errors within PNP_TOL, medians within
    PNP_MEDIAN_TOL."""
    corners, ids, valid, Ks, dists, size, iters, _ = p_batch[2]
    before = pnp_block.launches
    out = pnp_block(corners, ids, valid, Ks, dists, size, iters, method)
    torch.cuda.synchronize()
    assert pnp_block.launches == before + 1
    gaps = pnp_gaps(out, pnp_block_plain(corners, ids, valid, Ks, dists, size, iters, method))
    assert gaps["same_ok"] and gaps["same_head"] and gaps["same_zeros"], gaps
    assert gaps["ok"] > 100, gaps
    assert max(gaps["R"], gaps["t"], gaps["err"]) <= PNP_TOL, gaps
    assert max(gaps["R_median"], gaps["t_median"]) <= PNP_MEDIAN_TOL, gaps


@pytest.mark.gpu
@pytest.mark.parametrize("refine", ["apriltag", "subpix", "none"])
@pytest.mark.parametrize("pad", [0, 3], ids=["W=640", "W=643"])
def test_detect_kernels_match_plain(cuda, refine, pad):
    """The detect kernels (csrc/detect.cu) against the plain version on six
    rendered frames at each refine kind, at the frames' width and a ragged
    one, twice bit for bit; float32 frames, which the kernel does not
    take, raise."""
    from vican_torch.ops import detect as D

    frames = rendered_640(cuda, 2, 7, pad)[0]
    params = D.resolve_error_correction(D.DetectorParams(corner_refine=refine), "DICT_4X4_1000")
    args = _detect_inputs(cuda, frames, params)
    gaps, out = _assert_detect_matches_plain(frames, *args, params)
    assert gaps["kept"] > 10
    again = D.detect_candidates(frames, *args, 4, params)
    assert all(torch.equal(a, b) for a, b in zip(out, again))
    with pytest.raises(ValueError, match="uint8"):
        D.detect_candidates(frames.float(), *args, 4, params)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["no_valid_slot", "equal_areas", "over_24_survivors"])
def test_detect_kernels_edge_cases_match_plain(cuda, case):
    """A batch with no valid slot (every output slot empty), a batch whose
    candidates all have one area (the dedup's order by index), and a frame
    of 40 markers of which more than 24 survive (the compaction's cut),
    each at every refine kind."""
    from vican_torch.ops import detect as D

    params = D.resolve_error_correction(D.DetectorParams(), "DICT_4X4_1000")
    if case == "over_24_survivors":
        frames = torch.from_numpy(np.stack([_marker_grid(40), _marker_grid(33)])).to(cuda)
    else:
        frames = rendered_640(cuda, 2, 7)[0]
    quads, valid, areas, codes = _detect_inputs(cuda, frames, params)
    if case == "no_valid_slot":
        valid = torch.zeros_like(valid)
    elif case == "equal_areas":
        areas = torch.full_like(areas, 400.0)
    for refine in ("apriltag", "subpix", "none"):
        p = params._replace(corner_refine=refine)
        gaps, out = _assert_detect_matches_plain(frames, quads, valid, areas, codes, p)
        if case == "no_valid_slot":
            assert gaps["kept"] == 0 and not out.ids.any() and not out.corners.any()
        if case == "over_24_survivors":
            assert bool(out.valid[0].all())
            wide = D.detect_candidates_plain(frames, quads, valid, areas, codes, 4,
                                             p._replace(max_detections=100))
            assert int(wide.valid[0].sum()) > 24
        else:
            assert gaps["kept"] > 10 or case == "no_valid_slot"


@pytest.mark.gpu
@pytest.mark.parametrize("samples", [5, 9])
def test_detect_kernels_7x7_match_plain(cuda, samples):
    """DICT_7X7_1000 markers at every refine kind: 81 cells of
    ``samples``^2 samples a slot, the largest code the C entry takes; at 9
    samples a cell a slot's warp holds 6561 samples and their bins (~53 KB
    of shared memory, past 48 KB: the opt-in)."""
    from vican_torch.ops import detect as D

    aruco = "DICT_7X7_1000"
    frames = rendered_640(cuda, 1, 7, aruco=aruco)[0]
    params = D.resolve_error_correction(D.DetectorParams(decode_samples=samples), aruco)
    quads, valid, areas, codes = _detect_inputs(cuda, frames, params, aruco)
    assert bool(valid.any())
    for refine in ("apriltag", "subpix", "none"):
        _assert_detect_matches_plain(frames, quads, valid, areas, codes,
                                     params._replace(corner_refine=refine), n_bits=7)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["q_161", "one_valid_slot", "flat_slot"])
def test_detect_warp_design_edges_match_plain(cuda, case):
    """The warp design's edges at every refine kind: 3 frames of Q = 161
    slots (``max_candidates=15``; 483 slots, an odd grid), a batch with one
    valid slot, and a valid slot over a flat patch of a frame (every sample
    in one bin, the span clamped to 1e-6, Otsu's first argmax, the contrast
    gate failed)."""
    from vican_torch.ops import detect as D

    params = D.resolve_error_correction(D.DetectorParams(), "DICT_4X4_1000")
    frames = rendered_640(cuda, 2, 7)[0]
    if case == "q_161":
        frames = frames[:3].contiguous()
        params = params._replace(max_candidates=15)
    quads, valid, areas, codes = _detect_inputs(cuda, frames, params)
    if case == "q_161":
        assert tuple(valid.shape) == (3, 161)
    elif case == "one_valid_slot":
        first = int(valid.reshape(-1).nonzero()[0, 0])
        valid = torch.zeros_like(valid)
        valid.view(-1)[first] = True
    else:
        frames = frames.clone()
        frames[0, 20:100, 20:100] = 128
        j = int(valid[0].nonzero()[0, 0])
        quads[0, j] = torch.tensor([[30.0, 30.0], [90.0, 30.0], [90.0, 90.0], [30.0, 90.0]],
                                   device=cuda)
    for refine in ("apriltag", "subpix", "none"):
        p = params._replace(corner_refine=refine)
        gaps, out = _assert_detect_matches_plain(frames, quads, valid, areas, codes, p)
        if case == "one_valid_slot":
            assert gaps["kept"] <= 1
        elif case == "flat_slot":  # and the flat slot alone: not kept
            alone = torch.zeros_like(valid)
            alone[0, j] = True
            gaps, _ = _assert_detect_matches_plain(frames, quads, alone, areas, codes, p)
            assert gaps["kept"] == 0

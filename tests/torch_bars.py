"""The bars the card tests (tests/test_torch_gpu.py) hold the hand kernels
to, and the seeded inputs and scenes they share with tools/kernel_times.py.
Imports neither JAX nor the JAX package: the card machine has PyTorch
alone."""
import numpy as np
import torch

# The solver's filter at two cells of the large-graph route: B, 10k cameras
# (n = 30000 rows, the single read with its largest clusters), and C, 2048
# cameras; both over 10k timesteps, 100 edges a timestep at B.
CELLS = {"B": dict(n_cams=10_000, n_times=10_000, n_edges=1_000_000),
         "C": dict(n_cams=2048, n_times=10_000, n_edges=240_000)}
# pwr_apply against its plain version: the kernel sums Z = B^T X in float32
# in another order than cuBLAS, which can flip the bf16 rounding of single
# entries of W = Lambda Z.  One flip moves every Y entry it touches by
# 2^-8 |W_q| |B_qi|; with ~300 nonzeros a column of cell B's operator that
# is ~6e-5 of max |Y| (1.2e-4 measured at w = 10 on an H100).  1e-3 admits
# a dozen flips on one entry; an indexing or masking fault shows at O(1).
PWR_REL_TOL = 1e-3
# thin_mv: the same exact bf16 products summed in another float32 order
# (benchmarks/mv_kernel_probe.py's own bar)
MV_REL_TOL = 1e-5
PROBE_SHAPE = (30208, 31744, 128)  # M, K, w of benchmarks/mv_kernel_probe.py:73

# PnP against its plain version (float64): the LM stops anywhere in the
# float64 basin of its minimum (where the cost no longer tells two poses
# apart), so two float64 implementations of it land up to ~7e-8 apart in a
# pose entry on the few ill-conditioned slots (small, far markers); the
# plain version batched against itself slot by slot differs by 3.5e-8 on
# the CPU.  The bar on every slot is 15x that; the median gap must stay at
# rounding level.
PNP_TOL = 1e-6             # R entries, t (m), reprojection error (px)
PNP_MEDIAN_TOL = 1e-10     # median R-entry and t gaps
PNP_MARKER = 0.138         # tests/test_torch_pnp.py's scene
PNP_DIST = np.array([-0.25, 0.08, 1.5e-3, -1.2e-3, -0.012, -0.02, 0.004, -0.001,
                     0.0, 0.0, 0.0, 0.0, 0.0, 0.0])

# Detect against its plain version: ids, valid and scores identical on
# every output slot; the corners of the kept slots within DETECT_TOL px
# (they differ by the sum order of the fits, ~1e-12 px); every slot's
# within the card-vs-CPU bar, since cornerSubPix on a rejected candidate's
# ill-conditioned window moves its corners ~1e-6 px under a sum order
# (9.8e-7 px seen in a host-C++ build of the kernel).
DETECT_TOL = 1e-6
DETECT_ALL_TOL = 1e-3

# The cube scenes' detection settings (examples/tutorial.py's)
CUBE_KW = dict(aruco="DICT_4X4_1000", marker_size=0.138, corner_refine="CORNER_REFINE_APRILTAG",
               flags="SOLVEPNP_IPPE_SQUARE", verbose=False)
# P: the JAX package's perception-bench recipe (vican_tpu/synthetic.py:273-323,
# seed 4), two cameras with tests/test_perception.py:132's distortion
P_MARKER = 0.48 * 0.575
P_DIST = np.array([-0.25, 0.08, 1.5e-3, -1.2e-3, -0.012, -0.02, 0.004, -0.001, 0, 0, 0, 0])
P_KW = dict(CUBE_KW, marker_size=P_MARKER, batch_size=32)


def filter_problem(dev, cfg: dict):
    """``(Bt, lbd, n, T)`` built like the large-graph route's at ``cfg``'s
    size: random 3x3 rotation blocks on the config's edges in a (3C, 3T)
    operator, every camera and timestep touched; Lambda_T the
    degree-normalized initial time dual plus a random non-symmetric part,
    so a transposed Lambda would show."""
    from vican_torch.ops.lie import quat_to_mat
    from vican_torch.solver.core import block_matrix
    from vican_torch.solver.pwr import filter_operator

    C, T, E = cfg["n_cams"], cfg["n_times"], cfg["n_edges"]
    g = torch.Generator(device=dev).manual_seed(0)
    cam = torch.randint(0, C, (E,), generator=g, device=dev)
    tim = torch.randint(0, T, (E,), generator=g, device=dev)
    cam[:C] = torch.arange(C, device=dev)
    tim[-T:] = torch.arange(T, device=dev)
    blocks = quat_to_mat(torch.randn((E, 4), generator=g, device=dev))
    Bt = filter_operator(block_matrix(blocks, cam, tim, C, T))
    deg_t = torch.zeros(T, device=dev).index_add_(0, tim, torch.ones(E, device=dev))
    lbd = torch.eye(3, device=dev) / deg_t[:, None, None]
    lbd = lbd + 0.1 * torch.rand((T, 3, 3), generator=g, device=dev) * lbd[:, :1, :1]
    return Bt, lbd, 3 * C, T


def thin_mv_cases(dev, cases=("probe", "streaming w=10", "streaming w=1", "ragged")):
    """``thin_mv``'s operands at full size, one case at a time: ``(case, B,
    X)``.  The probe's cos operands (benchmarks/mv_kernel_probe.py:72-81);
    the streaming regime's symmetric 30000^2 bf16 operator (3C at 10k
    cameras) at w = 10 and 1; a ragged 29999 x 30001 (M, K not multiples
    of 8)."""
    from vican_torch.solver.mv import aligned_bf16

    g = torch.Generator(device=dev).manual_seed(3)
    if "probe" in cases:
        M, K, w = PROBE_SHAPE
        fi = lambda k: torch.arange(k, dtype=torch.float32, device=dev)  # noqa: E731
        B = torch.cos(fi(M)[:, None] * 1e-3 + fi(K)[None, :] * 1e-5).to(torch.bfloat16)
        X = torch.cos(fi(K)[:, None] + fi(w)[None, :]).to(torch.bfloat16)
        yield "probe", B, X
        del B, X
    n = 3 * CELLS["B"]["n_cams"]
    if any(c.startswith("streaming") for c in cases):
        R = torch.randn((n, n), generator=g, device=dev)
        B = aligned_bf16(torch.add(R, R.T, out=torch.empty_like(R)))
        del R
        for w in (10, 1):
            X, _ = torch.linalg.qr(torch.randn((n, w), generator=g, device=dev))
            if f"streaming w={w}" in cases:
                yield f"streaming w={w}", B, X
        del B
    if "ragged" in cases:
        B = aligned_bf16(torch.randn((n - 1, n + 1), generator=g, device=dev))
        yield "ragged", B, torch.randn((n + 1, 10), generator=g, device=dev)


def pnp_slots(B: int, D: int, seed: int, distorted: bool, dev):
    """``B`` cameras (640x360, f = 420) x ``D`` slots of 0.138 m markers
    0.6-3 m away, tilted up to 60 degrees, their corners projected and
    jittered by 0.2 px (tests/test_torch_pnp.py's scene, with and without
    its distortion); a third of the slots not valid, all-zero quads in a
    tenth, half of those still valid.  The PnP block's inputs on ``dev``."""
    from vican_torch.ops.lie import rodrigues
    from vican_torch.ops.pnp import marker_object_points, project_points

    rng = np.random.default_rng(seed)
    n = B * D
    K = np.array([[420.0, 0, 320], [0, 420.0, 180], [0, 0, 1]])
    Ks = np.repeat(K[None], B, 0)
    dists = np.repeat((PNP_DIST if distorted else np.zeros(14))[None], B, 0)
    axis = rng.normal(size=(n, 3))
    axis *= rng.uniform(0.0, np.pi / 3, (n, 1)) / np.linalg.norm(axis, axis=1, keepdims=True)
    flip = torch.diag(torch.tensor([1.0, -1.0, -1.0], dtype=torch.float64))
    R = rodrigues(torch.tensor(axis)) @ flip  # marker +z toward the camera
    z = rng.uniform(0.6, 3.0, n)
    t = np.stack([rng.uniform(-0.25, 0.25, n) * z, rng.uniform(-0.15, 0.15, n) * z, z], 1)
    im = np.arange(n) // D
    px = project_points(marker_object_points(PNP_MARKER), R, torch.tensor(t),
                        torch.tensor(Ks[im]), torch.tensor(dists[im])).numpy()
    px = px + rng.normal(scale=0.2, size=px.shape)
    valid = rng.random(n) > 1 / 3
    zero = rng.random(n) < 0.1
    px[zero] = 0.0
    valid[zero & (rng.random(n) < 0.5)] = False
    ids = rng.integers(0, 1000, n)
    return [torch.tensor(a).to(dev) for a in (px, ids, valid, Ks, dists)]


def pnp_gaps(out, ref) -> dict:
    """Kernel-vs-plain gaps of two packed ``(N, 23)`` buffers: the largest
    and median pose-entry, translation and error gaps over the slots the
    plain version calls ok, and whether ok, corners and ids are identical
    and the slots not ok zero past their id where the plain version's are."""
    out, ref = out.cpu().numpy(), ref.cpu().numpy()
    ok = ref[:, 9] > 0.5
    dR = np.abs(out[ok, 10:19] - ref[ok, 10:19]).max(1)
    dt = np.abs(out[ok, 19:22] - ref[ok, 19:22]).max(1)
    de = np.abs(out[ok, 22] - ref[ok, 22])
    zero_ref = (ref[:, 9:] == 0).all(1)
    return dict(slots=len(ref), ok=int(ok.sum()),
                same_ok=bool(np.array_equal(out[:, 9], ref[:, 9])),
                same_head=bool(np.array_equal(out[:, :9], ref[:, :9])),
                same_zeros=bool((out[zero_ref, 9:] == 0).all()),
                R=float(dR.max()), t=float(dt.max()), err=float(de.max()),
                R_median=float(np.median(dR)), t_median=float(np.median(dt)))


def detect_gaps(out, ref) -> dict:
    """Kernel against plain on one batch's Detections: valid, ids and
    scores identical on every slot, the kept slots' corner gap and every
    slot's."""
    kept = ref.valid
    gap = (out.corners - ref.corners).abs()
    return dict(same_valid=bool((out.valid == ref.valid).all()),
                same_ids=bool((out.ids == ref.ids).all()),
                same_score=bool((out.score == ref.score).all()), kept=int(kept.sum()),
                corners=float(gap[kept].max()) if bool(kept.any()) else 0.0,
                corners_all=float(gap.max()) if gap.numel() else 0.0)


def detect_ok(gaps: dict) -> bool:
    """:func:`detect_gaps` within the bars."""
    return (gaps["same_valid"] and gaps["same_ids"] and gaps["same_score"]
            and gaps["corners"] <= DETECT_TOL and gaps["corners_all"] <= DETECT_ALL_TOL)


def rendered_640(dev, timesteps: int, seed: int, pad: int = 0, aruco: str = "DICT_4X4_1000"):
    """The cube of ``aruco`` markers seen by three cameras at 640x360
    (``pad`` replicated columns more), rendered on ``dev``: ``(frames,
    names, frame_cams)``."""
    import torch.nn.functional as F

    from vican_torch import render
    from vican_torch.cam import Camera

    K = np.array([[420.0, 0, 320], [0, 420.0, 180], [0, 0, 1]])
    cams = {str(i): Camera(id=str(i), intrinsics=K, distortion=np.zeros(12),
                           extrinsics=render.look_at(pos, (0, 0, 1.0)),
                           resolution_x=640, resolution_y=360)
            for i, pos in enumerate([(2.4, 0, 1.2), (0, 2.4, 1.4), (-2.4, 0.5, 1.0)])}
    frames, names, frame_cams = render.render_frames(
        cams, render.cube_trajectory(timesteps, seed=seed), render.make_cube_markers(aruco),
        aruco, marker_size=0.138, device=dev)
    frames = F.pad(frames.float(), (0, pad), mode="replicate").to(torch.uint8).contiguous()
    return frames, names, frame_cams


def p_frames(dev):
    """P's first 32 frames (8 cameras at 1280x720 around a cube of 24
    markers, two of them distorted: the room cells' batch), rendered on
    ``dev``: ``(frames, names, frame_cams)``."""
    from vican_torch import render
    from vican_torch.cam import Camera

    W, H, f = 1280, 720, 0.55 * (1280 + 720)
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]])
    cams = {}
    for k in range(8):
        az, r = 2 * np.pi * k / 8, 2.2 + 0.4 * k / 7
        pos = (r * np.cos(az), r * np.sin(az), 1.0 + 0.3 * (-1) ** k)
        cams[str(k)] = Camera(id=str(k), intrinsics=K,
                              distortion=P_DIST.copy() if k in (1, 5) else np.zeros(12),
                              extrinsics=render.look_at(pos, (0.0, 0.0, 1.0)),
                              resolution_x=W, resolution_y=H)
    return render.render_frames(
        cams, render.cube_trajectory(4, seed=4, wander=True), render.make_cube_markers(),
        marker_size=P_MARKER, device=dev)


def p_first_batch(dev):
    """:func:`p_frames` and the arguments of the detect program and of the
    PnP block as ``estimate_pose_gray`` hands them over, copied:
    ``(frames, detect_args, pnp_args)``.  The wrappers are swapped for
    spies for the one call; the real wrappers' ``launches`` do not move."""
    from vican_torch.ops import detect, pnp
    from vican_torch.perception import estimate_pose_gray

    frames, names, frame_cams = p_frames(dev)
    seen, real = {}, {}
    for module, name in ((detect, "detect_candidates"), (pnp, "pnp_block")):
        def spy(*args, name=name):
            seen.setdefault(name, [a.clone() if isinstance(a, torch.Tensor) else a for a in args])
            return real[name](*args)

        real[name], spy.launches = getattr(module, name), 0  # the wrappers count on it
        setattr(module, name, spy)
    try:
        estimate_pose_gray(frames.cpu().numpy(), names, frame_cams, **P_KW)
    finally:
        detect.detect_candidates, pnp.pnp_block = real["detect_candidates"], real["pnp_block"]
    return frames, seen["detect_candidates"], seen["pnp_block"]

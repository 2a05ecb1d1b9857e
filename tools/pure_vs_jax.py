"""The JAX package's ``pure`` and ``device`` modes on the frames that
``python3 chip_smoke.py --pure --save frames.npz`` saved (the first 64
frames of the smoke's perception scene and the port's edges on them in
both modes, from the card), against the port's edges.

    JAX_PLATFORMS=cpu python tools/pure_vs_jax.py frames.npz

Runs on a host with both packages (the JAX one on the CPU, about 10
minutes for the 64 1280x720 frames, the pure mode one frame at a time) and
prints, for each pair of edge sets, the keys only one of them has and the
largest corner gap over the keys both have.  The JAX package's own pure
vs device line gives ``chip_smoke.py``'s ``JAX_PURE_ONLY``,
``JAX_DEVICE_ONLY`` and ``JAX_PURE_VS_DEVICE_PX``.
"""
import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _edges(keys, corners):
    return {tuple(k.split("|")): np.asarray(c, np.float64) for k, c in zip(keys, corners)}


def _compare(name, a, b):
    common = [k for k in a if k in b]
    gap = max(float(np.abs(a[k] - b[k]).max()) for k in common)
    print(f"{name}: only first {sorted(set(a) - set(b))}, only second "
          f"{sorted(set(b) - set(a))}, largest corner gap {gap!r} px over {len(common)} keys")


def main(path):
    import cv2
    import jax

    jax.config.update("jax_enable_x64", True)
    import chip_smoke as cs
    from vican_tpu.cam import Camera, estimate_pose_mp

    d = np.load(path)
    W, H = cs.SCENE_RES
    f = 0.55 * (W + H)
    K = np.array([[f, 0, W / 2.0], [0, f, H / 2.0], [0, 0, 1.0]])
    root = tempfile.mkdtemp()
    files, cams = [], []
    for img, name, cid in zip(d["frames"], d["names"], d["cams"]):
        fn = os.path.join(root, str(name).replace(".jpg", ".png"))  # lossless: the same pixels
        os.makedirs(os.path.dirname(fn), exist_ok=True)
        cv2.imwrite(fn, img)
        files.append(fn)
        dist = cs.SCENE_DIST if str(cid) in cs.SCENE_DISTORTED else np.zeros(12)
        cams.append(Camera(id=str(cid), intrinsics=K, distortion=dist.copy(), extrinsics=None,
                           resolution_x=W, resolution_y=H))
    kw = dict(aruco="DICT_4X4_1000", marker_size=cs.SCENE_MARKER,
              corner_refine="CORNER_REFINE_APRILTAG", flags="SOLVEPNP_IPPE_SQUARE",
              brightness=0, contrast=0, verbose=False, marker_ids=None)
    jax_edges = {}
    for mode, batch in (("device", 8), ("pure", 1)):
        out = estimate_pose_mp(files, cams, pipeline_mode=mode, batch_size=batch, **kw)
        jax_edges[mode] = {k: np.asarray(v["corners"], np.float64) for k, v in out.items()}
    port = {m: _edges(d[f"{m}_keys"], d[f"{m}_corners"]) for m in ("device", "pure")}
    _compare("port device vs JAX device", port["device"], jax_edges["device"])
    _compare("port pure vs JAX pure", port["pure"], jax_edges["pure"])
    _compare("JAX device vs JAX pure", jax_edges["device"], jax_edges["pure"])
    _compare("port device vs port pure", port["device"], port["pure"])


if __name__ == "__main__":
    main(sys.argv[1])

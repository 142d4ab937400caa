"""
Rerun-based 3D visualization helpers (a copy of uniception_tpu/utils/viz.py).

Parity with reference uniception/utils/viz.py:13-99 (script-level Rerun
argument helpers + point-cloud logging used by the DUSt3R example). Rerun
is optional; all entry points degrade gracefully when it's absent. The
pointmaps and images may be numpy arrays or tensors on any device (the
port's outputs): they are read back to the host first.
"""

import numpy as np

__all__ = ["rerun_available", "script_add_args", "script_setup", "log_pointmaps_to_rerun"]


def _np(a) -> np.ndarray:
    "A host numpy array of ``a`` (a tensor on any device is detached and copied back)."
    if hasattr(a, "detach"):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a)


def rerun_available() -> bool:
    try:
        import rerun  # noqa: F401

        return True
    except ImportError:
        return False


def script_add_args(parser):
    "Add Rerun connection args to an argparse parser (reference viz.py:13-36)."
    parser.add_argument("--headless", action="store_true", help="do not spawn a viewer")
    parser.add_argument("--connect", action="store_true", help="connect to a running viewer")
    parser.add_argument("--url", type=str, default=None, help="viewer url")
    parser.add_argument("--save", type=str, default=None, help="save an .rrd recording")
    return parser


def script_setup(args, application_id: str):
    "Initialize Rerun per the script args (reference viz.py:39-72)."
    if not rerun_available():
        print("rerun is not installed; skipping visualization setup")
        return None
    import rerun as rr

    rr.init(application_id)
    if getattr(args, "save", None):
        rr.save(args.save)
    elif getattr(args, "connect", False):
        rr.connect_grpc(getattr(args, "url", None) or None)
    elif not getattr(args, "headless", False):
        rr.spawn()
    return rr


def log_pointmaps_to_rerun(model_name: str, res1: dict, res2: dict, imgs_bchw, conf_threshold: float = 3.0):
    "Log confidence-filtered two-view pointmaps (reference dust3r example :237-261)."
    if not rerun_available():
        print("rerun is not installed; skipping point-cloud logging")
        return
    import rerun as rr

    rr.log(f"{model_name}", rr.ViewCoordinates.RDF, static=True)
    pts1 = _np(res1["pts3d"][0])
    pts2 = _np(res2["pts3d_in_other_view"][0])
    mask1 = _np(res1["conf"][0])[..., 0] > conf_threshold
    mask2 = _np(res2["conf"][0])[..., 0] > conf_threshold
    colors = np.transpose(_np(imgs_bchw), (0, 2, 3, 1))
    colors = (colors - colors.min()) / max(colors.max() - colors.min(), 1e-6)
    rr.log(f"{model_name}/view1",
           rr.Points3D(positions=pts1[mask1].reshape(-1, 3), colors=colors[0][mask1].reshape(-1, 3)))
    rr.log(f"{model_name}/view2",
           rr.Points3D(positions=pts2[mask2].reshape(-1, 3), colors=colors[1][mask2].reshape(-1, 3)))

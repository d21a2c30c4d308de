"""One-command video driver: extract -> fit -> render -> assemble (port of
``smpltpu/pipeline/video.py``), on the card through the port's CLIs:

    python -m smpltpu_torch.pipeline.video <SMPL.npz> <input> <out_dir>
        [--mode multi|single|stream] [--size WxH] [--images DIR] [--fps N]
        [--no-video] [--mesh N] [--multi-start] [--freeze-scale]
        [--fused-stages]
        [--adaptive-start] [--adaptive-thresh PX] [--adaptive-propagate]
        [--no-orient-init]
        [--frame-chunk N] [--use-gmm] [--pose-prior FILE] [--jax-render]
        [--iters N] [--s2-iters N] [--beta-pose X] [--beta-shape X]
        [--lambda-t X] [--calib N]

``input`` may be:
  * a video file            -> MediaPipe extraction (needs cv2+mediapipe),
  * a directory of images   -> MediaPipe extraction per frame,
  * a directory of keypoint .json files -> consumed directly; frames come
    from --images, or blank frames of --size are synthesized so the
    fitting/rendering contract (image count == json count) holds without
    real footage.

Fitting and rendering go through the port's CLIs (pipeline.single,
pipeline.multi, pipeline.stream) with ``main(args, device=device)``;
assembly goes through data/scripts/create_video. A stage whose optional
tool (cv2, mediapipe) is absent reports what it skipped, as the
reference's driver does; no stage of the fit or the render is skipped.
From Python, ``main(argv, device="cpu")`` runs it on the CPU.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from smpltpu_torch.io.keypoints import list_sorted
from smpltpu_torch.utils.image import imwrite

USAGE = __doc__.split("\n\n")[1] + "\n"
SCRIPTS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data", "scripts")


def _scripts_on_path() -> None:
    """data/scripts (the reference's tools, not the JAX package) on
    sys.path, as the reference's driver loads them."""
    if SCRIPTS_DIR not in sys.path:
        sys.path.insert(0, SCRIPTS_DIR)


def _parse(argv):
    """The JAX driver's parser, option for option."""
    if len(argv) < 3:
        return None
    opts = {
        "smpl_path": argv[0], "input": argv[1], "out_dir": argv[2],
        "mode": "multi", "size": None, "images": None, "fps": 10.0,
        "no_video": False, "mesh": None, "multi_start": False,
        "freeze_scale": False, "use_gmm": False, "pose_prior": None,
        "jax_render": False, "iters": None, "s2_iters": None,
        "beta_pose": None, "beta_shape": None, "lambda_t": None,
        "calib": None, "adaptive_start": False, "adaptive_thresh": None,
        "adaptive_propagate": False, "fused_stages": False,
        "no_orient_init": False, "frame_chunk": None,
    }
    rest = list(argv[3:])
    flags = {"--no-video": "no_video", "--multi-start": "multi_start",
             "--freeze-scale": "freeze_scale", "--use-gmm": "use_gmm",
             "--jax-render": "jax_render",
             "--adaptive-start": "adaptive_start",
             "--adaptive-propagate": "adaptive_propagate",
             "--fused-stages": "fused_stages",
             "--no-orient-init": "no_orient_init"}
    valued = {"--mode": ("mode", str), "--size": ("size", str),
              "--images": ("images", str), "--fps": ("fps", float),
              "--mesh": ("mesh", int), "--pose-prior": ("pose_prior", str),
              "--iters": ("iters", int), "--s2-iters": ("s2_iters", int),
              "--beta-pose": ("beta_pose", float),
              "--beta-shape": ("beta_shape", float),
              "--lambda-t": ("lambda_t", float),
              "--adaptive-thresh": ("adaptive_thresh", float),
              "--frame-chunk": ("frame_chunk", int),  # --mode single
              "--calib": ("calib", int)}  # --mode stream only
    while rest:
        a = rest.pop(0)
        if a in flags:
            opts[flags[a]] = True
        elif a in valued and rest:
            key, typ = valued[a]
            opts[key] = typ(rest.pop(0))
        else:
            print(f"[WARN] Unknown arg ignored: {a}", file=sys.stderr)
    return opts


def _extract_from_video(video_path: str, out_dir: str):
    """MediaPipe extraction through data/scripts (the parity tool).
    Returns (kps_dir, img_dir); raises when cv2 or mediapipe is absent."""
    _scripts_on_path()
    import extract_keypoints_mediapipe as ext
    base = os.path.join(out_dir, "extract")
    ext.process_video(video_path, base=base)
    name = os.path.basename(video_path)
    return (os.path.join(base, "keypoints", name),
            os.path.join(base, "frames_annotated", name))


def _extract_from_images(img_dir: str, out_dir: str):
    """Per-image MediaPipe extraction into out_dir/extract_kps."""
    try:
        import cv2
        from mediapipe.python.solutions import pose as mp_pose
    except ImportError as e:
        raise RuntimeError(
            f"image-folder extraction needs cv2 + mediapipe ({e})")
    import json

    kp_dir = os.path.join(out_dir, "extract_kps")
    os.makedirs(kp_dir, exist_ok=True)
    pose = mp_pose.Pose(static_image_mode=True, model_complexity=1,
                        min_detection_confidence=0.5)
    for p in list_sorted(img_dir, [".png", ".jpg", ".jpeg"]):
        img = cv2.imread(p)
        res = pose.process(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
        lms = []
        if res.pose_landmarks:
            lms = [{"x": lm.x, "y": lm.y, "z": lm.z,
                    "visibility": lm.visibility}
                   for lm in res.pose_landmarks.landmark]
        stem = os.path.splitext(os.path.basename(p))[0]
        with open(os.path.join(kp_dir, stem + ".json"), "w") as f:
            json.dump(lms, f)
    return kp_dir, img_dir


def _blank_frames(kps_dir: str, out_dir: str, size):
    """Black frames named as the keypoint JSONs, so that the CLI's
    image-count contract holds without real footage."""
    w, h = size
    img_dir = os.path.join(out_dir, "_frames")
    os.makedirs(img_dir, exist_ok=True)
    blank = np.zeros((h, w, 3), np.uint8)
    for p in list_sorted(kps_dir, [".json"]):
        stem = os.path.splitext(os.path.basename(p))[0]
        imwrite(os.path.join(img_dir, stem + ".png"), blank)
    return img_dir


def _positional(values, defaults):
    """The CLIs consume numerics positionally, in order, so a later knob
    needs every earlier slot: the skipped ones get that parser's own
    defaults (the prefix is then a no-op)."""
    last = max((i for i, v in enumerate(values) if v is not None),
               default=-1)
    return [str(values[i] if values[i] is not None else defaults[i])
            for i in range(last + 1)]


def _cli_args(opts, kps_dir, img_dir, fit_out):
    """(the CLI module, its argv) for ``opts["mode"]``, with the per-mode
    warnings for the options that mode ignores."""
    args = [opts["smpl_path"], kps_dir, img_dir, fit_out]
    if opts["mode"] == "single":
        from smpltpu_torch.pipeline import single as cli
        args += _positional(
            [opts["iters"], opts["beta_pose"], opts["beta_shape"]],
            [100, 20.0, 30.0])
        for key, flag, where in (("lambda_t", "--lambda-t", "multi"),
                                 ("s2_iters", "--s2-iters", "multi"),
                                 ("calib", "--calib", "stream")):
            if opts[key] is not None:
                print(f"[WARN] {flag} applies to --mode {where} only; "
                      "ignored", file=sys.stderr)
        for flag, key in (("--multi-start", "multi_start"),
                          ("--freeze-scale", "freeze_scale"),
                          ("--use-gmm", "use_gmm"),
                          ("--jax-render", "jax_render"),
                          ("--adaptive-start", "adaptive_start"),
                          ("--adaptive-propagate", "adaptive_propagate"),
                          ("--no-orient-init", "no_orient_init")):
            if opts[key]:
                args.append(flag)
        if opts["fused_stages"]:
            print("[WARN] --fused-stages applies to --mode multi only; "
                  "ignored", file=sys.stderr)
        if opts["adaptive_thresh"] is not None:
            args += ["--adaptive-thresh", str(opts["adaptive_thresh"])]
        if opts["frame_chunk"] is not None:
            args += ["--frame-chunk", str(opts["frame_chunk"])]
        if opts["mesh"] is not None:
            args += ["--mesh", str(opts["mesh"])]
        if opts["pose_prior"]:
            args += ["--pose-prior", opts["pose_prior"]]
    elif opts["mode"] == "stream":
        from smpltpu_torch.pipeline import stream as cli
        args += _positional(
            [opts["iters"], opts["beta_pose"], opts["lambda_t"]],
            [20, 5.0, 3.0])
        args.append("--render")
        if opts["calib"] is not None:
            args += ["--calib", str(opts["calib"])]
        for key, flag in (("s2_iters", "--s2-iters"),
                          ("beta_shape", "--beta-shape"),
                          ("mesh", "--mesh"),
                          ("multi_start", "--multi-start"),
                          ("adaptive_start", "--adaptive-start"),
                          ("adaptive_thresh", "--adaptive-thresh"),
                          ("adaptive_propagate", "--adaptive-propagate"),
                          ("fused_stages", "--fused-stages"),
                          ("no_orient_init", "--no-orient-init"),
                          ("frame_chunk", "--frame-chunk")):
            if opts[key]:
                print(f"[WARN] {flag} does not apply to --mode stream; "
                      "ignored (shape comes from the calibration buffer; "
                      "the stream is causal and single-chip)",
                      file=sys.stderr)
        if opts["jax_render"]:
            args.append("--jax-render")
        if opts["use_gmm"]:
            args.append("--use-gmm")
        if opts["pose_prior"]:
            args += ["--pose-prior", opts["pose_prior"]]
    else:
        from smpltpu_torch.pipeline import multi as cli
        # multi positionals: s1-iters, s2-anchor-iters, skip, wsize,
        # overlap, beta_pose, beta_shape, lambda_t; --iters caps both
        # solver stages, the windows' iterations stay on --s2-iters
        args += _positional(
            [opts["iters"], opts["iters"], None, None, None,
             opts["beta_pose"], opts["beta_shape"], opts["lambda_t"]],
            [1000, 500, 10, 20, 5, 5.0, 25.0, 3.0])
        # the driver's defaults: batched windows, anchor warm starts and
        # the data-driven per-frame init
        args += ["--batched-windows", "--init-from-anchors", "--data-init"]
        if opts["s2_iters"] is not None:
            args += ["--s2-iters", str(opts["s2_iters"])]
        if opts["calib"] is not None:
            print("[WARN] --calib applies to --mode stream only; ignored",
                  file=sys.stderr)
        if opts["multi_start"]:
            args.append("--multi-start")
        if opts["fused_stages"]:
            args.append("--fused-stages")
        for key, flag in (("use_gmm", "--use-gmm"),
                          ("freeze_scale", "--freeze-scale"),
                          ("adaptive_start", "--adaptive-start"),
                          ("adaptive_propagate", "--adaptive-propagate")):
            if opts[key]:
                print(f"[WARN] {flag} applies to --mode single only; "
                      "ignored (multi freezes scale and skips the GMM "
                      "by reference parity)", file=sys.stderr)
        if opts["adaptive_thresh"] is not None:
            print("[WARN] --adaptive-thresh applies to --mode single only;"
                  " ignored", file=sys.stderr)
        if opts["frame_chunk"] is not None:
            print("[WARN] --frame-chunk applies to --mode single only; "
                  "use --s2-iters/--window-chunk pacing for multi; ignored",
                  file=sys.stderr)
        if opts["no_orient_init"]:
            args.append("--no-orient-init")
        if opts["mesh"] is not None:
            args += ["--mesh", str(opts["mesh"])]
        if opts["jax_render"]:
            args.append("--jax-render")
        if opts["pose_prior"]:
            args += ["--pose-prior", opts["pose_prior"]]
    return cli, args


def main(argv=None, *, device="cuda") -> int:
    argv = sys.argv[1:] if argv is None else argv
    opts = _parse(argv)
    if opts is None:
        print(USAGE, end="")
        return 0
    os.makedirs(opts["out_dir"], exist_ok=True)

    # ---- stage 1: resolve the input into (kps_dir, img_dir) ----
    inp = opts["input"]
    if os.path.isfile(inp):
        print(f"[INFO] extracting keypoints from video {inp}")
        try:
            kps_dir, img_dir = _extract_from_video(inp, opts["out_dir"])
        except Exception as e:
            print(f"[ERROR] extraction failed: {e}", file=sys.stderr)
            return 1
    elif os.path.isdir(inp):
        if list_sorted(inp, [".json"]):
            kps_dir = inp
            img_dir = opts["images"]
            if img_dir is None:
                size = (720, 1280)
                if opts["size"]:
                    w, h = opts["size"].lower().split("x")
                    size = (int(w), int(h))
                print(f"[INFO] no --images given; synthesizing blank "
                      f"{size[0]}x{size[1]} frames")
                img_dir = _blank_frames(kps_dir, opts["out_dir"], size)
        else:
            print(f"[INFO] extracting keypoints from image folder {inp}")
            try:
                kps_dir, img_dir = _extract_from_images(inp, opts["out_dir"])
            except Exception as e:
                print(f"[ERROR] extraction failed: {e}", file=sys.stderr)
                return 1
    else:
        print(f"input not found: {inp}", file=sys.stderr)
        return 1

    # ---- stage 2: fit + render through the port's CLIs ----
    fit_out = os.path.join(opts["out_dir"], "fit")
    cli, args = _cli_args(opts, kps_dir, img_dir, fit_out)
    print(f"[INFO] fitting ({opts['mode']}) -> {fit_out}")
    rc = cli.main(args, device=device)
    if rc != 0:
        return rc

    # ---- stage 3: assemble the annotated mp4 ----
    if not opts["no_video"]:
        try:
            _scripts_on_path()
            import create_video
            mp4 = os.path.join(opts["out_dir"], "annotated.mp4")
            rc_v = create_video.main([fit_out, mp4, str(opts["fps"])])
        except Exception as e:
            print(f"[WARN] video assembly skipped: {e}", file=sys.stderr)
            rc_v = 1
        if rc_v == 0:
            print(f"[INFO] wrote {mp4}")
        else:
            print("[WARN] video assembly skipped (no cv2 or no frames)",
                  file=sys.stderr)
    print("done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())

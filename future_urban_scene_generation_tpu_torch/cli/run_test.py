"""CLI entry point: run_test.py-compatible flags plus the headless selection mode.

Counterpart of the JAX package's cli/run_test.py (:23-155). The reference needs a
PyQt5 GUI to pick vehicles (run_test.py:156-161); here ``--select-ids`` and
``--frame-id`` run the same request headlessly through ``pipeline.service``.

  python -m future_urban_scene_generation_tpu_torch.cli.run_test \\
      <video_dir> <kpoints_dir> <checkpoints_dir> \\
      [--det_mode ssd512] [--track_mode tc] [--bbox_scale 1.0] [--scale_calib] \\
      [--device cuda] --select-ids 3 7 --frame-id 120

``--device`` defaults to ``cuda``; a missing GPU is an error, never a silent move to
the CPU. ``--web-gui`` serves the browser GUI on ``--host``/``--port`` and ``--gui``
opens the Qt window (exit 2 without PyQt5). The flags of parts that are not ported
yet (``--inpaint``, ``--segmenter maskrcnn``, ``--aot-dir``) parse and exit 2 with a
line that names where the part waits in ROADMAP.md.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("video_dir", type=Path)
    p.add_argument("kpoints_dir", type=Path)
    p.add_argument("checkpoints_dir", type=Path)
    p.add_argument("--scale_calib", action="store_true")
    p.add_argument("--demo", action="store_true")
    p.add_argument("--det_mode", type=str, default="ssd512",
                   help='"yolo3", "ssd512" or "mask_rcnn"')
    p.add_argument("--track_mode", type=str, default="tc",
                   help='"deepsort", "tc" or "moana"')
    p.add_argument("--bbox_scale", type=float, default=1.0)
    p.add_argument("--video_fps", type=int, default=10)
    p.add_argument("--inpaint", action="store_true")
    p.add_argument("--inpaint_model", type=int, choices=[1, 2, 3, 4], default=4)
    p.add_argument("--reference-channel-order", action="store_true",
                   help="reproduce the reference's BGR/channel-reversal "
                        "conventions when running its trained checkpoints "
                        "(PARITY.md #6)")
    p.add_argument("--segmenter", choices=["background", "maskrcnn"],
                   default="background", help="inpaint-branch vehicle segmenter")
    p.add_argument("--reso", type=int, default=256)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--blocks", type=int, default=1)
    p.add_argument("--stacks", type=int, default=2)
    p.add_argument("--device", default="cuda")
    # Headless selection (replaces the mandatory GUI).
    p.add_argument("--select-ids", type=int, nargs="+", default=None,
                   help="vehicle track ids to synthesize (headless mode)")
    p.add_argument("--frame-id", type=int, default=1)
    p.add_argument("--output-dir", type=Path, default=Path("./results"))
    p.add_argument("--gui", action="store_true", help="the Qt GUI (needs PyQt5)")
    p.add_argument("--web-gui", action="store_true",
                   help="the browser GUI (standard-library HTTP server)")
    p.add_argument("--host", default="127.0.0.1", help="bind address for --web-gui")
    p.add_argument("--port", type=int, default=8000, help="port for --web-gui")
    p.add_argument("--frame-hw", type=int, nargs=2, default=None, metavar=("H", "W"),
                   help="working resolution (default 720 1280; 'native' via -1 -1)")
    p.add_argument("--vis-res", type=int, default=192,
                   help="plane-visibility local raster resolution (scale-free; "
                        "area ratios are affine-invariant)")
    p.add_argument("--vis-scale", type=float, default=None,
                   help="DEPRECATED and ignored: visibility rasters in a "
                        "scale-free local window (--vis-res)")
    p.add_argument("--aot-dir", type=Path, default=None,
                   help="ahead-of-time scene programs (not ported)")
    return p


def _not_ported(args):
    """(flag, ROADMAP place) of the first requested part that is not ported."""
    for wanted, flag, where in (
        (args.inpaint, "--inpaint", "queue 1, S7 (inpaint branch)"),
        (args.segmenter == "maskrcnn", "--segmenter maskrcnn", "queue 1, S7 (inpaint branch)"),
        (args.aot_dir is not None, "--aot-dir", "queue 1, S10 (AOT)"),
    ):
        if wanted:
            return flag, where
    return None


def main(argv=None):
    args = build_parser().parse_args(argv)

    refused = _not_ported(args)
    if refused is not None:
        print(f"{refused[0]} is not ported to PyTorch yet: ROADMAP.md {refused[1]}.",
              file=sys.stderr)
        return 2

    from future_urban_scene_generation_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig(
        video_dir=args.video_dir,
        kpoints_dir=args.kpoints_dir,
        checkpoints_dir=args.checkpoints_dir,
        scale_calib=args.scale_calib,
        det_mode=args.det_mode,
        track_mode=args.track_mode,
        bbox_scale=args.bbox_scale,
        video_fps=args.video_fps,
        inpaint_model=args.inpaint_model,
        reference_channel_order=args.reference_channel_order,
        reso=args.reso,
        batch=args.batch,
        blocks=args.blocks,
        stacks=args.stacks,
        device=args.device,
        select_ids=args.select_ids or [],
        frame_id=args.frame_id,
        output_dir=args.output_dir,
    )
    if args.frame_hw is not None:
        cfg.runtime.frame_hw = None if args.frame_hw[0] < 0 else tuple(args.frame_hw)
    cfg.runtime.vis_res = args.vis_res
    if args.vis_scale is not None:
        print("--vis-scale is deprecated and ignored (see --vis-res)", file=sys.stderr)

    if args.web_gui:
        from future_urban_scene_generation_tpu_torch.gui.web import launch_web_gui

        return launch_web_gui(cfg, host=args.host, port=args.port)

    if args.gui:
        try:
            # launch_gui imports PyQt5 in its body, so the call sits inside the guard.
            from future_urban_scene_generation_tpu_torch.gui.app import launch_gui

            return launch_gui(cfg)
        except ImportError as exc:
            print(f"GUI unavailable ({exc}); use --select-ids for headless mode.",
                  file=sys.stderr)
            return 2

    if not cfg.select_ids:
        print("No --select-ids given (headless mode requires explicit vehicle ids).",
              file=sys.stderr)
        return 2

    from future_urban_scene_generation_tpu_torch.pipeline.service import SceneService

    service = SceneService(cfg)
    try:
        out_paths = service.run_request(cfg.frame_id, cfg.select_ids)
    finally:
        service.close()
    for path in out_paths:
        print(path)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

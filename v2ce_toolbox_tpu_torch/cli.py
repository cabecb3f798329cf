"""V2CE CLI — video to DVS event stream, PyTorch/CUDA port.

Same flag surface as the JAX package's `v2ce.py`, plus --device and
--seed:

    python -m v2ce_toolbox_tpu_torch.cli -i input.mp4 -t center

Writes an event-frame preview mp4 and a `<name>-events.npz` structured
event stream. Flags whose paths are not ported yet (--streaming, --bf16,
-t pano, a strategy other than slope, pooling) raise NotImplementedError.
"""

from __future__ import annotations

import argparse
import logging
import os


def SBool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--fps", type=int, default=30, help="FPS of the output video")
    p.add_argument("--seq_len", type=int, default=16, help="Sequence length")
    p.add_argument("--ceil", type=int, default=10, help="The ceiling of the ef value")
    p.add_argument("-u", "--upper_bound_percentile", type=int, default=98,
                   help="Percentile of nonzero ef values bounding visualization")
    p.add_argument("-f", "--image_folder", type=str,
                   help="Folder containing .png frames to infer")
    p.add_argument("-i", "--input_video_path", type=str,
                   help="Path to the input video")
    p.add_argument("-o", "--out_folder", type=str, default="./output",
                   help="Folder for outputs")
    p.add_argument("-t", "--infer_type", type=str, default="center",
                   choices=["center", "pano"], help="Inference mode")
    p.add_argument("-m", "--model_path", type=str, default="./weights/v2ce_3d.pt",
                   help="Stage-1 reference torch state_dict; seeded random "
                        "weights when the file does not exist")
    p.add_argument("--out_name_suffix", type=str, default="")
    p.add_argument("--max_frame_num", type=int, default=1800)
    p.add_argument("--width", type=int, default=346)
    p.add_argument("--height", type=int, default=260)
    p.add_argument("--write_event_frame_video", type=SBool, default=True,
                   nargs="?", const=True)
    p.add_argument("--vis_keep_polarity", type=SBool, default=True,
                   nargs="?", const=True)
    p.add_argument("-l", "--log_level", type=str, default="info")
    p.add_argument("-b", "--batch_size", type=int, default=1)
    p.add_argument("--stage2_batch_size", type=int, default=24)
    p.add_argument("--streaming", type=SBool, default=False, nargs="?", const=True,
                   help="not ported yet")
    p.add_argument("--bf16", type=SBool, default=False, nargs="?", const=True,
                   help="not ported yet")
    p.add_argument("--stage2_strategy", type=str, default="slope",
                   choices=["slope", "random", "none"],
                   help="LDATI additional-events strategy (only slope is ported)")
    p.add_argument("--stage2_pooling", type=str, default="none",
                   choices=["none", "avg", "weighted"],
                   help="spatial pooling before the slope fit (only none is ported)")
    p.add_argument("--stage2_sort_cap", type=int, default=1 << 14,
                   help="pre-sort per-(frame,bin) row compaction width; 0 "
                        "disables. Overflow is counted in `dropped` exactly")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device for the model and the sampler")
    p.add_argument("--seed", type=int, default=0,
                   help="seed of the random weights (no checkpoint) and the draws")
    return p


def main(argv=None):
    parser = build_parser()
    args = parser.parse_args(argv)
    logging.basicConfig(level=getattr(logging, args.log_level.upper()))

    if (args.image_folder is None) == (args.input_video_path is None):
        parser.error("give exactly one of -f/--image_folder and -i/--input_video_path")
    for path in (args.image_folder, args.input_video_path):
        if path is not None and not os.path.exists(path):
            parser.error(f"{path} does not exist")
    if args.streaming:
        raise NotImplementedError("--streaming is not ported yet (ROADMAP item 7)")
    if args.bf16:
        raise NotImplementedError("--bf16 is not ported yet (ROADMAP item 8)")

    from v2ce_toolbox_tpu_torch.config import PipelineConfig, SamplerConfig
    from v2ce_toolbox_tpu_torch.pipeline.driver import V2cePipeline

    config = PipelineConfig(
        infer_type=args.infer_type,
        seq_len=args.seq_len,
        height=args.height,
        width=args.width,
        batch_size=args.batch_size,
        fps=args.fps,
        max_frame_num=args.max_frame_num,
        ceil=args.ceil,
        upper_bound_percentile=args.upper_bound_percentile,
        vis_keep_polarity=args.vis_keep_polarity,
        stage2_batch_size=args.stage2_batch_size,
        write_event_frame_video=args.write_event_frame_video,
        sampler=SamplerConfig(
            fps=args.fps,
            additional_events_strategy=args.stage2_strategy,
            pooling_type=args.stage2_pooling,
            sort_cap=args.stage2_sort_cap or None,
        ),
    )
    pipeline = V2cePipeline(config, model_path=args.model_path,
                            device=args.device, seed=args.seed)
    result = pipeline.run(
        input_video_path=args.input_video_path,
        image_folder=args.image_folder,
        out_folder=args.out_folder,
        out_name_suffix=args.out_name_suffix,
    )
    print(result)
    return result


if __name__ == "__main__":
    main()

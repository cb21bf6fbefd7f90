"""CLI parity with the reference sample (ref: sample/resize_yuv420p.cpp).

Usage (same flags as the reference):

    python -m libiqo_tpu.cli.resize_yuv420p \
        -m lanczos3 -i in.yuv -iw 640 -ih 480 -o out.yuv -ow 320 -oh 240

Reads a raw planar YUV420 file, resizes Y at full size and U/V at half size
(Lanczos chroma with px_scale=2), writes a raw file.
"""

from __future__ import annotations

import argparse
import itertools
import sys

from ..yuv import YUV420Resizer, iter_yuv420, write_yuv420


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="resize_yuv420p",
        description="Resize raw planar YUV420 images (libiqo_tpu)")
    ap.add_argument("-m", default="area",
                    help="method: linear | area | lanczos[1-9] (default area)")
    ap.add_argument("-i", required=True, help="input .yuv path")
    ap.add_argument("-iw", type=int, required=True, help="input width")
    ap.add_argument("-ih", type=int, required=True, help="input height")
    ap.add_argument("-o", required=True, help="output .yuv path")
    ap.add_argument("-ow", type=int, required=True, help="output width")
    ap.add_argument("-oh", type=int, required=True, help="output height")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "xla", "numpy"])
    ap.add_argument("--frames", type=int, default=None,
                    help="max frames to process (default: all)")
    args = ap.parse_args(argv)

    try:
        r = YUV420Resizer(args.m, args.iw, args.ih, args.ow, args.oh,
                          backend=args.backend)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    # stream frame-at-a-time: constant memory for arbitrarily long files
    # (matches the reference sample's one-frame read loop,
    # ref: sample/resize_yuv420p.cpp:94-112).  Validate the input before
    # touching the output path so a bad -i never truncates an existing -o.
    try:
        frames_in = iter_yuv420(args.i, args.iw, args.ih, args.frames)
        first = next(frames_in, None)
    except OSError as e:
        print(f"error: could not read {args.i}: {e}", file=sys.stderr)
        return 1
    if first is None:
        print("error: no complete frames in input", file=sys.stderr)
        return 1

    count = 0

    def resized():
        nonlocal count
        for f in itertools.chain([first], frames_in):
            yield r.resize(f)
            count += 1

    try:
        write_yuv420(args.o, resized())
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    n = count
    print(f"{n} frame(s): {args.iw}x{args.ih} -> {args.ow}x{args.oh} "
          f"({args.m}, backend={r._luma.resolved_backend()})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

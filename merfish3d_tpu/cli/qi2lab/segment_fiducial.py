"""qi2lab-segment: cell segmentation of the fused fiducial image.

Mirrors `cli/qi2lab_microscopes/segment_fiducial.py:24-270`. Cellpose-SAM
(torch) is an external step in this build; pass ``--mask-path`` with an
externally produced label mask, or omit it for the classical fallback
segmentation.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="qi2lab-segment")
    p.add_argument("--datastore-path", required=True, type=Path)
    p.add_argument("--mask-path", type=Path, default=None,
                   help="external label mask (.npy), e.g. from Cellpose")
    p.add_argument("--method", choices=("watershed", "threshold", "flow"),
                   default="watershed",
                   help="fallback segmentation when no --mask-path: "
                   "distance-transform watershed, plain threshold+CC, or "
                   "the native flow-field model (models/cellpose.py)")
    p.add_argument("--model-path", type=Path, default=None,
                   help="pickled CPNet variables for --method flow "
                   "(omitted: trains on synthetic renders first)")
    p.add_argument("--downsampling", type=float, nargs=3, default=(1.0, 1.0, 1.0))
    args = p.parse_args(argv)
    from ...utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    from ...datastore import qi2labDataStore
    from ...pipeline.segmentation import segment_fiducial

    ds = qi2labDataStore(args.datastore_path, validate=False)
    segment_fiducial(
        ds,
        mask_path=args.mask_path,
        method=args.method,
        model_path=args.model_path,
        downsampling=tuple(args.downsampling),
    )


if __name__ == "__main__":
    main()
